"""Learning-rate schedules (step tensor -> f32 lr tensor).

The port of ``repro/optim/schedule.py``, in f32 as the reference computes
them; each schedule takes the optimizer's int32 step count (a 0-d tensor)
and returns a 0-d f32 tensor on its device.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def _f32(x, like):
    return torch.as_tensor(x, dtype=F32, device=like.device)


def constant_schedule(lr: float):
    return lambda step: _f32(lr, torch.as_tensor(step))


def _warm(step, peak_lr, warmup):
    # (step+1)/warmup: the first step trains at peak/warmup, not at 0
    return peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup then cosine decay to ``floor_frac * peak``."""

    def fn(step):
        step = torch.as_tensor(step).to(F32)
        warm = _warm(step, peak_lr, warmup)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, peak_lr * cos)

    return fn


def wsd_schedule(peak_lr: float, warmup: int, total: int,
                 decay_frac: float = 0.1, floor_frac: float = 0.0):
    """Warmup-Stable-Decay: linear warmup, flat, linear cooldown over the
    final ``decay_frac`` of training (modern LLM default)."""
    decay_start = int(total * (1 - decay_frac))

    def fn(step):
        step = torch.as_tensor(step).to(F32)
        warm = _warm(step, peak_lr, warmup)
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                        0.0, 1.0)
        decay = peak_lr * (1 - (1 - floor_frac) * t)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start,
                                       _f32(peak_lr, step), decay))

    return fn
