"""Modality frontend stubs: ``[audio]``/``[vlm]`` cells feed the transformer
BACKBONE only; the modality frontend supplies precomputed frame/patch
embeddings.

The port of ``repro/models/frontends.py``.  ``vision_spec``/``audio_spec``
are tensors on the ``meta`` device (shape and dtype, no storage), the
port's ``ShapeDtypeStruct``.  The ``synth_*`` helpers draw deterministic
stand-in embeddings from an explicit ``torch.Generator`` seeded with
``seed``: the same seed gives the same tensors, though not the bits
``jax.random`` gives the reference.  They draw on CUDA unless the caller
passes ``device="cpu"``.
"""

from __future__ import annotations

import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.layers import PDT


def vision_spec(cfg, batch: int):
    """PaLiGemma-style SigLIP patch embeddings: [B, F, d_model] bf16, with
    F = cfg.frontend_len, already projected to d_model."""
    return torch.empty((batch, cfg.frontend_len, cfg.d_model), dtype=PDT,
                       device="meta")


def audio_spec(cfg, batch: int, seq_len: int):
    """HuBERT-style conv-feature-extractor output: [B, S, d_model] bf16; S
    counts frames, the backbone's sequence length."""
    return torch.empty((batch, seq_len, cfg.d_model), dtype=PDT,
                       device="meta")


def _generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed))


def synth_patches(cfg, batch: int, seed: int = 0, device=None):
    """Deterministic stand-in SigLIP embeddings (unit-scale gaussian)."""
    device = resolve_device(device)
    x = torch.randn((batch, cfg.frontend_len, cfg.d_model),
                    generator=_generator(seed, device), device=device)
    return x.to(PDT)


def synth_frames(cfg, batch: int, seq_len: int, seed: int = 0,
                 device=None):
    """Deterministic stand-in conv-extractor frames."""
    device = resolve_device(device)
    x = torch.randn((batch, seq_len, cfg.d_model),
                    generator=_generator(seed, device), device=device)
    return x.to(PDT)


def make_batch(cfg, batch: int, seq_len: int, seed: int = 0,
               train: bool = True, device=None):
    """Synthesize one full input batch matching the model's input contract
    (tokens and labels from a generator seeded with ``seed + 1``, as the
    reference keys them)."""
    device = resolve_device(device)
    gen = _generator(seed + 1, device)

    def ints(shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=device, dtype=torch.int32)

    if cfg.frontend == "audio":
        out = {"frames": synth_frames(cfg, batch, seq_len, seed, device)}
        if train:
            out["labels"] = ints((batch, seq_len))
        return out
    if cfg.frontend == "vision":
        text_len = seq_len - cfg.frontend_len
        assert text_len > 0, \
            f"seq_len {seq_len} <= frontend_len {cfg.frontend_len}"
        out = {"tokens": ints((batch, text_len)),
               "patches": synth_patches(cfg, batch, seed, device)}
        if train:
            out["labels"] = ints((batch, seq_len))
        return out
    out = {"tokens": ints((batch, seq_len))}
    if train:
        out["labels"] = ints((batch, seq_len))
    return out
