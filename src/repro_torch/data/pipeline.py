"""Deterministic, step-indexed synthetic data pipeline.

The port of ``repro/data/pipeline.py``.  Design constraints:
  * **Step-indexed**: ``batch_at(step)`` is a pure function of (seed, step),
    so restart-after-failure resumes the exact token stream with no data
    state in the checkpoint, and an elastic re-mesh skips no data.
  * **Learnable**: tokens follow a hidden low-rank bigram model with zipf
    unigram marginals, so cross-entropy has real headroom below log(V) and
    training shows a falling loss curve.
  * **On the device**: each batch is drawn from a ``torch.Generator`` on
    the pipeline's device seeded by (seed, step): the Gumbel noise of
    every position in one draw, then one gather, product and argmax per
    position (``jax.random.categorical``'s Gumbel-max, as the reference
    samples).

The reference's generator is threefry, which the port does not carry, so
the tokens are not the reference's; they keep its properties (determinism
per (seed, step), range, bigram structure).  The pipeline runs on CUDA
unless the caller passes ``device="cpu"``; the same seed gives other
tokens on another device type.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.frontends import synth_frames, synth_patches

F32 = torch.float32


def _seed(*keys: int) -> int:
    """A 63-bit generator seed that depends on every key (the reference's
    ``fold_in``)."""
    state = np.random.SeedSequence([int(k) for k in keys])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _generator(device, *keys):
    return torch.Generator(device=device).manual_seed(_seed(*keys))


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device, dtype=F32)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(F32).tiny)))


@dataclasses.dataclass
class SyntheticLM:
    """Hidden-bigram token stream: P(t+1|t) ∝ softmax(E[t] @ D / tau)."""

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    rank: int = 32
    tau: float = 0.5
    active_vocab: int = 4096  # bigram structure lives in the head of the zipf
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.v_eff = min(self.vocab_size, self.active_vocab)
        gen = _generator(self.device, self.seed)
        # low-rank bigram logits over the effective vocab
        self._E = torch.randn((self.v_eff, self.rank), generator=gen,
                              device=self.device, dtype=F32)
        self._D = torch.randn((self.rank, self.v_eff), generator=gen,
                              device=self.device, dtype=F32)
        # zipf prior for the first token
        probs = 1.0 / np.arange(1, self.v_eff + 1)
        self._logp0 = torch.as_tensor(np.log(probs / probs.sum()), dtype=F32,
                                      device=self.device)

    def batch_at(self, step: int) -> dict:
        gen = _generator(self.device, self.seed ^ 0x5EED, step)
        noise = _gumbel((self.seq_len, self.batch, self.v_eff), gen,
                        self.device)
        tok = torch.argmax(self._logp0 + noise[0], dim=-1)
        toks = [tok]
        for i in range(1, self.seq_len):
            logits = (self._E[tok] @ self._D) / self.tau
            tok = torch.argmax(logits + noise[i], dim=-1)
            toks.append(tok)
        tokens = torch.stack(toks, dim=1).to(torch.int32)
        return {"tokens": tokens, "labels": tokens}


def _labels(cfg, B, S, device, *keys):
    return torch.randint(0, cfg.vocab_size, (B, S),
                         generator=_generator(device, *keys), device=device,
                         dtype=torch.int32)


def batch_for_shape(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
                    batch_override: int | None = None, device=None) -> dict:
    """Materialize one real batch for (cfg, shape) -- smoke tests/examples."""
    device = resolve_device(device)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    if cfg.frontend == "audio":
        return {"frames": synth_frames(cfg, B, S, seed=step, device=device),
                "labels": _labels(cfg, B, S, device, 7, step)}
    if cfg.frontend == "vision":
        text_len = S - cfg.frontend_len
        pipe = SyntheticLM(cfg.vocab_size, B, text_len, seed=11,
                           device=device)
        return {"tokens": pipe.batch_at(step)["tokens"],
                "patches": synth_patches(cfg, B, seed=step, device=device),
                "labels": _labels(cfg, B, S, device, 13, step)}
    pipe = SyntheticLM(cfg.vocab_size, B, S, seed=17, device=device)
    return pipe.batch_at(step)


class _FrontendPipe:
    """``batch_at`` for an architecture with a modality frontend."""

    def __init__(self, cfg, batch, seq_len, device):
        self.cfg, self.device = cfg, device
        self.shape = ShapeConfig("custom", seq_len, batch, "train")

    def batch_at(self, step):
        return batch_for_shape(self.cfg, self.shape, step,
                               batch_override=self.shape.global_batch,
                               device=self.device)


def make_pipeline(cfg: ModelConfig, batch: int, seq_len: int, seed: int = 0,
                  device=None):
    """Training pipeline for the end-to-end drivers."""
    device = resolve_device(device)
    if cfg.frontend:
        return _FrontendPipe(cfg, batch, seq_len, device)
    return SyntheticLM(cfg.vocab_size, batch, seq_len, seed=seed,
                       device=device)
