"""Serving steps: prefill (cache build) + batched decode.

The port of ``repro/models/serve.py``.  ``make_prefill_step`` is a full
forward pass that keeps the last position's logits; ``make_decode_step``
is ONE new token against a KV cache, the memory-bound regime.  The
reference's ``cache_specs`` places the cache on a mesh; on one device
there is nothing to place, so it has no twin.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig


def make_decode_step(cfg: ModelConfig):
    """(params, tokens [B,1], pos, cache) -> (logits, cache)."""

    def decode_step(params, tokens, pos, cache):
        return M.decode_step(params, tokens, pos, cache, cfg)

    return decode_step


def make_prefill_step(cfg: ModelConfig):
    """(params, batch) -> last-position logits [B,1,V]."""

    def prefill_step(params, batch):
        logits, _ = M.forward(params, batch, cfg)
        return logits[:, -1:]

    return prefill_step


def sample_greedy(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]


def sample_temperature(generator, logits, temperature=1.0):
    """One token per row from ``softmax(logits / temperature)``, drawn from
    ``generator`` (a ``torch.Generator`` on the logits' device)."""
    probs = torch.softmax(logits[:, -1].float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator).to(torch.int32)


# ---------------------------------------------------------------------------
# Prefill that also builds the decode cache (serve example path)
# ---------------------------------------------------------------------------


def prefill_with_cache(params, batch, cfg: ModelConfig, max_len: int):
    """Runs the prompt through the model once, returning (last_logits,
    cache) where the cache is positioned at ``pos = prompt_len`` for
    ``decode_step``: one decode step per prompt token, as the reference
    scans them -- simple and correct for every mixer family."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    cache = M.init_cache(cfg, B, max_len, device=tokens.device)
    logits = None
    for i in range(S):
        logits, cache = M.decode_step(params, tokens[:, i:i + 1], i, cache,
                                      cfg)
    return logits, cache


def generate(params, batch, cfg: ModelConfig, steps: int, max_len: int,
             temperature: float = 0.0, generator=None):
    """Greedy/temperature generation loop returning [B, steps] new tokens
    (the token sampled from the prompt's last logits feeds the first step
    and is not among them, as in the reference)."""
    prompt_len = batch["tokens"].shape[1]
    last_logits, cache = prefill_with_cache(params, batch, cfg, max_len)
    tok = sample_greedy(last_logits)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=last_logits.device).manual_seed(0)
    out = []
    for i in range(steps):
        logits, cache = M.decode_step(params, tok, prompt_len + i, cache, cfg)
        tok = (sample_temperature(generator, logits, temperature)
               if temperature > 0 else sample_greedy(logits))
        out.append(tok[:, 0])
    return torch.stack(out, dim=1)  # [B, steps]
