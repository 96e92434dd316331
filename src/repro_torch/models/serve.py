"""Serving steps: prefill (cache build) + batched decode.

The port of ``repro/models/serve.py``.  ``make_prefill_step`` is a full
forward pass that keeps the last position's logits; ``make_decode_step``
is ONE new token against a KV cache, the memory-bound regime.
``cache_specs`` says where the cache would live on a mesh (spec tuples,
as ``repro_torch.models.sharding``); on one device nothing is placed.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import map_leaves


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


# ---------------------------------------------------------------------------
# Cache sharding specs
# ---------------------------------------------------------------------------


def cache_specs(cache_shape, cfg: ModelConfig, mesh):
    """Spec tree for the decode cache (leaves with ``.shape``: the tensors
    of ``model.abstract_cache``).

    KV tensors are [repeats?, B, S, KV, hd]: batch over (pod,data), heads
    over model when divisible, else seq over model (sequence parallelism --
    the long_500k cells and kv=1 archs land here).  SSM states shard their
    feature axis over model.
    """
    sizes = dict(mesh.shape)
    batch_names = tuple(n for n in ("pod", "data") if n in sizes)
    model_n = sizes.get("model", 1)
    bsz = math.prod(sizes[n] for n in batch_names)
    batch_spec = batch_names if len(batch_names) > 1 else \
        (batch_names[0] if batch_names else None)

    def leaf(_, x):
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 4:  # KV cache [*, B, S, KV, hd] or [B, S, KV, hd]
            off = nd - 4
            if batch_names and shape[off] % bsz == 0:
                spec[off] = batch_spec
            if model_n > 1 and shape[off + 2] % model_n == 0:
                spec[off + 2] = "model"      # heads TP
            elif model_n > 1 and shape[off + 1] % model_n == 0:
                spec[off + 1] = "model"      # seq SP fallback (kv=1 archs)
        elif nd >= 2:  # SSM states [*, B, di, N] / [*, B, di]
            off = 1 if nd == 2 else nd - 3
            if batch_names and shape[off] % bsz == 0:
                spec[off] = batch_spec
            for i in range(nd - 1, off, -1):
                if model_n > 1 and shape[i] % model_n == 0:
                    spec[i] = "model"
                    break
        return tuple(spec)

    return map_leaves(leaf, cache_shape)
