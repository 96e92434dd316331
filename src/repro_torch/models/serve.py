"""Serving steps: prefill (cache build) + batched decode.

The port of ``repro/models/serve.py``.  ``make_prefill_step`` is a full
forward pass that keeps the last position's logits; ``make_decode_step``
is ONE new token against a KV cache, the memory-bound regime.
``cache_specs`` says where the cache lives on a mesh (spec tuples, as
``repro_torch.models.sharding``).

With ``mesh=`` (an ``LmMesh``, ``repro_torch.launch.mesh``) both steps
are the reference's partitioned steps made explicit, as its dry run
places them: the parameters are this rank's shards of the reference's
layout under ``param_specs(zero=cfg.serve_zero)`` (``shard_params``;
each ZeRO leaf all-gathered over the batch axes inside the step), the
decode cache this rank's block under ``cache_specs`` (``shard_cache``),
and the batch the global one, of which the step takes this rank's rows
(all of them where it does not split over the batch axes).  The logits
are the rows' whole vocab.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models import train as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import map_leaves


def make_decode_step(cfg: ModelConfig, mesh=None, max_len=None):
    """(params, tokens [B,1], pos, cache) -> (logits, cache).  On a mesh,
    ``max_len`` is the whole cache's length (see ``model.decode_step``)."""
    specs = None if mesh is None else param_specs_of(cfg, mesh)

    def decode_step(params, tokens, pos, cache):
        run = None
        if mesh is not None:
            run = mesh.for_batch(tokens.shape[0])
            params = _whole_params(params, specs, cfg, mesh)
            tokens = T.batch_rows({"tokens": tokens}, run)["tokens"]
        return M.decode_step(params, tokens, pos, cache, cfg, run, max_len)

    return decode_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """(params, batch) -> last-position logits [B,1,V]."""
    specs = None if mesh is None else param_specs_of(cfg, mesh)

    def prefill_step(params, batch):
        run = None
        if mesh is not None:
            run = mesh.for_batch(next(iter(batch.values())).shape[0])
            params = _whole_params(params, specs, cfg, mesh)
            batch = T.batch_rows(batch, run)
        x, _ = M.backbone(params, batch, cfg, run)
        return M.head_logits(params, x, cfg, run, last=True)

    return prefill_step


def param_specs_of(cfg: ModelConfig, mesh):
    """The spec tree a mesh places the serving parameters by: the
    reference layout's ``param_specs`` with ``zero=cfg.serve_zero``."""
    return SH.param_specs(M.params_to_reference(M.abstract_params(cfg), cfg),
                          mesh, zero=cfg.serve_zero)


def shard_params(params, cfg: ModelConfig, mesh):
    """This rank's shards of whole parameters (the model's per-layer
    layout or the reference's) in the reference's layout, as the mesh
    steps take them."""
    if "layers" in params:
        params = M.params_to_reference(params, cfg)
    return SH.shard_tree(params, param_specs_of(cfg, mesh), mesh)


def _whole_params(params, specs, cfg, mesh):
    """The model's per-layer parameters from this rank's reference-layout
    shards, the ZeRO dims gathered (``train.gather_zero``)."""
    return T.model_params(T.gather_zero(params, specs, mesh), cfg)


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


def shard_cache(cache, cfg: ModelConfig, mesh):
    """This rank's block of a whole decode cache under ``cache_specs``;
    ``sharding.gather_tree(block, cache_specs(whole, cfg, mesh), mesh)``
    brings it back."""
    return SH.shard_tree(cache, cache_specs(cache, cfg, mesh), mesh)


def _placement(mesh):
    """(the batch axes' names, their spec entry, their total size, the
    model axis's size) of ``mesh``."""
    sizes = dict(mesh.shape)
    batch_names = tuple(n for n in ("pod", "data") if n in sizes)
    bsz = math.prod(sizes[n] for n in batch_names)
    batch_spec = batch_names if len(batch_names) > 1 else \
        (batch_names[0] if batch_names else None)
    return batch_names, batch_spec, bsz, sizes.get("model", 1)


def _reference_leaf(shape, mesh):
    """The reference's rule for one cache leaf (``cache_specs`` in
    ``repro/models/serve.py``)."""
    batch_names, batch_spec, bsz, model_n = _placement(mesh)
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


def reference_cache_specs(cache_shape, cfg: ModelConfig, mesh):
    """The reference's spec tree for the decode cache, its rule copied:
    KV tensors [repeats?, B, S, KV, hd] put the batch over (pod, data),
    heads over model when divisible, else the sequence (the long_500k
    cells and kv=1 archs); SSM states put their last divisible feature
    dim over model.  The dry run prices the spec tables' per-device bytes
    by it (``launch.dryrun.production_memory``); it is not where the
    mixers' model-axis split keeps their states (``cache_specs``)."""
    return map_leaves(lambda _, x: _reference_leaf(tuple(x.shape), mesh),
                      cache_shape)


# the batch dim of each SSM state, from the end: mamba conv [*, B, K-1, di]
# and ssm [*, B, di, N], mLSTM C [*, B, H, dh, dh] and n [*, B, H, dh],
# sLSTM's four [*, B, di]
_STATE_BATCH = {("mamba", "conv"): -3, ("mamba", "ssm"): -3,
                ("mlstm", "C"): -4, ("mlstm", "n"): -3}


def _state_spec(mixer, name, shape, cfg, mesh):
    """Where the mixer's model-axis split keeps one SSM state: the batch
    over (pod, data) where it divides; mamba's by channel (``conv`` and
    ``ssm``'s di), sLSTM's by channel, mLSTM's by head where the heads
    divide the model axis, else (a head on each group of ``n / H``
    ranks) ``C`` split along its value dim inside the head's group and
    ``n`` whole on each of its ranks (``sharding.Spec``'s ``within``);
    nothing over model where the mixer's ``"ff"`` dims do not split."""
    batch_names, batch_spec, bsz, n = _placement(mesh)
    spec = [None] * len(shape)
    b = _STATE_BATCH.get((mixer, name), -2)
    if batch_names and shape[b] % bsz == 0:
        spec[b] = batch_spec
    di = cfg.ssm_expand * cfg.d_model
    if n == 1 or SH.resolve(("ff",), (di,), mesh) == (None,):
        return tuple(spec)
    if mixer == "mamba":
        spec[-1 if name == "conv" else -2] = "model"
    elif mixer == "slstm":
        spec[-1] = "model"
    elif cfg.num_heads % n == 0:
        spec[-3 if name == "C" else -2] = "model"
    else:
        within = (-3 if name == "C" else -2, cfg.num_heads, ("model",))
        if name == "C":
            spec[-1] = "model"
        return SH.Spec(spec, within=within)
    return tuple(spec)


def cache_specs(cache_shape, cfg: ModelConfig, mesh):
    """Spec tree for the decode cache (leaves with ``.shape``: the tensors
    of ``model.abstract_cache``), as the model's mesh paths read it.

    KV tensors follow the reference's rule (``reference_cache_specs``):
    [repeats?, B, S, KV, hd], the batch over (pod, data), heads over model
    when divisible, else the sequence (sequence parallelism -- the
    long_500k cells and kv=1 archs land here).  SSM states sit where the
    mixers' split keeps them (``_state_spec``): by channel or head over
    model, the batch over (pod, data).
    """
    mixers = {f"slot{i:02d}": m for i, (m, _) in enumerate(cfg.layer_pattern)}
    mixers.update({f"tail{i:02d}": m
                   for i, (m, _) in enumerate(cfg.tail_pattern)})

    def leaf(path, x):
        mixer = mixers[path[0]]
        if mixer in ("attn", "local"):
            return _reference_leaf(tuple(x.shape), mesh)
        return _state_spec(mixer, path[-1], tuple(x.shape), cfg, mesh)

    return map_leaves(leaf, cache_shape)
