"""Model assembly: block pattern -> layer stack, forward/prefill/decode.

The port of ``repro/models/model.py``, every block family: ``attn``/
``local`` (``layers``), ``mamba``/``mlstm``/``slstm`` (``ssm``) mixers and
``dense``/``moe``/``none`` MLPs (``moe``).  The reference stacks
each pattern slot's parameters over ``cfg.repeats`` and runs the slot as one
``lax.scan``; the port keeps one parameter dict per layer and runs the
stack as a Python loop over repeats x pattern, then the tail:

    params = {"embed": {"table"}, "final_norm": {"scale"},
              ["lm_head": {"table"}],
              "layers": [block dict, ...]}   # execution order

``params_from_reference`` / ``params_to_reference`` move a parameter tree
between the two layouts (the reference's ``slots``/``tail`` leaves are
unstacked over ``repeats``).  The decode cache keeps the reference's
layout (``slotNN`` leaves stacked over repeats, ``[repeats, B, W, KV, hd]``
for attention and ``[repeats, ...]`` of each SSM state; ``tailNN`` leaves
unstacked), so ``configs.input_specs`` matches it leaf by leaf;
``decode_step`` writes each layer's slice in place.

Input contract (see ``configs.input_specs``):
    text:   {"tokens": i32[B,S]}                (+ "labels" for train)
    vlm:    {"tokens": i32[B,S-F], "patches": bf16[B,F,d]}   F=frontend_len
    audio:  {"frames": bf16[B,S,d]}             (stub conv frontend)

Placement constraints (the reference's ``sharding.constrain``) are dropped:
the port places tensors explicitly.  ``backbone`` / ``forward`` take
``mesh=`` (an ``LmMesh``, ``repro_torch.launch.mesh``): the parameters are
then this rank's model-axis shards (the spec tables' ``"model"`` dims; the
batch-axis ZeRO dims gathered by the caller) and the batch this rank's
rows; every block runs tensor-, expert- or sequence-parallel over the
model axis (``layers``, ``moe``, ``ssm``), and the batch axes serve every
family.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.engine import resolve_device
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig

F32 = torch.float32


def layer_blocks(cfg: ModelConfig):
    """``(slot key, repeat or None, block)`` per layer, in execution order:
    repeats x pattern (``slotNN``), then the tail (``tailNN``)."""
    out = [(f"slot{i:02d}", r, block) for r in range(cfg.repeats)
           for i, block in enumerate(cfg.layer_pattern)]
    out += [(f"tail{i:02d}", None, block)
            for i, block in enumerate(cfg.tail_pattern)]
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


_MIXER_INIT = {"attn": L.init_attention, "local": L.init_attention,
               "mamba": SSM.init_mamba, "mlstm": SSM.init_mlstm,
               "slstm": SSM.init_slstm}


def _init_block(cfg, block, generator, device):
    mixer, mlp = block
    p = {"norm1": L.init_rmsnorm(cfg.d_model, device),
         "attn" if mixer == "local" else mixer:
             _MIXER_INIT[mixer](cfg, generator, device)}
    if mlp == "dense":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, device)
        p["mlp"] = L.init_mlp(cfg.d_model, cfg.d_ff, generator, device)
    elif mlp == "moe":
        p["norm2"] = L.init_rmsnorm(cfg.d_model, device)
        p["moe"] = MOE.init_moe(cfg, generator, device)
    return p


def init_params(cfg: ModelConfig, generator=None, device=None):
    """Random parameters drawn from ``generator`` (a ``torch.Generator`` on
    ``device``; seed 0 if None), on CUDA unless ``device`` names another.
    The reference's scales: N(0,1) embeddings, fan-in-scaled projections,
    unit norms, zero QKV biases, the SSM mixers' f32 gates and constants
    (mamba's ``b_dt``, ``a_log``, ``d_skip``), an f32 MoE router."""
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    params = {"embed": L.init_embedding(cfg.vocab_size, cfg.d_model,
                                        generator, device),
              "final_norm": L.init_rmsnorm(cfg.d_model, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"table": L._normal(
            (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, generator,
            device)}
    params["layers"] = [_init_block(cfg, block, generator, device)
                        for _, _, block in layer_blocks(cfg)]
    return params


def abstract_params(cfg: ModelConfig):
    """Parameters on the ``meta`` device: shapes and dtypes, no storage
    (the reference's ``jax.eval_shape`` twin)."""
    return init_params(cfg, device="meta")


def _tensor(leaf):
    """A reference leaf (numpy; bf16 as an ``ml_dtypes`` array or its uint16
    view) or a tensor, as a tensor with the same bits."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.array(leaf)  # a C-ordered copy that keeps a 0-d leaf 0-d
    if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree, cfg: ModelConfig, device=None):
    """The port's parameters from the reference's parameter tree (numpy
    leaves, bf16 through a uint16 view, or tensors): ``slots`` leaves
    unstacked over ``repeats``, ``tail``, ``embed``, ``final_norm`` and
    ``lm_head`` mapped as they are.  Bit-exact.  Tensors already on
    ``device`` are not copied: each layer's leaf is a view of its stacked
    leaf (one ``unbind`` a leaf), so autograd carries a layer's gradient
    back into the stacked leaf (``repro_torch.models.train``)."""
    device = resolve_device(device)
    move = lambda leaf: _tensor(leaf).to(device)
    out = {k: _map(move, tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    slots = {key: _map(lambda a: move(a).unbind(0), slot)
             for key, slot in tree["slots"].items()}
    out["layers"] = [
        _map(lambda a, r=r: a[r], slots[key])
        if r is not None else _map(move, tree["tail"][key])
        for key, r, _ in layer_blocks(cfg)]
    return out


def params_to_reference(params, cfg: ModelConfig):
    """The inverse of ``params_from_reference``: the reference's layout
    (``slots`` stacked over ``repeats``, ``tail``), tensors on the
    parameters' device (``meta`` tensors give the reference's shapes).  A
    slot of one repeat is a view of its layer's leaf, not a copy."""
    out = {k: params[k] for k in ("embed", "final_norm", "lm_head")
           if k in params}
    per_slot, tail = {}, {}
    for (key, r, _), layer in zip(layer_blocks(cfg), params["layers"]):
        if r is None:
            tail[key] = layer
        else:
            per_slot.setdefault(key, []).append(layer)

    def stack(layers):
        return {k: stack([lay[k] for lay in layers])
                if isinstance(layers[0][k], dict)
                else torch.stack([lay[k] for lay in layers])
                if len(layers) > 1 else layers[0][k].unsqueeze(0)
                for k in layers[0]}

    out["slots"] = {key: stack(layers) for key, layers in per_slot.items()}
    if tail:
        out["tail"] = tail
    return out


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


_MIXER_FWD = {"mamba": SSM.mamba_fwd, "mlstm": SSM.mlstm_fwd,
              "slstm": SSM.slstm_fwd}


def _apply_block(block, p, x, positions, cfg, xf=None, mesh=None):
    """One block over the full sequence -> ``(x, xf, aux)``: the residual
    stream, the f32 sum it was rounded from, and the MoE aux loss (None
    without MoE).  norm1 reads ``xf`` where the caller passes it (see
    ``_carries_f32``), else ``x``."""
    mixer, mlp = block
    h = L.rmsnorm(p["norm1"], x if xf is None else xf,
                  cfg.norm_eps).to(x.dtype)
    if mixer in ("attn", "local"):
        out, _ = L.attention_fwd(p["attn"], h, positions, cfg, mixer, mesh)
    else:
        out = _MIXER_FWD[mixer](p[mixer], h, cfg, mesh=mesh)
    return _residual_mlp(mlp, p, x, out, cfg, mesh)


def _residual_mlp(mlp, p, x, out, cfg, mesh=None):
    """``x + out``, then the dense or MoE MLP's residual -> ``(x, xf,
    aux)``.  The reference's compiled block feeds norm2 the f32 sum ``x +
    out`` (XLA keeps the excess precision of an add fused into the norm's
    f32 convert) while the residual stream itself is the sum rounded to
    bf16; the port does both, and returns the block's last f32 sum beside
    its rounding for the next block's norm1."""
    xf = x.float() + out  # out promotes to f32 exactly
    x = xf.to(x.dtype)
    if mlp == "none":
        return x, xf, None
    h = L.rmsnorm(p["norm2"], xf, cfg.norm_eps).to(x.dtype)
    if mlp == "dense":
        out, aux = L.mlp_fwd(p["mlp"], h, mesh, cfg.d_ff), None
    else:
        out, aux = MOE.moe_fwd(p["moe"], h, cfg, mesh)
    xf = x.float() + out
    return xf.to(x.dtype), xf, aux


def _carries_f32(key):
    """Whether the block at ``key`` reads the previous block's f32 sum in
    its norm1.  The reference runs a pattern's blocks in one compiled scan
    body, where the sum of one block's last add stays f32 into the next
    block's norm as into norm2; the scan's carry between repeats, and so
    the first block of a repeat and of the tail, is the bf16 stream."""
    return key not in ("slot00", "tail00")


def _final_input(x, xf, cfg):
    """What the final norm reads: the last block's f32 sum where that
    block is a tail block (compiled with the norm, outside the scan), the
    scan's bf16 carry otherwise."""
    return xf if cfg.tail_pattern else x


def _save_dots(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat="dots"`` (the reference's
    ``checkpoint_dots_with_no_batch_dims``): keep the output of every
    product without batch dims -- an einsum's ``bmm`` over a batch of one
    -- and recompute the rest."""
    if op is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_block(remat, *args):
    """``_apply_block`` under ``torch.utils.checkpoint``: its backward
    recomputes the block from its inputs (``"full"``) or from its inputs
    and its saved products (``"dots"``).  The recompute runs the same ops
    on the same inputs, so no loss or gradient bit changes."""
    context = {} if remat == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(_save_dots)}
    return checkpoint(_apply_block, *args, use_reentrant=False, **context)


def _stack_fwd(params, x, positions, cfg, mesh=None):
    """Run every layer in order. Returns (x, aux_loss): the stream the
    final norm reads (``_final_input``), and the MoE blocks' aux losses
    summed in f32 in layer order (an f32 zero without MoE), as the
    reference carries them through its scans.

    Where autograd records the call (training) and ``cfg.remat`` is not
    ``"none"``, each block is its own checkpoint (``_remat_block``): the
    backward's high-water mark is one block's activations.  The
    reference nests a second checkpoint around each pattern repeat; one
    level already keeps only the residual stream between blocks."""
    apply = _apply_block
    # autograd records the call: the train step asks for every leaf's grad
    if cfg.remat != "none" and torch.is_grad_enabled() and \
            params["final_norm"]["scale"].requires_grad:
        apply = lambda *args: _remat_block(cfg.remat, *args)
    aux = torch.zeros((), dtype=F32, device=x.device)
    xf = None
    for (key, _, block), p in zip(layer_blocks(cfg), params["layers"]):
        x, xf, a = apply(block, p, x, positions, cfg,
                         xf if _carries_f32(key) else None, mesh)
        if a is not None:
            aux = aux + a
    return _final_input(x, xf, cfg), aux


def _embed_inputs(params, batch, cfg, mesh=None):
    """Token/frontend embedding; returns x [B,S,d]."""
    if cfg.frontend == "audio":
        return batch["frames"].to(L.PDT)
    x = L.embed(params["embed"], batch["tokens"], cfg.d_model, mesh,
                cfg.vocab_size)
    if cfg.frontend == "vision":
        x = torch.cat([batch["patches"].to(L.PDT), x], dim=1)
    return x


def backbone(params, batch, cfg: ModelConfig, mesh=None):
    """Embed + stack + final norm -> (hidden [B,S,d], aux).  The LM head is
    applied separately (``forward`` / ``forward_last``)."""
    x = _embed_inputs(params, batch, cfg, mesh)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    x, aux = _stack_fwd(params, x, positions, cfg, mesh)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps).to(L.PDT), aux


def head_params(params, cfg: ModelConfig):
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward(params, batch, cfg: ModelConfig, mesh=None):
    """Full-sequence forward -> (logits [B,S,V] f32, aux); a vocab-split
    head's logits are gathered over the model axis."""
    x, aux = backbone(params, batch, cfg, mesh)
    return head_logits(params, x, cfg, mesh), aux


def forward_last(params, batch, cfg: ModelConfig):
    """Forward with logits for the LAST position only (prefill serving)."""
    x, aux = backbone(params, batch, cfg)
    return L.logits_fwd(head_params(params, cfg), x[:, -1:],
                        cfg.final_logit_softcap), aux


def head_logits(params, x, cfg, mesh=None, last=False):
    """The LM head's f32 logits of ``x`` (``last``: of its last position
    only, the product taken over every position as the reference's
    prefill step takes it), gathered over the model axis where the head
    splits by vocab."""
    head = head_params(params, cfg)
    split = head["table"].shape[0] != cfg.vocab_size
    logits = L.logits_fwd(head, LM.copy_to(x, mesh) if split else x,
                          cfg.final_logit_softcap)
    if last:
        logits = logits[:, -1:]
    return LM.gather_from(logits, mesh, "model", 2) if split else logits


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _cache_len(cfg, mixer, max_len):
    if mixer == "local" and cfg.window and cfg.window < max_len:
        return cfg.window  # ring buffer
    return max_len


_MIXER_CACHE = {"mamba": SSM.mamba_init_cache, "mlstm": SSM.mlstm_init_cache,
                "slstm": SSM.slstm_init_cache}


def _init_block_cache(cfg, block, batch, max_len, device, lead=()):
    mixer, _ = block
    if mixer in _MIXER_CACHE:
        return _MIXER_CACHE[mixer](cfg, batch, device, lead)
    n = _cache_len(cfg, mixer, max_len)
    shape = lead + (batch, n, cfg.num_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=L.PDT, device=device),
            "v": torch.zeros(shape, dtype=L.PDT, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Decode cache: per pattern slot, stacked over repeats (the
    reference's layout); per tail block, one.  ``device="meta"`` gives the
    shapes without storage."""
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    cache = {}
    for i, block in enumerate(cfg.layer_pattern):
        cache[f"slot{i:02d}"] = _init_block_cache(
            cfg, block, batch, max_len, device, (cfg.repeats,))
    for i, block in enumerate(cfg.tail_pattern):
        cache[f"tail{i:02d}"] = _init_block_cache(cfg, block, batch, max_len,
                                                  device)
    return cache


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    """The decode cache on the ``meta`` device: shapes and dtypes, no
    storage (the reference's ``jax.eval_shape`` twin)."""
    return init_cache(cfg, batch, max_len, device="meta")


_MIXER_DECODE = {"mamba": SSM.mamba_decode, "mlstm": SSM.mlstm_decode,
                 "slstm": SSM.slstm_decode}


def _decode_block(block, p, x, pos, cache, cfg, xf=None, mesh=None,
                  max_len=None):
    """One block at one position -> ``(x, xf)`` (see ``_apply_block``);
    ``cache`` holds this layer's views of the decode cache, which are
    updated in place.  On a mesh the blocks run as ``_apply_block``'s
    do; an attention cache's ring is ``_cache_len(max_len)`` long."""
    mixer, mlp = block
    h = L.rmsnorm(p["norm1"], x if xf is None else xf,
                  cfg.norm_eps).to(x.dtype)
    if mixer in ("attn", "local"):
        # ring-buffer semantics live inside attention_decode: when the
        # cache is window-sized the slot wraps, otherwise it degenerates to
        # a full cache
        W = None if max_len is None else _cache_len(cfg, mixer, max_len)
        out, _ = L.attention_decode(p["attn"], h, pos, cache["k"],
                                    cache["v"], cfg, mixer, mesh, W)
    else:
        out, new = _MIXER_DECODE[mixer](p[mixer], h, cache, cfg, mesh)
        for k, v in new.items():
            cache[k].copy_(v)
    # the decode step drops the MoE aux loss, as the reference's does
    return _residual_mlp(mlp, p, x, out, cfg, mesh)[:2]


def decode_step(params, tokens, pos, cache, cfg: ModelConfig, mesh=None,
                max_len=None):
    """One decode step: tokens i32[B,1] at position ``pos`` -> (logits
    [B,1,V] f32, cache).  The cache is updated in place and returned.

    On a mesh (``serve.make_decode_step(cfg, mesh)``): ``params`` are this
    rank's model-axis shards, ``tokens`` its rows, ``cache`` its block as
    ``serve.cache_specs`` places it, and ``max_len`` the whole cache's
    length (an attention cache whose sequence splits over the model axis
    holds a part of it); the logits are the rows' whole vocab."""
    if LM.model_size(mesh) > 1 and max_len is None:
        raise ValueError("decode_step on a model axis needs max_len, the "
                         "whole cache's length")
    pos = int(pos)
    x = L.embed(params["embed"], tokens, cfg.d_model, mesh, cfg.vocab_size)
    xf = None
    for (key, r, block), p in zip(layer_blocks(cfg), params["layers"]):
        c = cache[key]
        if r is not None:
            c = {k: v[r] for k, v in c.items()}
        x, xf = _decode_block(block, p, x, pos, c, cfg,
                              xf if _carries_f32(key) else None, mesh,
                              max_len)
    x = L.rmsnorm(params["final_norm"], _final_input(x, xf, cfg),
                  cfg.norm_eps).to(L.PDT)
    return head_logits(params, x, cfg, mesh), cache


def prefill(params, batch, cfg: ModelConfig, max_len: int):
    """The reference's ``prefill``: ``forward_last``'s ``(last-token
    logits, aux)`` pair (its docstring names a cache it does not return;
    ``serve.prefill_with_cache`` builds one)."""
    return forward_last(params, batch, cfg)
