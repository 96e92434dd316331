"""Loss + train step for every architecture.

The port of ``repro/models/train.py``.  The gradient is torch autograd
through the model's forward (``model.backbone``, each block checkpointed
under ``cfg.remat``) and a chunked cross-entropy head; the optimizer is
``repro_torch.optim`` with the reference's arithmetic.

``TrainState.params`` keeps the REFERENCE's layout (``slots`` leaves
stacked over the pattern's repeats, ``tail``, ``embed``, ``final_norm``,
``lm_head``), not the model's per-layer list: AdamW decays a leaf by its
rank (a norm scale stacked over repeats is 2-D and decays, a tail's is
1-D and does not), a train checkpoint keys each leaf by its path
(``params/slots/slot00/attn/wq``, ``opt_state/1/mu/...``), and the spec
tables key the rules by path and rank -- all three as in the reference.
The forward reads per-layer views of the stacked leaves
(``model.params_from_reference``), so autograd returns each stacked
leaf's gradient whole.

``make_train_step`` returns a ``(state, batch) -> (state, metrics)``
function; ``train_state_specs`` gives the spec tree a mesh places the
state by (``repro_torch.models.sharding``).

With ``mesh=`` (an ``LmMesh``, ``repro_torch.launch.mesh``) the step is
the reference's sharded step, made explicit.  Each rank holds its shards
of the state (``init_state(..., mesh=)``, ``shard_state``): ZeRO over the
batch axes (``"pod"``, ``"data"``), heads, ff, vocab and experts over
``"model"``.  A step takes this rank's rows of the global batch (all of
them where the batch does not split: the reference's replicated batch),
all-gathers the batch-axis dims of the parameters, runs the model
tensor-parallel over ``"model"`` (``model.backbone(mesh=)``; a
vocab-split head in ``chunked_xent``), reduce-scatters each ZeRO leaf's
gradient over the batch axes and all-reduces the rest, and runs the
optimizer on each rank's shards with the global gradient norm.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.store import _leaves, _rebuild
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import param_specs
from repro_torch.optim import (adamw, apply_updates, chain,
                               clip_by_global_norm, global_norm, wsd_schedule)
from repro_torch.optim.transforms import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    step: Any  # int32 0-d tensor
    params: Any  # the reference's layout (see the module docstring)
    opt_state: Any


def make_optimizer(peak_lr=3e-4, warmup=100, total=10_000, clip=1.0,
                   weight_decay=0.1, moment_dtype=F32):
    return chain(clip_by_global_norm(clip),
                 adamw(wsd_schedule(peak_lr, warmup, total),
                       weight_decay=weight_decay,
                       mu_dtype=moment_dtype, nu_dtype=moment_dtype))


def optimizer_for(cfg: ModelConfig, **kw):
    return make_optimizer(moment_dtype=getattr(torch, cfg.opt_moment_dtype),
                          **kw)


def init_state(generator, cfg: ModelConfig, optimizer=None,
               device=None, mesh=None) -> TrainState:
    """Parameters from ``model.init_params`` (drawn from ``generator``, a
    ``torch.Generator`` on ``device``; seed 0 if None) in the reference's
    layout, and the optimizer's initial state; on CUDA unless ``device``
    names another (``"meta"``: shapes only).  With ``mesh=``, each rank
    draws the whole parameters from the seed and keeps its shards, so the
    state is the one-device state, placed."""
    optimizer = optimizer or optimizer_for(cfg)
    params = M.params_to_reference(M.init_params(cfg, generator, device), cfg)
    if mesh is not None:
        params = SH.shard_tree(params, param_specs(params, mesh,
                                                   zero=cfg.zero), mesh)
    step_device = tree_leaves(params)[0].device
    return TrainState(step=torch.zeros((), dtype=torch.int32,
                                       device=step_device),
                      params=params, opt_state=optimizer.init(params))


def abstract_state(cfg: ModelConfig, optimizer=None) -> TrainState:
    """The TrainState on the ``meta`` device: shapes and dtypes, no storage
    (the reference's ``jax.eval_shape`` twin; the restore template)."""
    return init_state(None, cfg, optimizer, device="meta")


def state_specs(cfg: ModelConfig, mesh, optimizer=None) -> TrainState:
    """The spec tree a ``mesh`` places a TrainState of ``cfg`` by
    (``train_state_specs`` of the whole state's shapes, ZeRO as
    ``cfg.zero`` says)."""
    return train_state_specs(abstract_state(cfg, optimizer), mesh,
                             zero=cfg.zero)


def shard_state(state: TrainState, cfg: ModelConfig, mesh,
                optimizer=None) -> TrainState:
    """This rank's shards of a whole ``state``."""
    return SH.shard_tree(state, state_specs(cfg, mesh, optimizer), mesh)


def gather_state(state: TrainState, cfg: ModelConfig, mesh,
                 optimizer=None) -> TrainState:
    """The whole state from every rank's shards (all-gathers; every rank
    gets it)."""
    return SH.gather_tree(state, state_specs(cfg, mesh, optimizer), mesh)


def model_params(params, cfg: ModelConfig):
    """The model's per-layer parameters: views of the reference-layout
    leaves, on their device."""
    return M.params_from_reference(params, cfg,
                                   device=params["embed"]["table"].device)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _xent(logits, labels):
    """Mean token cross-entropy; logits f32 [B,S,V], labels i32 [B,S]."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


# Sequence-chunk size for the CE head: per chunk the live logits tensor is
# [B, CHUNK, V] f32 instead of a full [B,S,V] (gemma3-1b at B=8: 4.3 GB a
# chunk against 8.6 GB for S=1024).  The chunk is checkpointed, so the
# backward recomputes its logits rather than keeping them.
CE_CHUNK = 512


def _chunk_ce(xs, table, ls, cap):
    """Summed (logz - gold) over one chunk's valid labels (>= 0)."""
    logits = L.logits_fwd({"table": table}, xs, cap)  # [B,c,V] f32
    logz = torch.logsumexp(logits, dim=-1)
    # gold logit via mask-reduce, as the reference computes it (with V
    # sharded that is a local reduce, not a gather); one nonzero per row,
    # so the sum is exact
    vids = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(vids == ls[..., None], logits, 0.0).sum(dim=-1)
    valid = (ls >= 0).to(F32)
    return torch.sum((logz - gold) * valid)


def _chunk_ce_split(xs, table, ls, cap, mesh):
    """``_chunk_ce`` over a head split by vocab rows over the model axis:
    this rank's logits, the max and the sum of exps all-reduced over the
    axis (the max as a constant), and the gold logit by mask-reduce on
    the rank that holds its row plus an all-reduce."""
    logits = L.logits_fwd({"table": table}, LM.copy_to(xs, mesh), cap)
    m = mesh.all_reduce(logits.detach().amax(dim=-1), "model", "max")
    z = LM.reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), mesh)
    logz = m + torch.log(z)
    Vl = logits.shape[-1]
    vids = torch.arange(Vl, device=logits.device) + \
        mesh.axis_index("model") * Vl
    gold = LM.reduce_from(
        torch.where(vids == ls[..., None], logits, 0.0).sum(dim=-1), mesh)
    valid = (ls >= 0).to(F32)
    return torch.sum((logz - gold) * valid)


def chunked_xent(x, head, labels, cfg, chunk: int = CE_CHUNK, mesh=None):
    """CE over seq-chunks: x [B,S,d] hidden, head {'table': [V,d]}.

    Returns summed (logz - gold) and the token count, so the caller controls
    the normalization (mean over tokens).  Chunks add in order into an f32
    total, as the reference's scan carries it.  A head split by vocab
    over ``mesh``'s model axis runs ``_chunk_ce_split``.
    """
    B, S, d = x.shape
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad, d))], dim=1)
        labels = torch.cat([labels, labels.new_full((B, pad), -1)], dim=1)
    table = head["table"]
    fn, extra = _chunk_ce, ()
    if table.shape[0] != cfg.vocab_size:
        fn, extra = _chunk_ce_split, (mesh,)
    remat = torch.is_grad_enabled() and (x.requires_grad
                                         or table.requires_grad)
    total = torch.zeros((), dtype=F32, device=x.device)
    for start in range(0, S + pad, chunk):
        args = (x[:, start:start + chunk], table,
                labels[:, start:start + chunk], cfg.final_logit_softcap,
                *extra)
        if remat:
            part = checkpoint(fn, *args, use_reentrant=False)
        else:
            part = fn(*args)
        total = total + part
    return total, B * S  # S = original (pre-pad) length; padded slots masked


def loss_fn(params, batch, cfg: ModelConfig, aux_weight: float = 0.01,
            mesh=None):
    """(loss, metrics) for reference-layout ``params`` on one batch.

    On a mesh, ``params`` are this rank's model-axis shards and ``batch``
    its rows: the mean is over the global token count, and the batch
    ranks' parts are summed (an all-reduce whose backward is the
    identity, so each rank's gradient is its own rows' part and the
    step's sum over the batch axes is the whole)."""
    x, aux = M.backbone(model_params(params, cfg), batch, cfg, mesh)
    labels = batch["labels"]
    if not cfg.encoder_only:
        # next-token prediction: hidden[t] predicts labels[t+1]
        x, labels = x[:, :-1], labels[:, 1:]
    total, count = chunked_xent(x, M.head_params(params, cfg), labels, cfg,
                                mesh=mesh)
    if mesh is None:
        ce = total / count
    else:
        axes = mesh.batch_axes()
        ce = LM.reduce_from(total / (count * mesh.axis_size(axes)), mesh,
                            axes)
    loss = ce + aux_weight * aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def value_and_grad(params, batch, cfg: ModelConfig, aux_weight=0.01,
                   mesh=None):
    """(metrics, grads): the loss's gradient for every leaf of ``params``
    (a tree of the same structure), by autograd.  A leaf the loss does
    not reach (hubert's embedding table, which its audio frontend
    bypasses) gets zeros, as ``jax.grad`` gives it, so the optimizer
    still decays it and moves its moments.  On a mesh (``loss_fn``'s
    ``mesh=``) each gradient is this rank's part, before the batch-axis
    sum."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    pairs = list(_leaves(live))
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch, cfg, aux_weight, mesh)
        grads = torch.autograd.grad(loss, [t for _, t in pairs],
                                    allow_unused=True)
    grads = {path: torch.zeros_like(t) if g is None else g
             for (path, t), g in zip(pairs, grads)}
    return ({k: v.detach() for k, v in metrics.items()},
            _rebuild(live, grads))


def make_train_step(cfg: ModelConfig, optimizer=None, microbatches: int = 1,
                    mesh=None):
    """(state, batch) -> (state, metrics).

    ``microbatches > 1`` accumulates grads over batch slices in f32 and
    casts their mean to each param's dtype (the reference's scan over
    microbatches): a smaller activation high-water mark for the same
    step.  With ``mesh=`` the state holds this rank's shards and
    ``batch`` is the global batch (see the module docstring); the
    microbatches slice this rank's rows.
    """
    optimizer = optimizer or optimizer_for(cfg)
    specs = None if mesh is None else param_specs(
        abstract_state(cfg, optimizer).params, mesh, zero=cfg.zero)

    def accumulate(params, batch, run):
        if microbatches == 1:
            metrics, grads = value_and_grad(params, batch, cfg, mesh=run)
            return grads, metrics
        n = next(iter(batch.values())).shape[0] // microbatches
        acc = None
        metrics_acc = {k: torch.zeros((), dtype=F32,
                                      device=params["embed"]["table"].device)
                       for k in ("loss", "ce", "aux")}
        for i in range(microbatches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            metrics, grads = value_and_grad(params, mb, cfg, mesh=run)
            if acc is None:  # 0 + g, as the reference's zeros start
                acc = tree_map(lambda g: g.float(), grads)
            else:
                acc = tree_map(lambda a, g: a.add_(g.float()), acc, grads)
            metrics_acc = {k: a + metrics[k] / microbatches
                           for k, a in metrics_acc.items()}
            del grads
        grads = tree_map(lambda g, p: (g / microbatches).to(p.dtype), acc,
                         params)
        return grads, metrics_acc

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if mesh is None:
            grads, metrics = accumulate(state.params, batch, None)
            kw = {}
        else:
            grads, metrics = _sharded_grads(state.params, batch, specs,
                                            mesh, accumulate)
            kw = {"mesh": mesh, "specs": specs}
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params, **kw)
        params = apply_updates(state.params, updates)
        metrics = dict(metrics, grad_norm=global_norm(grads, **kw))
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state), metrics

    return train_step


def _batch_spec(spec, mesh):
    """``spec`` with only its dims split over batch axes (the ZeRO dims)
    kept, the others ``None``."""
    batch = set(LM.BATCH_AXES)
    return tuple(e if (names := SH._axes_of(e)) and set(names) <= batch
                 and mesh.axis_size(names) > 1 else None for e in spec)


def batch_rows(batch, mesh):
    """This rank's rows of a global ``batch`` (all of them on a mesh that
    keeps the batch replicated)."""
    axes = mesh.batch_axes()
    n = mesh.axis_size(axes)
    if n == 1:
        return batch
    i = mesh.axis_index(axes)
    return {k: v.narrow(0, i * (v.shape[0] // n), v.shape[0] // n)
            for k, v in batch.items()}


def _sharded_grads(params, batch, specs, mesh, accumulate):
    """One rank's gradient shards and the global metrics: the batch-axis
    (ZeRO) dims of ``params`` all-gathered, this rank's rows through the
    model on the mesh, then each ZeRO leaf's gradient reduce-scattered
    over its batch axes and every other leaf's all-reduced over the batch
    axes (on a replicated batch every rank's gradient is already whole:
    a ZeRO leaf keeps its block)."""
    run = mesh.for_batch(next(iter(batch.values())).shape[0])
    whole = SH.map_specs(
        lambda t, s: SH.gather_leaf(t, _batch_spec(s, mesh), mesh),
        params, specs)
    grads, metrics = accumulate(whole, batch_rows(batch, run), run)
    axes = run.batch_axes()

    def sync(g, spec):
        zero = _batch_spec(spec, mesh)
        if not axes:
            return SH.shard_leaf(g, zero, mesh)
        for d, e in enumerate(zero):
            if e is not None:
                g = mesh.reduce_scatter(g, e, d)
        return g if any(zero) else mesh.all_reduce(g, axes)

    return SH.map_specs(sync, grads, specs), metrics


# ---------------------------------------------------------------------------
# Sharding specs
# ---------------------------------------------------------------------------


def train_state_specs(state_shape: TrainState, mesh, zero=True) -> TrainState:
    """Spec tree matching a TrainState: opt moments shard like their params."""
    pspecs = param_specs(state_shape.params, mesh, zero=zero)

    def walk(sub):
        # mu/nu mirror params; count is replicated; clip state is ().
        if isinstance(sub, dict) and set(sub) >= {"mu", "nu"}:
            return {**{k: () for k in sub if k not in ("mu", "nu")},
                    "mu": pspecs, "nu": pspecs}
        if isinstance(sub, tuple):
            return tuple(walk(s) for s in sub)
        if isinstance(sub, dict):
            return {k: walk(v) for k, v in sub.items()}
        return tree_map(lambda _: (), sub)

    return TrainState(step=(), params=pspecs,
                      opt_state=walk(state_shape.opt_state))


def batch_specs(batch_shape, mesh) -> dict:
    """Batch dim sharded over (pod, data); seq/vocab dims replicated
    (replicated where the batch does not divide)."""
    sizes = dict(mesh.shape)
    names = [n for n in ("pod", "data") if n in sizes]
    spec = tuple(names) if len(names) > 1 else (names[0] if names else None)
    total = 1
    for n in names:
        total *= sizes[n]

    def one(leaf):
        nd = len(leaf.shape)
        if total > 1 and leaf.shape[0] % total == 0:
            return (spec,) + (None,) * (nd - 1)
        return (None,) * nd

    return tree_map(one, batch_shape)

