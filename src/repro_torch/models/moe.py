"""Mixture-of-Experts with sort-by-destination dispatch (the paper's
technique at LM scale -- see DESIGN.md section 2).

The port of ``repro/models/moe.py``.  Tokens are *messages*, experts are
*chares*.  Routing slots are ranked by destination expert with a stable
sort (the paper's sort-destination edge layout), so each expert's payload
is one contiguous capacity buffer -- Listing 2's
``outgoing[CHUNKINDEX(dest)]`` -- and each expert's outputs are combined
locally into the token buffer.  Slots past an expert's capacity are
dropped (routed to the table's dummy last row), as in the reference: the
drops are part of the semantics.

``moe_fwd(p, x, cfg, mesh=None)`` runs ``moe_fwd_dense`` without a mesh.
On an ``LmMesh`` (``repro_torch.launch.mesh``) whose model axis divides
the experts it takes the reference's expert-parallel path
(``_moe_expert_parallel``): the router is replicated, each rank holds its
E/n experts (the ``"expert"`` shard of the spec tables), routes every
local token, builds capacity buffers only for its own experts at a
capacity over the local tokens, and the bf16 partials are summed over the
model axis (combine locally, then send); no token all-to-all.  Where the
experts do not divide, every rank computes the dense path -- over the
whole batch, gathered over the batch axes, so the capacity is the
reference's global one.
"""

from __future__ import annotations

import torch

from repro_torch.launch import mesh as LM
from repro_torch.models.layers import PDT, _normal, silu

F32 = torch.float32


def _experts(shape, scale, generator, device):
    """``[E, ...]`` bf16 expert weights, drawn one expert at a time (a
    whole-tensor f32 draw of a full-width expert stack would need several
    times its bf16 bytes at once)."""
    out = torch.empty(shape, dtype=PDT, device=device)
    if out.device.type != "meta":
        for e in range(shape[0]):
            out[e] = _normal(shape[1:], scale, generator, device)
    return out


def init_moe(cfg, generator, device):
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.expert_ff
    return {
        "router": _normal((d, E), d ** -0.5, generator, device, F32),
        "w_gate": _experts((E, d, ff), d ** -0.5, generator, device),
        "w_in": _experts((E, d, ff), d ** -0.5, generator, device),
        "w_out": _experts((E, ff, d), ff ** -0.5, generator, device),
    }


def capacity(tokens: int, cfg) -> int:
    c = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor) + 1
    return max(c, cfg.top_k)


def _route(xt, router, cfg):
    """-> (top_vals [T,k] normalized, top_idx [T,k], gates [T,E] f32).

    The top k by a stable descending sort: among equal gates the lower
    expert id comes first, as ``lax.top_k`` orders them."""
    logits = torch.einsum("td,de->te", xt.float(), router)
    gates = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.sort(gates, dim=-1, descending=True,
                                   stable=True)
    top_vals, top_idx = top_vals[:, :cfg.top_k], top_idx[:, :cfg.top_k]
    top_vals = top_vals / torch.clamp(top_vals.sum(-1, keepdim=True),
                                      min=1e-9)
    return top_vals, top_idx, gates


def _aux_loss(gates, top_idx, cfg):
    """Switch-style load-balance loss from the routing."""
    T = gates.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    me = gates.mean(0)
    ce = _counts(top_idx.reshape(-1), E).to(F32) / (T * k)
    return E * torch.sum(me * ce)


def _counts(ids, n: int):
    """Slots per id over ``[n]`` ids: ``torch.bincount``'s counts, which
    sizes its output from the ids' maximum and so syncs the host (and has
    no ``meta`` kernel); this adds into a fixed ``[n]`` instead."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids.long(), torch.ones_like(ids, dtype=torch.int64))


def _slot_positions(e_ids, num_buckets):
    """Rank of each slot within its bucket (sort-destination, ints only).

    e_ids: [N] bucket id per slot (num_buckets = dummy bucket for drops).
    Returns pos [N] int32: 0-based arrival index of the slot in its bucket.
    """
    n = e_ids.shape[0]
    order = torch.argsort(e_ids, stable=True)  # paper's edge sort
    sorted_e = e_ids[order]
    counts = _counts(sorted_e, num_buckets + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n, device=e_ids.device) - starts[sorted_e]
    pos = torch.empty(n, dtype=torch.int32, device=e_ids.device)
    pos[order] = pos_sorted.to(torch.int32)
    return pos


def dispatch_plan(e_ids, num_buckets: int, C: int):
    """(pos, keep, flat_idx) of each routing slot: its rank in its bucket,
    whether it fits the bucket's capacity ``C`` (a slot of the dummy
    bucket ``num_buckets`` never does), and its row in the
    ``[num_buckets * C + 1]`` capacity table (the last row for a drop)."""
    pos = _slot_positions(e_ids, num_buckets)
    keep = (e_ids < num_buckets) & (pos < C)
    flat_idx = torch.where(keep, e_ids * C + pos, num_buckets * C)
    return pos, keep, flat_idx


def _moe_local(xt, p, cfg, e_local, n_local: int, C: int, top_vals):
    """Expert compute + local combine.

    xt [T, d]: every token; e_local [T*k]: slot -> expert id in
    [0, n_local) or n_local for a dummy; top_vals [T, k] gate weights.
    Returns the combined [T, d] in xt's dtype (zeros where no kept slot
    contributed).  Dispatch is one indexed copy per routing slot ``j``
    into the capacity table, the experts are batched products over
    [n_local, C, d], and the combine gathers and accumulates per slot in
    the activation dtype, in ``j`` order, as the reference does.
    """
    T, d = xt.shape
    k = cfg.top_k
    _, keep, flat_idx = dispatch_plan(e_local, n_local, C)
    idx2 = flat_idx.reshape(T, k)

    # ---- dispatch: one indexed copy per routing slot ----------------------
    xe = torch.zeros((n_local * C + 1, d), dtype=xt.dtype, device=xt.device)
    for j in range(k):
        xe[idx2[:, j]] = xt  # duplicate dummy rows: any one wins
    xe = xe[:-1].reshape(n_local, C, d)

    # ---- expert FFN -------------------------------------------------------
    h = silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    y = torch.einsum("ecf,efd->ecd", h, p["w_out"])
    y = torch.cat([y.reshape(n_local * C, d),
                   torch.zeros((1, d), dtype=y.dtype, device=y.device)])

    # ---- combine: gather + weighted accumulate per slot -------------------
    w = top_vals * keep.reshape(T, k).to(top_vals.dtype)  # [T, k]
    wl = w.to(y.dtype)
    out = torch.zeros((T, d), dtype=y.dtype, device=y.device)
    for j in range(k):
        out = out + wl[:, j, None] * y[idx2[:, j]]
    return out


def moe_fwd_dense(p, x, cfg):
    """All experts on one device, global capacity: ([B, S, d], aux)."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    C = capacity(T, cfg)
    top_vals, top_idx, gates = _route(xt, p["router"], cfg)
    e_flat = top_idx.reshape(-1)
    out = _moe_local(xt, p, cfg, e_flat, cfg.num_experts, C, top_vals)
    return out.reshape(B, S, d).to(x.dtype), _aux_loss(gates, top_idx, cfg)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``factor`` backward."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def moe_fwd(p, x, cfg, mesh=None):
    """x: [B, S, d] -> ([B, S, d], aux): ``x`` holds this rank's batch
    rows on a mesh (the whole batch where it does not split over the
    batch axes).  Expert-parallel where the mesh's model axis is wider
    than 1 and divides the experts, else the dense path."""
    if mesh is None:
        return moe_fwd_dense(p, x, cfg)
    n_model = LM.model_size(mesh)
    if n_model > 1 and cfg.num_experts % n_model == 0:
        return _moe_expert_parallel(p, x, cfg, mesh, n_model)
    axes = mesh.batch_axes()
    n_data = mesh.axis_size(axes)
    if n_data == 1:  # a replicated batch: every rank holds it whole
        return moe_fwd_dense(p, x, cfg)
    # the reference's global capacity: route the whole batch, keep ours;
    # each rank's gradient of the whole batch is its rows' and its share
    # of aux's, summed back over the ranks
    B = x.shape[0]
    out, aux = moe_fwd_dense(p, LM.gather_from(x, mesh, axes, 0,
                                               summed=True), cfg)
    me = mesh.axis_index(axes)
    # every batch rank computes this aux whole; their gradients are summed
    return out[me * B:(me + 1) * B], _ScaleGrad.apply(aux, 1.0 / n_data)


def _moe_expert_parallel(p, x, cfg, mesh, n_model):
    """The reference's ``shard_map`` body on this rank: ``p``'s expert
    leaves hold experts ``[m * n_local, (m + 1) * n_local)``; a slot
    routed elsewhere is remapped to ``n_local`` (a foreign slot, never
    kept); ``C = capacity(T_local)`` over this rank's tokens (the global
    budget over the batch axes; the whole batch's where it does not
    split); the locally combined bf16 partial is summed over the model
    axis, and aux is averaged over the batch axes.  The expert inputs and
    gate weights enter through ``copy_to`` (each rank's gradient covers
    its experts only); the routing runs replicated."""
    B, S, d = x.shape
    T = B * S
    n_local = cfg.num_experts // n_model
    xt = x.reshape(T, d)
    C = capacity(T, cfg)
    top_vals, top_idx, gates = _route(xt, p["router"], cfg)
    e_local = top_idx.reshape(-1) - mesh.axis_index("model") * n_local
    e_local = torch.where((e_local >= 0) & (e_local < n_local), e_local,
                          n_local)
    partial = _moe_local(LM.copy_to(xt, mesh), p, cfg, e_local, n_local, C,
                         LM.copy_to(top_vals, mesh))
    out = LM.reduce_from(partial, mesh).to(x.dtype)
    aux = _aux_loss(gates, top_idx, cfg)
    axes = mesh.batch_axes()
    n_data = mesh.axis_size(axes)
    if n_data > 1:  # routing differs per batch shard -> average
        aux = LM.reduce_from(aux, mesh, axes) / n_data
    return out.reshape(B, S, d), aux
