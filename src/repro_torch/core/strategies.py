"""Communication strategies -- the paper's Charm++ variants on one device.

Every strategy computes, per chare, the combined incoming contribution for
each locally-owned vertex:

    incoming[c, j] = combine_{e : dst(e) == c*K + j} value(src(e))

The twin of ``repro/core/strategies.py``.  The reference maps chares to
mesh shards and its collectives to XLA's; here the chares are the leading
axis of ``[C, ...]`` tensors on one device and each collective is a tensor
op on that axis:

  reduction  dense |V| buffer per chare, ``psum``      -> sum / amin over
                                                          axis 0, own slice
  sortdest   local combine by destination, then
             ``psum_scatter`` (sum) or per-chunk
             blocks + ``all_to_all`` + merge (min)     -> sum over axis 0 as
                                                          [C, K] / amin over
                                                          the source axis
  pairs      ring ``ppermute`` reduce-scatter          -> ``roll`` hops that
                                                          fold in the same
                                                          order
  basic      (dst, value) pairs, ``all_to_all``        -> a swap of the two
                                                          chare axes of the
                                                          [C, C, Pmax] pair
                                                          buffers
  grid2d     per-rectangle partials, then a full-
             axis reduce or column-group + row-group
             reduces (``axis_index_groups``)           -> reductions over the
                                                          rectangle axis, or
                                                          over a reshaped
                                                          [R, C, ...] view

Without a push hook, phase 1's local combine is staged: gather, edge
transform, mask, segment combine.  On the CPU the gather and segment
combine are plain torch (the reference's XLA gather and
``segment_sum``/``segment_min``); on the card they are the staged CUDA
kernels (``push_staged``), one gather and one scatter launch over every
chare row, with the kernels' semantics: float-min values at or above
``float(SENTINEL)`` read as unreached.  A ``segment_fn`` hook
(``ops.make_segment_fn``) takes the segment combine on either device.

Phase 1 takes an optional row gate, ``row_active`` (``[C]`` int32 on the
engine's device, 0 for a gated chare row; ``None``: every row active), the
engine's frontier gate: a gated row's partial is the combiner identity
(``phase1_identity``'s row), and the kernels read nothing of it.

No collective moves bytes on one device, so ``grid2d``'s phase 2 counts
what its reduces would put on the wire of a mesh with one rectangle per
device (ring all-reduce: ``2 * bytes * (g-1)/g`` per rectangle for a group
of g), priced as ``cost.grid_collective_bytes`` prices them; the reference
measures the same from its compiled HLO.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels import ops, push_staged, ref

_INT_SENTINEL = ref.SENTINEL


@dataclasses.dataclass(frozen=True)
class Combiner:
    """A commutative monoid used to fold edge contributions per vertex."""

    name: str
    identity: float | int
    segment: Callable  # (data, segment_ids, num_segments) -> combined
    merge: Callable  # elementwise combine of two buffers

    def mask(self, data, valid):
        # valid is per-edge; data may carry a trailing batch axis ([..., B])
        v = valid.to(torch.bool)
        v = v.reshape(v.shape + (1,) * (data.dim() - v.dim()))
        return torch.where(v, data, torch.full((), self.identity,
                                               dtype=data.dtype,
                                               device=data.device))


ADD = Combiner("add", 0.0,
               segment=lambda d, i, n: ref.scatter_sum_ref(i, d, n),
               merge=torch.add)
MIN = Combiner("min", _INT_SENTINEL,
               segment=lambda d, i, n: ref.scatter_min_ref(i, d, n),
               merge=torch.minimum)
# float-valued min (SSSP distances): same monoid, +inf identity so padded
# edges and quiesced vertices stay "unreached" rather than int-sentinel-large
FMIN = Combiner("min", float("inf"),
                segment=lambda d, i, n: ref.scatter_min_ref(i, d, n),
                merge=torch.minimum)


def _edge_transform(vals_at_src, weights, edge_value):
    """Apply a vertex program's per-edge transform ``edge_value(v, w)``.

    ``None`` means the raw vertex value goes on the edge; combiner masking
    happens *after* the transform, so padded edges are immune to whatever
    the transform does with the padding weight.
    """
    if edge_value is None:
        return vals_at_src
    if weights is not None and vals_at_src.dim() > weights.dim():
        # batched plane: per-edge weights broadcast over the query axis
        weights = weights.reshape(
            weights.shape + (1,) * (vals_at_src.dim() - weights.dim()))
    return edge_value(vals_at_src, weights)


def _row_offsets(idx, width):
    """Flat int64 indices into a ``[C * width]`` plane for per-row ``idx``."""
    rows = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)
    return (idx.long() + rows[:, None] * width).reshape(-1)


def _gate_rows(x, row_active, fill):
    """``x`` ``[C, ...]`` with the rows that ``row_active`` gates set to
    ``fill`` (the plain versions' gate)."""
    if row_active is None:
        return x
    live = (row_active != 0).reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(live, x, torch.full((), fill, dtype=x.dtype,
                                           device=x.device))


def _gather(vals, src_local, edge_valid, combiner, row_active=None):
    """Every chare row's ``vals[r, src_local[r]]``: ``[C, E(, B)]``.  On the
    card the gather kernel of the monoid (invalid edges and gated rows read
    the identity; the mask after the edge transform decides either way)."""
    if vals.device.type == "cpu":
        C, E = src_local.shape
        tail = tuple(vals.shape[2:])
        got = vals.reshape((-1,) + tail).index_select(
            0, _row_offsets(src_local, vals.shape[1])).reshape((C, E) + tail)
        return _gate_rows(got, row_active, combiner.identity)
    if combiner.name == "add":
        return push_staged.gather_sum(src_local, edge_valid, vals, row_active)
    return push_staged.gather_min(src_local, edge_valid, vals, row_active)


def _segment(combiner, segment_fn, data, seg_ids, num_segments,
             row_active=None):
    """Every chare row's local combine: ``data`` ``[C, E(, B)]`` by
    ``seg_ids`` ``[C, E]`` -> ``[C, S(, B)]``.  A ``segment_fn`` hook
    receives the rows as they are and the active monoid via the ``combine``
    keyword (dtype inference cannot tell float add, PageRank, from float
    min, SSSP), and a row gate via ``row_active`` when there is one.
    Without one: the combiner's segment op on the CPU, the scatter kernel
    on the card.  Gated rows come out as the identity."""
    gate = {} if row_active is None else {"row_active": row_active}
    if segment_fn is not None:
        return segment_fn(data, seg_ids, num_segments, combine=combiner.name,
                          **gate)
    if data.device.type != "cpu":
        return ops.segment_reduce(data, seg_ids, num_segments,
                                  combine=combiner.name, **gate)
    C, E = seg_ids.shape
    tail = tuple(data.shape[2:])
    out = combiner.segment(data.reshape((C * E,) + tail),
                           _row_offsets(seg_ids, num_segments),
                           C * num_segments)
    return _gate_rows(out.reshape((C, num_segments) + tail), row_active,
                      combiner.identity)


def _dense_contrib(vals, src_local, dst_global, edge_valid, edge_weight,
                   combiner, num_chunks, chunk_size, segment_fn=None,
                   edge_value=None, push_fn=None, band=None,
                   edge_semiring=None, init=None, row_active=None):
    """Every chare's local per-destination combine into a dense [C*K]
    buffer: ``vals`` ``[C, K(, B)]``, edges ``[C, Emax]`` -> ``[C, C*K(, B)]``,
    row c being what the reference computes on shard c.

    A ``push_fn`` hook (``ops.make_push_fn``) takes over the WHOLE loop --
    gather, semiring edge transform, segment combine -- over all chare rows
    (one fused launch, or the staged pair), fed by the layout's ``band``
    table.  The transform is chosen by the program's *declared*
    ``edge_semiring``: ``None`` (no ``edge_value``) sends the vertex value
    untransformed, ``"weight"`` applies the canonical transform over the
    layout weights, ``"unit"`` the same with w=1.  A program whose
    ``edge_value`` is not declared kernel-expressible runs the staged path
    below instead: gather, ``edge_value``, mask, segment combine (through
    ``segment_fn`` when given).  ``row_active`` gates chare rows, in the
    hook (which receives it by keyword when it is given) or in the staged
    kernels.
    """
    S = num_chunks * chunk_size
    if push_fn is not None and (edge_value is None or edge_semiring):
        unit = edge_semiring == "unit" and edge_value is not None
        weight = edge_weight if edge_semiring == "weight" \
            and edge_value is not None else None
        gate = {} if row_active is None else {"row_active": row_active}
        return push_fn(vals, src_local, dst_global, edge_valid, weight, S,
                       combine=combiner.name, band=band, unit=unit,
                       init=init, **gate)
    gathered = _gather(vals, src_local, edge_valid, combiner, row_active)
    contrib = _edge_transform(gathered, edge_weight, edge_value)
    contrib = combiner.mask(contrib, edge_valid)
    out = _segment(combiner, segment_fn, contrib, dst_global, S, row_active)
    return out if init is None else combiner.merge(init, out)


# --------------------------------------------------------------------------
# Strategies, split into the reference's two phases:
#
#   phase1(vals, arrs, combiner, C, K, segment_fn=, edge_value=, push_fn=,
#          edge_semiring=, row_active=)         -> partial
#   phase2(partial, arrs, combiner, C, K, segment_fn=)
#                                               -> incoming [C, K(, B)]
#
# Phase 1 is every chare's local half (gather + transform + segment
# combine, or for basic the gathered pair payloads); phase 2 is the combine
# across chares.
# --------------------------------------------------------------------------


def reduction_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                     segment_fn=None, edge_value=None, push_fn=None,
                     edge_semiring=None, row_active=None):
    return _dense_contrib(vals, arrs["src_local"], arrs["dst_global"],
                          arrs["edge_valid"], arrs["edge_weight"], combiner,
                          num_chunks, chunk_size, segment_fn, edge_value,
                          push_fn, arrs["band"], edge_semiring,
                          row_active=row_active)


def reduction_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                     segment_fn=None):
    """``psum``/``pmin`` of every chare's dense buffer, each chare then
    slicing out its own chunk."""
    full = (dense.sum(dim=0, dtype=dense.dtype) if combiner.name == "add"
            else dense.amin(dim=0))
    return full.reshape((num_chunks, chunk_size) + tuple(full.shape[1:]))


def sortdest_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                    segment_fn=None, edge_value=None, push_fn=None,
                    edge_semiring=None, row_active=None):
    return _dense_contrib(vals, arrs["sd_src_local"], arrs["sd_dst_global"],
                          arrs["sd_edge_valid"], arrs["sd_edge_weight"],
                          combiner, num_chunks, chunk_size, segment_fn,
                          edge_value, push_fn, arrs["sd_band"], edge_semiring,
                          row_active=row_active)


def sortdest_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                    segment_fn=None):
    """``psum_scatter`` (add) or one block per destination chunk +
    ``all_to_all`` + merge (min): chare c receives block c of every chare's
    buffer and folds them."""
    blocks = dense.reshape((num_chunks, num_chunks, chunk_size)
                           + tuple(dense.shape[2:]))
    if combiner.name == "add":
        return blocks.sum(dim=0, dtype=blocks.dtype)
    return blocks.amin(dim=0)


def basic_phase1(vals, pw_arrays, combiner, num_chunks, chunk_size,
                 segment_fn=None, edge_value=None, push_fn=None,
                 edge_semiring=None, row_active=None):
    """Every chare's (dst, value) pair payloads, ``[C, C, Pmax(, B)]``: row
    ``[c, k]`` is what chare c sends chare k.  ``push_fn`` does not apply:
    nothing is combined before sending, so the kernel route for this
    variant is the receive side's segment combine.  A gated sender's
    payloads are all the identity."""
    C = num_chunks
    src = pw_arrays["pb_src_local"].reshape(C, -1)
    valid = pw_arrays["pb_valid"].reshape(C, -1)
    payload = _edge_transform(_gather(vals, src, valid, combiner, row_active),
                              pw_arrays["pb_weight"].reshape(C, -1),
                              edge_value)
    if row_active is not None:
        valid = (valid != 0) & (row_active != 0)[:, None]
    payload = combiner.mask(payload, valid)
    return payload.reshape(pw_arrays["pb_src_local"].shape
                           + tuple(payload.shape[2:]))


def basic_phase2(payload, pw_arrays, combiner, num_chunks, chunk_size,
                 segment_fn=None):
    """The ``all_to_all`` of the pair buffers is a swap of the two chare
    axes: receiver k gets row ``[c, k]`` of every sender c.  Then one
    segment combine over all C receiving rows applies the pairs (the
    payloads arrive masked, so no second mask); their segment ids are the
    layout's receiver-major ``pb_recv_dst``, built once with the layout."""
    C = num_chunks
    tail = tuple(payload.shape[3:])
    got = payload.transpose(0, 1).reshape((C, -1) + tail)
    return _segment(combiner, segment_fn, got, pw_arrays["pb_recv_dst"],
                    chunk_size)


def pairs_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                 segment_fn=None):
    """The ring reduce-scatter: chare m starts from its own block for chunk
    m-1, and at hop s receives its predecessor's running block (``roll``)
    and folds in its own block for chunk m-2-s -- the reference's
    ``ppermute`` order, so float sums associate the same way."""
    C = num_chunks
    blocks = dense.reshape((C, C, chunk_size) + tuple(dense.shape[2:]))
    me = torch.arange(C, device=dense.device)
    acc = blocks[me, (me - 1) % C]
    for s in range(C - 1):
        acc = torch.roll(acc, 1, dims=0)
        acc = combiner.merge(acc, blocks[me, (me - 2 - s) % C])
    return acc


def grid_groups(R, C):
    """The reference's static ``axis_index_groups`` for an R x C rectangle
    grid over chare ids ``r*C + c``: column group c = the R chares
    {r*C+c}, row group r = the C contiguous chares r*C..r*C+C-1.  On one
    device they are the two axes of the ``[R, C, ...]`` view that
    ``grid2d_phase2`` reduces over."""
    cols = [[r * C + c for r in range(R)] for c in range(C)]
    rows = [[r * C + c for c in range(C)] for r in range(R)]
    return cols, rows


def _reduce(x, dim, combiner):
    """One reduce of the combiner's monoid over ``dim``, in ``x``'s dtype."""
    if combiner.name == "add":
        return x.sum(dim=dim, dtype=x.dtype)
    return x.amin(dim=dim)


def _price(wire, payload_bytes, group):
    """Add one group reduce's wire bytes per rectangle to ``wire["bytes"]``:
    a ring all-reduce of ``payload_bytes`` over ``group`` members moves
    ``2 * payload_bytes * (group-1)/group`` through each."""
    if wire is not None:
        wire["bytes"] += 2 * payload_bytes * (group - 1) / group


def grid2d_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                  segment_fn=None, edge_value=None, push_fn=None,
                  edge_semiring=None, grid_meta=None, row_active=None,
                  init=None):
    """Every rectangle's local push: gather from its (replicated) row-chunk
    state ``[R*C, Kr(, B)]``, segment-combine into the column-padded space
    -> ``[R*C, C*Kc(, B)]``, the fused kernel fed by ``gr_band``.  ``init``
    (optional, the output's shape) seeds the combine with a prior
    partial."""
    R, C, Kc = grid_meta
    return _dense_contrib(vals, arrs["gr_src_local"], arrs["gr_dst_col"],
                          arrs["gr_edge_valid"], arrs["gr_edge_weight"],
                          combiner, C, Kc, segment_fn, edge_value, push_fn,
                          arrs["gr_band"], edge_semiring, init=init,
                          row_active=row_active)


def grid2d_phase1_window(vals, window_arrays, partial, combiner, num_chunks,
                         chunk_size, segment_fn=None, edge_value=None,
                         push_fn=None, edge_semiring=None, grid_meta=None,
                         row_active=None):
    """Streamed phase 1: fold ONE edge window into the running rectangle
    partial (``residency="stream"``).

    ``window_arrays`` carries the resident grid layout's ``gr_*`` names,
    cut to one BLOCK_E-aligned edge window, so the window's fold IS
    ``grid2d_phase1`` seeded with ``init=partial``.  Each edge lies in
    exactly one window, so min recovers the resident result bit for bit and
    add differs only in float association.  ``row_active`` gates the
    rectangles the window does not fetch: their rows keep ``partial``.
    ``vals``/``partial`` may carry a trailing ``[B]`` query axis, so one
    window's upload serves every column of the fold.
    """
    return grid2d_phase1(vals, window_arrays, combiner, num_chunks,
                         chunk_size, segment_fn, edge_value, push_fn,
                         edge_semiring, grid_meta, row_active=row_active,
                         init=partial)


def grid2d_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                  segment_fn=None, grid_meta=None, collectives="grouped",
                  wire=None):
    """The column combine and row redistribution of the rectangle partials
    ``dense`` ``[R*C, C*Kc(, B)]`` -> the next incoming ``[R*C, Kr(, B)]``,
    every row replica equal.  ``wire`` (optional, ``{"bytes": float}``)
    counts each reduce's bytes per rectangle (``_price``).

    ``full``: one reduce over all R*C rectangles of the whole column space,
    then the ``gr_row_to_col`` gather back into row order, the identity at
    padding (-1).  ``grouped``: each rectangle's own ``Kc`` slice reduced
    within its column group (the R rectangles of its column), scattered into
    row order where it owns the slot (identity elsewhere), then reduced
    within its row group (the C rectangles of its row).  Each vertex's value
    is held by exactly one rectangle per row, so the row reduce is exact for
    add as well as min; the two lowerings fold float sums in different
    orders (R*C partials at once, or R), as the reference's do.
    """
    R, C, Kc = grid_meta
    P, Kr = num_chunks, chunk_size
    m = arrs["gr_row_to_col"]
    tail = tuple(dense.shape[2:])
    lane_bytes = math.prod(tail) * dense.element_size()  # one id's values
    ident = torch.full((), combiner.identity, dtype=dense.dtype,
                       device=dense.device)
    expand = (1,) * len(tail)  # masks broadcast over a trailing [B]
    if collectives == "full" or (R == 1 and C == 1):
        full = _reduce(dense, 0, combiner)
        _price(wire, C * Kc * lane_bytes, P)
        gathered = full.index_select(0, m.clamp(min=0).reshape(-1).long())
        live = (m >= 0).reshape(m.shape + expand)
        return torch.where(live, gathered.reshape((P, Kr) + tail), ident)
    col = torch.arange(C, device=dense.device)
    parts = dense.reshape((R, C, C, Kc) + tail)
    combined = _reduce(parts[:, col, col], 0, combiner)  # [C, Kc(, B)]
    _price(wire, Kc * lane_bytes, R)
    local = m.reshape(R, C, Kr).long() - (col * Kc)[None, :, None]
    own = (local >= 0) & (local < Kc) & (m.reshape(R, C, Kr) >= 0)
    flat = (col * Kc)[None, :, None] + local.clamp(0, Kc - 1)
    gathered = combined.reshape((C * Kc,) + tail).index_select(
        0, flat.reshape(-1)).reshape((R, C, Kr) + tail)
    rowvals = torch.where(own.reshape(own.shape + expand), gathered, ident)
    rows = _reduce(rowvals, 1, combiner)  # [R, Kr(, B)]
    _price(wire, Kr * lane_bytes, C)
    return rows[:, None].expand((R, C, Kr) + tail).reshape((P, Kr) + tail)


# name -> (phase1, phase2).  ``pairs`` shares sortdest's phase 1 (same sd
# layout + local combine); they differ only in how the blocks travel.
# grid2d's phases also take ``grid_meta`` (rows, cols, col_chunk_size), and
# its phase 2 ``collectives`` and ``wire``, by keyword.
PHASES = {
    "reduction": (reduction_phase1, reduction_phase2),
    "sortdest": (sortdest_phase1, sortdest_phase2),
    "basic": (basic_phase1, basic_phase2),
    "pairs": (sortdest_phase1, pairs_phase2),
    "grid2d": (grid2d_phase1, grid2d_phase2),
}


def phase1_identity(strategy, vals, arrs, combiner, num_chunks, chunk_size,
                    grid_meta=None):
    """An all-identity phase-1 partial of the strategy's shape and dtype --
    what a push whose every row is gated gives, and the reference's
    ``lax.cond`` branch for a skipped shard, with the chare axis leading:
    ``[C, C*K(, B)]``, ``basic``'s ``[C, C, Pmax(, B)]``, ``grid2d``'s
    ``[R*C, C*Kc(, B)]``.  Phase 2 over it contributes nothing."""
    tail = tuple(vals.shape[2:])  # the batched plane's trailing [B]
    if strategy == "basic":
        shape = tuple(arrs["pb_src_local"].shape) + tail
    elif strategy == "grid2d":
        shape = (num_chunks, grid_meta[1] * grid_meta[2]) + tail
    else:
        shape = (num_chunks, num_chunks * chunk_size) + tail
    return torch.full(shape, combiner.identity, dtype=vals.dtype,
                      device=vals.device)


def _compose(phase1, phase2):
    def strategy(vals, arrs, combiner, num_chunks, chunk_size,
                 segment_fn=None, edge_value=None, push_fn=None,
                 edge_semiring=None):
        partial = phase1(vals, arrs, combiner, num_chunks, chunk_size,
                         segment_fn, edge_value, push_fn, edge_semiring)
        return phase2(partial, arrs, combiner, num_chunks, chunk_size,
                      segment_fn)

    return strategy


def grid2d(vals, arrs, combiner, num_chunks, chunk_size, segment_fn=None,
           edge_value=None, push_fn=None, edge_semiring=None, grid_meta=None,
           collectives="grouped", wire=None):
    """Two-phase reduce over a 2-D edge grid: every rectangle's local push
    into the column-padded space, then the column combine and row
    redistribution (``grid2d_phase2``).  Nothing edge-proportional is
    combined across rectangles: the payload is vertex-sized."""
    dense = grid2d_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                          segment_fn, edge_value, push_fn, edge_semiring,
                          grid_meta)
    return grid2d_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                         grid_meta=grid_meta, collectives=collectives,
                         wire=wire)


# the classic one-call entry points: phase 1 then phase 2
STRATEGIES = {name: _compose(*ph) for name, ph in PHASES.items()
              if name != "grid2d"}
STRATEGIES["grid2d"] = grid2d

# Strategies whose phase 1 admits the windowed out-of-core schedule
# (``residency="stream"``): phase 1 must be a pure per-shard fold over edge
# slices with a combiner merge -- today that is the grid rectangle layout.
STREAMABLE = {"grid2d"}

# Which edge layout each strategy's local combine reads -- the engine's
# adaptive dispatch prices the matching band table ("pairwise" has no push
# loop to hook: basic's receive side combines already-gathered payloads).
STRATEGY_LAYOUT = {
    "reduction": "basic",
    "sortdest": "sd",
    "pairs": "sd",
    "basic": "pairwise",
    "grid2d": "grid",
}
