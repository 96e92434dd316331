"""Communication strategies -- the paper's Charm++ variants on one device.

Every strategy computes, per chare, the combined incoming contribution for
each locally-owned vertex:

    incoming[c, j] = combine_{e : dst(e) == c*K + j} value(src(e))

The twin of ``repro/core/strategies.py`` for the 1-D variants.  The
reference maps chares to mesh shards and its collectives to XLA's; here the
chares are the leading axis of ``[C, ...]`` tensors on one device and each
collective is a tensor op on that axis:

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

Without a push hook, phase 1's local combine is staged: gather, edge
transform, mask, segment combine.  On the CPU the gather and segment
combine are plain torch (the reference's XLA gather and
``segment_sum``/``segment_min``); on the card they are the staged CUDA
kernels (``push_staged``), one gather and one scatter launch over every
chare row, with the kernels' semantics: float-min values at or above
``float(SENTINEL)`` read as unreached.  A ``segment_fn`` hook
(``ops.make_segment_fn``) takes the segment combine on either device.

``grid2d`` is not ported yet (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
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


def _gather(vals, src_local, edge_valid, combiner):
    """Every chare row's ``vals[r, src_local[r]]``: ``[C, E(, B)]``.  On the
    card the gather kernel of the monoid (invalid edges read the identity;
    the mask after the edge transform decides either way)."""
    if vals.device.type == "cpu":
        C, E = src_local.shape
        tail = tuple(vals.shape[2:])
        return vals.reshape((-1,) + tail).index_select(
            0, _row_offsets(src_local, vals.shape[1])).reshape((C, E) + tail)
    if combiner.name == "add":
        return push_staged.gather_sum(src_local, edge_valid, vals)
    return push_staged.gather_min(src_local, edge_valid, vals)


def _segment(combiner, segment_fn, data, seg_ids, num_segments):
    """Every chare row's local combine: ``data`` ``[C, E(, B)]`` by
    ``seg_ids`` ``[C, E]`` -> ``[C, S(, B)]``.  A ``segment_fn`` hook
    receives the rows as they are and the active monoid via the ``combine``
    keyword (dtype inference cannot tell float add, PageRank, from float
    min, SSSP).  Without one: the combiner's segment op on the CPU, the
    scatter kernel on the card."""
    if segment_fn is not None:
        return segment_fn(data, seg_ids, num_segments, combine=combiner.name)
    if data.device.type != "cpu":
        return ops.segment_reduce(data, seg_ids, num_segments,
                                  combine=combiner.name)
    C, E = seg_ids.shape
    tail = tuple(data.shape[2:])
    out = combiner.segment(data.reshape((C * E,) + tail),
                           _row_offsets(seg_ids, num_segments),
                           C * num_segments)
    return out.reshape((C, num_segments) + tail)


def _dense_contrib(vals, src_local, dst_global, edge_valid, edge_weight,
                   combiner, num_chunks, chunk_size, segment_fn=None,
                   edge_value=None, push_fn=None, band=None,
                   edge_semiring=None, init=None):
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
    ``segment_fn`` when given).
    """
    S = num_chunks * chunk_size
    if push_fn is not None and (edge_value is None or edge_semiring):
        unit = edge_semiring == "unit" and edge_value is not None
        weight = edge_weight if edge_semiring == "weight" \
            and edge_value is not None else None
        return push_fn(vals, src_local, dst_global, edge_valid, weight, S,
                       combine=combiner.name, band=band, unit=unit,
                       init=init)
    gathered = _gather(vals, src_local, edge_valid, combiner)
    contrib = _edge_transform(gathered, edge_weight, edge_value)
    contrib = combiner.mask(contrib, edge_valid)
    out = _segment(combiner, segment_fn, contrib, dst_global, S)
    return out if init is None else combiner.merge(init, out)


# --------------------------------------------------------------------------
# Strategies, split into the reference's two phases:
#
#   phase1(vals, arrs, combiner, C, K, segment_fn=, edge_value=, push_fn=,
#          edge_semiring=)                      -> partial
#   phase2(partial, arrs, combiner, C, K, segment_fn=)
#                                               -> incoming [C, K(, B)]
#
# Phase 1 is every chare's local half (gather + transform + segment
# combine, or for basic the gathered pair payloads); phase 2 is the combine
# across chares.
# --------------------------------------------------------------------------


def reduction_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                     segment_fn=None, edge_value=None, push_fn=None,
                     edge_semiring=None):
    return _dense_contrib(vals, arrs["src_local"], arrs["dst_global"],
                          arrs["edge_valid"], arrs["edge_weight"], combiner,
                          num_chunks, chunk_size, segment_fn, edge_value,
                          push_fn, arrs["band"], edge_semiring)


def reduction_phase2(dense, arrs, combiner, num_chunks, chunk_size,
                     segment_fn=None):
    """``psum``/``pmin`` of every chare's dense buffer, each chare then
    slicing out its own chunk."""
    full = (dense.sum(dim=0, dtype=dense.dtype) if combiner.name == "add"
            else dense.amin(dim=0))
    return full.reshape((num_chunks, chunk_size) + tuple(full.shape[1:]))


def sortdest_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                    segment_fn=None, edge_value=None, push_fn=None,
                    edge_semiring=None):
    return _dense_contrib(vals, arrs["sd_src_local"], arrs["sd_dst_global"],
                          arrs["sd_edge_valid"], arrs["sd_edge_weight"],
                          combiner, num_chunks, chunk_size, segment_fn,
                          edge_value, push_fn, arrs["sd_band"], edge_semiring)


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
                 edge_semiring=None):
    """Every chare's (dst, value) pair payloads, ``[C, C, Pmax(, B)]``: row
    ``[c, k]`` is what chare c sends chare k.  ``push_fn`` does not apply:
    nothing is combined before sending, so the kernel route for this
    variant is the receive side's segment combine."""
    C = num_chunks
    src = pw_arrays["pb_src_local"].reshape(C, -1)
    valid = pw_arrays["pb_valid"].reshape(C, -1)
    payload = _edge_transform(_gather(vals, src, valid, combiner),
                              pw_arrays["pb_weight"].reshape(C, -1),
                              edge_value)
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


# name -> (phase1, phase2).  ``pairs`` shares sortdest's phase 1 (same sd
# layout + local combine); they differ only in how the blocks travel.
PHASES = {
    "reduction": (reduction_phase1, reduction_phase2),
    "sortdest": (sortdest_phase1, sortdest_phase2),
    "basic": (basic_phase1, basic_phase2),
    "pairs": (sortdest_phase1, pairs_phase2),
}


def _compose(phase1, phase2):
    def strategy(vals, arrs, combiner, num_chunks, chunk_size,
                 segment_fn=None, edge_value=None, push_fn=None,
                 edge_semiring=None):
        partial = phase1(vals, arrs, combiner, num_chunks, chunk_size,
                         segment_fn, edge_value, push_fn, edge_semiring)
        return phase2(partial, arrs, combiner, num_chunks, chunk_size,
                      segment_fn)

    return strategy


# the classic one-call entry points: phase 1 then phase 2
STRATEGIES = {name: _compose(*ph) for name, ph in PHASES.items()}

# Which edge layout each strategy's local combine reads -- the engine's
# adaptive dispatch prices the matching band table ("pairwise" has no push
# loop to hook: basic's receive side combines already-gathered payloads).
STRATEGY_LAYOUT = {
    "reduction": "basic",
    "sortdest": "sd",
    "pairs": "sd",
    "basic": "pairwise",
}
