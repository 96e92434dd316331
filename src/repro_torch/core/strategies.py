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

``basic`` (pairwise layout + the staged segment kernels) and ``grid2d`` are
not ported yet (ROADMAP queue 1, items 6 and the queue-2 staged kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import ref

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


def _dense_contrib(vals, src_local, dst_global, edge_valid, edge_weight,
                   combiner, num_chunks, chunk_size, edge_value=None,
                   push_fn=None, band=None, edge_semiring=None, init=None):
    """Every chare's local per-destination combine into a dense [C*K]
    buffer: ``vals`` ``[C, K(, B)]``, edges ``[C, Emax]`` -> ``[C, C*K(, B)]``,
    row c being what the reference computes on shard c.

    A ``push_fn`` hook (``ops.make_push_fn``) takes over the WHOLE loop --
    gather, semiring edge transform, segment combine -- as one fused launch
    over all chare rows, fed by the layout's ``band`` table.  The transform
    is chosen by the program's *declared* ``edge_semiring``: ``None`` (no
    ``edge_value``) sends the vertex value untransformed, ``"weight"``
    applies the canonical transform over the layout weights, ``"unit"`` the
    same with w=1.  A program whose ``edge_value`` is not declared
    kernel-expressible runs the staged path below instead.  Without a hook
    the staged path is plain torch: gather, ``edge_value``, mask, segment
    combine.  It takes CPU tensors only: on the card the staged pipeline
    needs the staged kernels, which are not ported yet.
    """
    S = num_chunks * chunk_size
    if push_fn is not None and (edge_value is None or edge_semiring):
        unit = edge_semiring == "unit" and edge_value is not None
        weight = edge_weight if edge_semiring == "weight" \
            and edge_value is not None else None
        return push_fn(vals, src_local, dst_global, edge_valid, weight, S,
                       combine=combiner.name, band=band, unit=unit,
                       init=init)
    if vals.device.type != "cpu":
        raise NotImplementedError(
            f"the staged push on {vals.device} (push_fn=None, or an "
            "edge_value without a declared edge_semiring) needs the staged "
            "kernels, not ported yet (ROADMAP queue 2, items 3-6)")
    C, E = src_local.shape
    tail = tuple(vals.shape[2:])
    gathered = vals.reshape((-1,) + tail).index_select(
        0, _row_offsets(src_local, vals.shape[1])).reshape((C, E) + tail)
    contrib = _edge_transform(gathered, edge_weight, edge_value)
    contrib = combiner.mask(contrib, edge_valid)
    out = combiner.segment(contrib.reshape((C * E,) + tail),
                           _row_offsets(dst_global, S), C * S)
    out = out.reshape((C, S) + tail)
    return out if init is None else combiner.merge(init, out)


# --------------------------------------------------------------------------
# Strategies, split into the reference's two phases:
#
#   phase1(vals, arrs, combiner, C, K, edge_value=, push_fn=,
#          edge_semiring=)                      -> partial  [C, C*K(, B)]
#   phase2(partial, arrs, combiner, C, K)       -> incoming [C, K(, B)]
#
# Phase 1 is every chare's local half (gather + transform + segment
# combine); phase 2 is the combine across chares.
# --------------------------------------------------------------------------


def reduction_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                     edge_value=None, push_fn=None, edge_semiring=None):
    return _dense_contrib(vals, arrs["src_local"], arrs["dst_global"],
                          arrs["edge_valid"], arrs["edge_weight"], combiner,
                          num_chunks, chunk_size, edge_value, push_fn,
                          arrs["band"], edge_semiring)


def reduction_phase2(dense, arrs, combiner, num_chunks, chunk_size):
    """``psum``/``pmin`` of every chare's dense buffer, each chare then
    slicing out its own chunk."""
    full = (dense.sum(dim=0, dtype=dense.dtype) if combiner.name == "add"
            else dense.amin(dim=0))
    return full.reshape((num_chunks, chunk_size) + tuple(full.shape[1:]))


def sortdest_phase1(vals, arrs, combiner, num_chunks, chunk_size,
                    edge_value=None, push_fn=None, edge_semiring=None):
    return _dense_contrib(vals, arrs["sd_src_local"], arrs["sd_dst_global"],
                          arrs["sd_edge_valid"], arrs["sd_edge_weight"],
                          combiner, num_chunks, chunk_size, edge_value,
                          push_fn, arrs["sd_band"], edge_semiring)


def sortdest_phase2(dense, arrs, combiner, num_chunks, chunk_size):
    """``psum_scatter`` (add) or one block per destination chunk +
    ``all_to_all`` + merge (min): chare c receives block c of every chare's
    buffer and folds them."""
    blocks = dense.reshape((num_chunks, num_chunks, chunk_size)
                           + tuple(dense.shape[2:]))
    if combiner.name == "add":
        return blocks.sum(dim=0, dtype=blocks.dtype)
    return blocks.amin(dim=0)


def pairs_phase2(dense, arrs, combiner, num_chunks, chunk_size):
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
    "pairs": (sortdest_phase1, pairs_phase2),
}


def _compose(phase1, phase2):
    def strategy(vals, arrs, combiner, num_chunks, chunk_size,
                 edge_value=None, push_fn=None, edge_semiring=None):
        partial = phase1(vals, arrs, combiner, num_chunks, chunk_size,
                         edge_value, push_fn, edge_semiring)
        return phase2(partial, arrs, combiner, num_chunks, chunk_size)

    return strategy


# the classic one-call entry points: phase 1 then phase 2
STRATEGIES = {name: _compose(*ph) for name, ph in PHASES.items()}

# Which edge layout each strategy's local combine reads -- the engine's
# adaptive dispatch prices the matching band table.
STRATEGY_LAYOUT = {
    "reduction": "basic",
    "sortdest": "sd",
    "pairs": "sd",
}
