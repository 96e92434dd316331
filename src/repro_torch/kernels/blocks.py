"""Kernel tile geometry + band metadata, shared by the layout build and the
push kernels.

A numpy-only copy of ``repro/kernels/blocks.py`` (the reference package pulls
in JAX on import, so the port keeps its own): ``repro_torch.core.graph``
computes the per-edge-block band metadata at partition time, and the CUDA
push kernels read the same tables, so the two packages can never disagree
on tile geometry or band contents.

Band metadata (DESIGN.md section 8): for every BLOCK_E-sized edge block of a
``[C, Emax]`` layout we record the half-open-ish inclusive range of source
vertex blocks and destination segment blocks its *valid* edges touch:

    band[c] = [src_lo, src_hi, seg_lo, seg_hi] per edge block   (int32, [4, NB])

Because the layouts are sorted by (segment block, source block) the bands are
narrow -- a few blocks instead of V/BLOCK_V (gather) or S/BLOCK_S (scatter).
The reference's TPU kernels loop over the in-band tiles only; the port's
Hopper kernels gather and scatter directly and read the table only to skip
empty edge blocks (all padding), which get ``lo=0, hi=-1``.

The same machinery covers 2-D grid partitions (DESIGN.md section 10): the
grouping key generalizes from "owning chare" to "owning edge *rectangle*"
(``edge_rectangles``), ``edge_bands_grouped`` then yields ``[R*C, 4, NB]``
band tables with no rectangle-specific code, and ``rect_bounds`` gives the
per-rectangle edge slices that tile ``[0, E)``.
"""

from __future__ import annotations

import numpy as np

BLOCK_E = 256  # edges per tile
BLOCK_V = 256  # source-vertex chunk
BLOCK_S = 256  # output-segment chunk


def num_edge_blocks(emax: int) -> int:
    """Edge blocks per layout row once padded to the BLOCK_E grid."""
    return max(-(-emax // BLOCK_E), 1)


def edge_bands(src: np.ndarray, dst: np.ndarray, valid: np.ndarray
               ) -> np.ndarray:
    """-> ``[C, 4, NB]`` int32 band metadata for a ``[C, Emax]`` edge layout.

    ``src`` holds local source indices (gather side, blocks of BLOCK_V),
    ``dst`` padded destination ids (scatter side, blocks of BLOCK_S), and
    ``valid`` the 0/1 padding mask.  Rows of the middle axis are
    (src_lo, src_hi, seg_lo, seg_hi), inclusive; blocks with no valid edges
    get (0, -1, 0, -1).
    """
    C, emax = src.shape
    nb = num_edge_blocks(emax)
    pad = nb * BLOCK_E - emax
    if pad:
        widen = lambda a: np.pad(a, ((0, 0), (0, pad)))
        src, dst, valid = widen(src), widen(dst), widen(valid)
    shape = (C, nb, BLOCK_E)
    big = np.int32(1) << 30
    sb = (src.astype(np.int32) // BLOCK_V).reshape(shape)
    db = (dst.astype(np.int32) // BLOCK_S).reshape(shape)
    live = valid.reshape(shape) != 0
    lo = lambda blk: np.where(live, blk, big).min(axis=2)
    hi = lambda blk: np.where(live, blk, np.int32(-1)).max(axis=2)
    band = np.stack([lo(sb), hi(sb), lo(db), hi(db)], axis=1)
    empty = ~live.any(axis=2)  # lo stayed big; clamp to the empty (0, -1)
    band[:, 0][empty] = 0
    band[:, 2][empty] = 0
    return band.astype(np.int32)


def edge_bands_grouped(src_blk: np.ndarray, seg_blk: np.ndarray,
                       per_chunk_e: np.ndarray, emax: int) -> np.ndarray:
    """``edge_bands`` from owner-grouped *flat* arrays -- the partition-time
    fast path (no ``[C, Emax]`` temporaries; one ``reduceat`` per bound).

    ``src_blk``/``seg_blk`` are the per-edge gather/scatter tile ids in the
    final layout order (owners grouped, ``per_chunk_e[c]`` edges per chare);
    ``emax`` is the padded row width the rectangle layout will use.  Returns
    the same ``[C, 4, NB]`` table as ``edge_bands`` on the packed rectangle.
    """
    C = len(per_chunk_e)
    nb = num_edge_blocks(emax)
    band = np.zeros((C, 4, nb), dtype=np.int32)
    band[:, 1] = -1
    band[:, 3] = -1
    nblk = -(-per_chunk_e // BLOCK_E)  # blocks with >= 1 valid edge per row
    total = int(nblk.sum())
    if total == 0:
        return band
    starts = np.zeros(C, dtype=np.int64)
    np.cumsum(per_chunk_e[:-1], out=starts[1:])
    rows = np.repeat(np.arange(C, dtype=np.int64), nblk)
    bstarts = np.zeros(C, dtype=np.int64)
    np.cumsum(nblk[:-1], out=bstarts[1:])
    blkid = np.arange(total, dtype=np.int64) - bstarts[rows]
    # flat cut points; each reduceat segment ends at the next cut (the next
    # row's first cut == this row's edge count, so no padding mask needed)
    bounds = starts[rows] + blkid * BLOCK_E
    band[rows, 0, blkid] = np.minimum.reduceat(src_blk, bounds)
    band[rows, 1, blkid] = np.maximum.reduceat(src_blk, bounds)
    band[rows, 2, blkid] = np.minimum.reduceat(seg_blk, bounds)
    band[rows, 3, blkid] = np.maximum.reduceat(seg_blk, bounds)
    return band


def edge_rectangles(row_of_src: np.ndarray, col_of_dst: np.ndarray,
                    cols: int) -> np.ndarray:
    """[E] flat rectangle id of each edge on an ``R x cols`` grid.

    Rectangle ``(r, c)`` has flat id ``r*cols + c`` -- the row-major order
    the engine's shard axis uses (one shard per rectangle), chosen so that a
    grid column is the strided set ``c, c+cols, ...`` and a grid row is the
    contiguous run ``r*cols .. r*cols+cols-1``.
    """
    return row_of_src.astype(np.int64) * cols + col_of_dst


def rect_bounds(rect_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """-> (starts, ends) of each rectangle's slice in the rectangle-sorted
    edge order; the half-open slices tile ``[0, E)`` exactly."""
    ends = np.cumsum(rect_counts, dtype=np.int64)
    starts = np.concatenate(([0], ends[:-1]))
    return starts, ends


def band_tiles(band: np.ndarray) -> int:
    """Total in-band tiles (gather + scatter) a fused sweep would visit."""
    width = lambda lo, hi: np.maximum(hi - lo + 1, 0)
    return int(width(band[..., 0, :], band[..., 1, :]).sum()
               + width(band[..., 2, :], band[..., 3, :]).sum())


# ---------------------------------------------------------------------------
# Frontier gating geometry (DESIGN.md section 12)
# ---------------------------------------------------------------------------


def band_source_mask(band: np.ndarray, num_src_blocks: int) -> np.ndarray:
    """-> ``[C, num_src_blocks]`` 0/1 mask: which gather-side source blocks
    each chare/rectangle's edges can read at all.

    The union over edge blocks of the inclusive ``[src_lo, src_hi]`` band
    ranges.  At runtime the engine reduces the live frontier to the same
    BLOCK_V block granularity; a shard whose frontier blocks miss this mask
    entirely can skip its whole phase-1 push (every gathered value is the
    combiner identity), which is the rectangle-skipping test of
    frontier-gated scheduling.  Conservative by construction: block overlap
    without a live in-band vertex only costs a wasted launch, never a
    missed contribution.
    """
    if band.ndim == 2:
        band = band[None]
    lo = band[:, 0, :]  # [C, NB]
    hi = band[:, 1, :]
    s = np.arange(num_src_blocks, dtype=np.int32)  # [nsb]
    covered = (lo[:, :, None] <= s) & (s <= hi[:, :, None])  # [C, NB, nsb]
    return covered.any(axis=1).astype(np.int32)


def frontier_block_mask(frontier: np.ndarray, num_src_blocks: int
                        ) -> np.ndarray:
    """-> ``[num_src_blocks]`` 0/1 mask of BLOCK_V blocks holding any live
    frontier vertex (host-side twin of the engine's on-device reduction,
    used by the benchmark gating model)."""
    K = frontier.shape[0]
    pad = num_src_blocks * BLOCK_V - K
    f = np.pad(frontier.astype(bool), (0, pad)) if pad else \
        frontier.astype(bool)
    return f.reshape(num_src_blocks, BLOCK_V).any(axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Staged-vs-fused dispatch cost (DESIGN.md section 9)
# ---------------------------------------------------------------------------

# The fused kernel wins exactly when band pruning prunes.  Each layout's
# OUTERMOST sort side is narrow by construction (sortdest sorts by segment
# block first, so its scatter bands prune on any graph; the basic layout
# sorts by source block first, so its gather bands do) -- the graph carries
# the signal on the INNER side, where near-uniform graphs make each edge
# block span nearly the whole per-chare tile range and the fused kernel's
# dynamic loop degenerates to the dense grid.  With no pruning, the staged
# dense grid's static schedule pipelines better and the [E] intermediate
# round trip is the only price.  The rule therefore prices the WORSE of the
# two sides, which is layout-agnostic.  Measured on the scale-13 stand-ins
# (both layouts, 1-8 chares): power-law RMAT max-side occupancy 0.08-0.30,
# near-uniform erdos-renyi 0.63-0.97 -- 0.5 splits them with wide margins.
BAND_OCC_FUSED_MAX = 0.5


def dense_grid(emax: int, V: int, S: int, chares: int = 1
               ) -> tuple[int, int]:
    """(gather_tiles, scatter_tiles) of the staged dense grid: every
    (edge-block x vertex-block) and (segment-block x edge-block) tile."""
    ne = num_edge_blocks(emax)
    return chares * ne * (-(-V // BLOCK_V)), chares * (-(-S // BLOCK_S)) * ne


def band_occupancy(band: np.ndarray, emax: int, V: int, S: int) -> dict:
    """Per-side in-band tile counts and occupancies for a band table.

    ``band`` is ``[C, 4, NB]`` (or ``[4, NB]`` for a single row); ``V`` the
    gather-side vertex count per chare, ``S`` the scatter-side segment count.
    ``*_occupancy`` is in-band / dense tiles (1.0 = no pruning at all).
    """
    chares = int(band.shape[0]) if band.ndim == 3 else 1
    dense_g, dense_s = dense_grid(emax, V, S, chares)
    width = lambda lo, hi: int(np.maximum(hi - lo + 1, 0).sum())
    gather = width(band[..., 0, :], band[..., 1, :])
    scatter = width(band[..., 2, :], band[..., 3, :])
    return {
        "gather_tiles": gather,
        "scatter_tiles": scatter,
        "dense_gather_tiles": dense_g,
        "dense_scatter_tiles": dense_s,
        "tiles_fused": gather + scatter,
        "tiles_staged": dense_g + dense_s,
        "gather_occupancy": gather / dense_g if dense_g else 1.0,
        "scatter_occupancy": scatter / dense_s if dense_s else 1.0,
        "tile_occupancy": (gather + scatter) / (dense_g + dense_s)
                          if dense_g + dense_s else 1.0,
    }


def choose_push(band: np.ndarray, emax: int, V: int, S: int
                ) -> tuple[str, dict]:
    """-> ('fused' | 'staged', occupancy dict): the adaptive dispatch rule.

    Fused when the measured bands actually prune on BOTH sides
    (``max_occupancy <= BAND_OCC_FUSED_MAX``), staged when either side
    degenerates toward the dense grid -- which side carries the graph
    signal depends on the layout's sort order, so the rule prices the
    worse one.
    """
    occ = band_occupancy(band, emax, V, S)
    occ["max_occupancy"] = max(occ["gather_occupancy"],
                               occ["scatter_occupancy"])
    choice = ("fused" if occ["max_occupancy"] <= BAND_OCC_FUSED_MAX
              else "staged")
    return choice, occ
