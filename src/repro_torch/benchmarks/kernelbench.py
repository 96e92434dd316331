"""Kernel micro-benchmarks and the graph kernels' cost model on the card.

The port of ``benchmarks/kernelbench.py``.  The reference models its
Pallas kernels on a TPU (one-hot MXU tiles at 197 TFLOP/s, 819 GB/s); the
port's kernels gather and scatter natively on the H100, so the time model
is the card's, the one ``PERF.md`` section 6's kernel table states and
``chip_smoke.py`` bounds every kernel with:

    fused    16 B per band column (the [4, NB] table), the edge planes of
             every non-empty edge block (src, dst, valid: 12 B an edge; 16 B
             with a weight plane; 256 edges a block), vals read once and out
             written once (4 B x (V + S) x B per chare)
    gather   8 B an edge (src, valid), 4 B an edge and column written, 4 B a
             vertex and column read
    scatter  4 B an edge (dst), 4 B an edge and column read, 4 B a segment
             and column written
    time     max(bytes / HBM_BW, operations / PEAK_FLOPS_F32): one transform
             and one combine per valid edge and column (fused), one combine
             (scatter), with the H100's constants (``launch/mesh.py``)

The layout facts stay as the reference computes them: tile counts of the
staged dense grid and of the fused band (``tiles``, ``tile_ratio``,
``tile_occupancy``) and the ``choose_push`` dispatch.  ``LAUNCHES`` counts
the port's launches per push.

Renamed from the reference (the TPU's words):
    kernel_cost_model()[path]["mxu_s"]   -> ["compute_s"]
    row kernel.push.tpu_model_{path}     -> kernel.push.card_model_{path}
    streaming_cost_model: MXU_FLOPS      -> PEAK_FLOPS_F32 (the card's
                                            float32 rate), HOST_LINK_BW the
                                            card's PCIe 5.0 x16 link
``flops`` keeps its key and now counts the card's operations.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.blocks import (BLOCK_E, band_tiles, choose_push,
                                        dense_grid, num_edge_blocks)
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32

# launches per push: staged = gather kernel + the weight transform (a torch
# elementwise kernel) + scatter kernel; fused = the tiled add's tile pass
# and merge pass (PageRank's path on the seg-sorted layout); the fused min,
# and the atomic add off seg-sorted rows, launch once
LAUNCHES = {"staged": 3, "fused": 2, "fused_min": 1}

# host -> device link for the streamed windows: PCIe 5.0 x16 at its data
# sheet rate, one direction (PERF.md section 5 measured 47 GB/s H2D)
HOST_LINK_BW = 64e9
MEASURED_H2D_BW = 47e9


# ---------------------------------------------------------------------------
# The card's bytes and operations per call
# ---------------------------------------------------------------------------


def fused_bytes(band, V: int, S: int, B: int = 1,
                weighted: bool = False) -> int:
    """Bytes one fused call must move over ``band`` (``[C, 4, NB]`` or
    ``[4, NB]``, numpy or torch): the band table, the edge planes of its
    non-empty blocks (row 1, ``src_hi``, >= 0), vals and out once each;
    ``V``/``S`` per chare."""
    chares = band.shape[0] if len(band.shape) == 3 else 1
    live = int((band[..., 1, :] >= 0).sum())
    return (4 * math.prod(band.shape) + live * BLOCK_E * (16 if weighted
                                                          else 12)
            + 4 * (V + S) * B * chares)


def fused_operations(valid_edges: int, B: int = 1) -> int:
    """One transform and one combine per valid edge and column."""
    return 2 * valid_edges * B


def gather_bytes(E: int, V: int, B: int = 1) -> int:
    return 8 * E + 4 * E * B + 4 * V * B


def scatter_bytes(E: int, S: int, B: int = 1) -> int:
    return 4 * E + 4 * E * B + 4 * S * B


def scatter_operations(E: int, B: int = 1) -> int:
    return E * B


def bound_s(nbytes: float, operations: float = 0) -> float:
    """The least time the card takes: bytes over HBM or operations over the
    float32 rate, whichever is larger."""
    return max(nbytes / HBM_BW, operations / PEAK_FLOPS_F32)


def _model(operations, nbytes):
    compute_s, hbm_s = operations / PEAK_FLOPS_F32, nbytes / HBM_BW
    return {"flops": operations, "hbm_bytes": nbytes, "compute_s": compute_s,
            "hbm_s": hbm_s,
            "bound": "memory" if hbm_s > compute_s else "compute"}


# ---------------------------------------------------------------------------
# The reference's models, on the card
# ---------------------------------------------------------------------------


def bench_ref(E=1 << 16, V=1 << 14, repeats=5, seed=0, device=None):
    """Best seconds of the plain push (``kernels/ref.py``, the oracle the
    kernels are held to) on ``E`` random edges; on CUDA unless ``device``
    names another.  -> (seconds, E)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.integers(0, V, E), dtype=torch.int32,
                          device=device)
    dst = torch.as_tensor(rng.integers(0, V, E), dtype=torch.int32,
                          device=device)
    valid = torch.ones(E, dtype=torch.int32, device=device)
    vals = torch.as_tensor(rng.normal(size=V), dtype=torch.float32,
                           device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else lambda: None
    ref.push_ref(vals, src, dst, valid, V)
    sync()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        ref.push_ref(vals, src, dst, valid, V)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best, E


def kernel_cost_model(E=1 << 16, V=1 << 14, S=None, band=None, chares=1,
                      weighted=False, valid_edges=None):
    """The card's cost of one push superstep, staged vs fused.

    ``E`` is the (padded) edge count per chare, ``V`` the gather-side vertex
    count per chare, ``S`` the scatter-side segment count (defaults to
    ``V``), ``chares`` the number of per-chare rows, ``weighted`` whether a
    per-edge weight plane rides along, ``valid_edges`` the valid edges of
    all rows (default: every slot).  ``band`` (``[chares, 4, NB]``) gives
    the fused call's non-empty blocks and its tiles; without it every
    block is live and the fused tiles are the dense grid's.

    Bytes: the fused call as the module docstring states; the staged pair
    a gather and a scatter per row, with the weight transform's read of
    the gathered values and the weights and its write (12 B an edge)
    between them when ``weighted``.  Operations: the fused call's
    transform and combine per valid edge; the staged pair's combine, and
    its transform when ``weighted``.  Tiles are layout facts, as the
    reference counts them.
    """
    if S is None:
        S = V
    ne = num_edge_blocks(E)
    valid_edges = chares * E if valid_edges is None else valid_edges
    dense_tiles = sum(dense_grid(E, V, S, chares))
    if band is None:
        band = np.zeros((chares, 4, ne), np.int32)  # every block live
        fused_tiles = dense_tiles
    else:
        band = np.asarray(band)
        fused_tiles = band_tiles(band)
    fused_b = fused_bytes(band.reshape(chares, 4, -1), V, S, 1, weighted)
    staged_b = chares * (gather_bytes(E, V) + scatter_bytes(E, S)
                         + (12 * E if weighted else 0))
    staged_ops = valid_edges * (2 if weighted else 1)
    return {
        "staged": {"tiles": dense_tiles, "launches": LAUNCHES["staged"],
                   **_model(staged_ops, staged_b)},
        "fused": {"tiles": fused_tiles, "launches": LAUNCHES["fused"],
                  **_model(fused_operations(valid_edges), fused_b)},
        "tile_ratio": dense_tiles / max(fused_tiles, 1),
        "tile_occupancy": fused_tiles / dense_tiles,
    }


def _layout(pg, layout):
    band = np.asarray(pg.sd_band if layout == "sd" else pg.band)
    E, V, S = (pg.edge_valid.shape[1], pg.chunk_size,
               pg.num_chunks * pg.chunk_size)
    return band, E, V, S, int(np.asarray(pg.edge_valid).sum())


def layout_cost_model(pg, layout="sd"):
    """``kernel_cost_model`` fed by a real partition: its band table and
    valid edges, one fused sweep per chare per superstep.  ``dispatch``
    reports what ``Engine(push_fn='auto')`` would pick for this layout (the
    adaptive staged-vs-fused rule, ``blocks.choose_push``)."""
    band, E, V, S, valid = _layout(pg, layout)
    cm = kernel_cost_model(E=E, V=V, S=S, band=band, chares=pg.num_chunks,
                           valid_edges=valid)
    choice, occ = choose_push(band, E, V, S)
    cm["dispatch"] = {"choice": choice, "layout": layout, **occ}
    return cm


def _plane(pg, layout, weighted):
    """(edge bytes, vertex bytes per column, operations per column, tiles)
    of one fused superstep over ``pg``'s layout."""
    band, E, V, S, valid = _layout(pg, layout)
    vert = fused_bytes(band, V, S, 1, weighted)
    edge = fused_bytes(band, 0, 0, 1, weighted)
    return edge, vert - edge, fused_operations(valid), band_tiles(band)


def batched_cost_model(pg, B, layout="sd", weighted=False):
    """The card's throughput of the batched [*, B] plane against a
    per-query loop (DESIGN.md section 11).

    One batched superstep streams the edge layout (planes of the
    non-empty blocks, band table) ONCE for all B query columns, while the
    vertex-state bytes and the operations scale with B.  The sequential
    baseline pays the full edge stream B times.

        t(b) = max((edge_bytes + vert_bytes*b) / HBM_BW,
                   operations * b / PEAK_FLOPS_F32)
        speedup = t(1) / (t(B) / B)

    Tiles per query are the reference's layout facts.
    """
    edge, vert, opers, tiles = _plane(pg, layout, weighted)
    t = lambda b: max((edge + vert * b) / HBM_BW, opers * b / PEAK_FLOPS_F32)
    seq_s, batched_s = t(1), t(B) / B
    return {
        "B": B,
        "tiles_per_query_seq": tiles,
        "tiles_per_query_batched": tiles / B,
        "seq_s_per_query": seq_s,
        "batched_s_per_query": batched_s,
        "queries_per_sec_seq": 1.0 / seq_s,
        "queries_per_sec_batched": 1.0 / batched_s,
        "speedup": seq_s / batched_s,
    }


def fixediter_cost_model(pg, B, iters=20, layout="sd", weighted=False):
    """Amortization model for the FIXED-ITERATION batched plane
    (personalized PageRank et al., DESIGN.md section 14): the per-superstep
    roofline of ``batched_cost_model`` times exactly ``iters`` supersteps.
    The sequential side also pays a frontier plane per superstep
    (``mask_bytes``, 4 B a segment) through its B separate loops; the
    counted batched loop drops it."""
    edge, vert, opers, _ = _plane(pg, layout, weighted)
    mask_bytes = pg.num_chunks * pg.num_chunks * pg.chunk_size * 4

    def t(b, masked):
        hbm = (edge + vert * b + (mask_bytes * b if masked else 0)) / HBM_BW
        return iters * max(hbm, opers * b / PEAK_FLOPS_F32)

    seq_s, batched_s = t(1, masked=True), t(B, masked=False) / B
    return {
        "B": B, "iters": iters,
        "seq_s_per_query": seq_s,
        "batched_s_per_query": batched_s,
        "queries_per_sec_seq": 1.0 / seq_s,
        "queries_per_sec_batched": 1.0 / batched_s,
        "speedup": seq_s / batched_s,
    }


def streaming_cost_model(pg, windows=8, batch=1):
    """Bandwidth/compute roofline of the double-buffered window schedule
    (DESIGN.md section 13) on the card: is each window's host-to-device
    copy hidden behind the previous window's fused sweep?

        t_pipe   = copy[0] + sum_k max(compute[k], copy[k+1]) + compute[-1]
        t_serial = sum(copy) + sum(compute)

    with copy = window_bytes / HOST_LINK_BW (the window's four edge planes
    and band columns) and compute = max(operations * batch /
    PEAK_FLOPS_F32, window_bytes / HBM_BW), operations = 2 per valid edge
    of the window.  ``crossover_intensity`` is the operations per byte a
    window must sustain for compute to hide its own copy, beside the
    layout's; ``crossover_batch`` the smallest B that clears it (the copy
    is unchanged by B, the compute scales with it)."""
    band = np.asarray(pg.gr_band)            # [P, 4, nb]
    valid = np.asarray(pg.gr_edge_valid).reshape(band.shape[0], -1)
    P, _, nb = band.shape
    nbw = max(-(-nb // windows), 1)
    per_block = P * BLOCK_E * 16 + P * 4 * 4  # src/dst/valid/weight + band
    copy, comp, total_ops = [], [], 0
    for k in range(0, nb, nbw):
        blo, bhi = k, min(nb, k + nbw)
        wbytes = (bhi - blo) * per_block
        opers = fused_operations(
            int(valid[:, blo * BLOCK_E:bhi * BLOCK_E].sum()))
        total_ops += opers
        copy.append(wbytes / HOST_LINK_BW)
        comp.append(max(opers * batch / PEAK_FLOPS_F32, wbytes / HBM_BW))
    t_serial = sum(copy) + sum(comp)
    t_pipe = copy[0] + sum(max(comp[i], copy[i + 1])
                           for i in range(len(copy) - 1)) + comp[-1]
    total_bytes = nb * per_block
    intensity = total_ops / total_bytes
    crossover = PEAK_FLOPS_F32 / HOST_LINK_BW
    return {
        "windows": len(copy),
        "batch": batch,
        "window_bytes": nbw * per_block,
        "total_edge_bytes": total_bytes,
        "edge_bytes_per_query": total_bytes / batch,
        "copy_s": sum(copy),
        "compute_s": sum(comp),
        "pipelined_superstep_s": t_pipe,
        "serialized_superstep_s": t_serial,
        "hiding": 1.0 - t_pipe / t_serial if t_serial else 0.0,
        "bound": "copy" if sum(copy) > sum(comp) else "compute",
        "intensity_flops_per_byte": intensity,
        "crossover_intensity": crossover,
        "crossover_batch": int(max(1, math.ceil(crossover / intensity)))
        if intensity else 1,
        "host_link_bw": HOST_LINK_BW,
        "measured_h2d_bw": MEASURED_H2D_BW,
    }


def validate(E=4096, V=2048, seed=1, fused=True, device=None):
    """Max |err| of one push path (``ops.push``: the kernels on CUDA, their
    plain versions on the CPU) against the plain oracle (``ref.push_ref``),
    add and min; on CUDA unless ``device`` names another."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    src = t(rng.integers(0, V, E), torch.int32)
    dst = t(rng.integers(0, V, E), torch.int32)
    valid = t(rng.integers(0, 2, E), torch.int32)
    vals = t(rng.normal(size=V), torch.float32)
    got = ops.push(vals, src, dst, valid, V, combine="add", fused=fused)
    want = ref.push_ref(vals, src, dst, valid, V, combine="add")
    add_err = float((got - want).abs().max())
    ivals = t(rng.integers(0, 10_000, V), torch.int32)
    got = ops.push(ivals, src, dst, valid, V, combine="min", fused=fused)
    want = ref.push_ref(ivals, src, dst, valid, V, combine="min")
    min_err = float((got - want).abs().max())
    return max(add_err, min_err)
