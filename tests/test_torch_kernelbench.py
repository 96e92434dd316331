"""The graph kernels' cost model on the card (``repro_torch.benchmarks.
kernelbench``) against the reference's ``benchmarks/kernelbench.py``.

The layout facts -- the staged dense grid's tiles, the fused band's tiles,
their ratio and occupancy, the ``choose_push`` dispatch -- must equal the
reference's on the same partitions (RMAT and Erdos-Renyi, 8 chares, scale
10-12).  The time model is the card's: its bytes must follow the kernel
table's formula (PERF.md section 6), counted here from the layout arrays
themselves; ``validate`` holds both push paths to the plain oracle on the
CPU (the kernels' plain versions).
"""

import functools
import math

import numpy as np
import pytest

from benchmarks import kernelbench as RK
from repro.core import graph as RG
from repro.core import partition as rpartition
from repro_torch.benchmarks import kernelbench as TK
from repro_torch.core import graph as TG
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32

CASES = (("rmat", 10), ("rmat", 12), ("er", 11))


@functools.lru_cache(maxsize=None)
def partitions(kind, scale, chares=8, weighted=False, partitioner=None):
    """(reference partition, port partition) of one graph: the port's
    graph is the reference's CSR arrays as they are."""
    if kind == "rmat":
        g = RG.load_dataset("soc-lj1-mini", scale_log2=scale,
                            weighted=weighted)
    else:
        g = RG.erdos_renyi(1 << scale, 2 * (1 << scale), seed=1,
                           weighted=weighted)
    tg = TG.graph_from_reference(g.num_vertices, np.asarray(g.indptr),
                                 np.asarray(g.dst), None if g.weight is None
                                 else np.asarray(g.weight))
    kw = {} if partitioner is None else {"partitioner": partitioner}
    return (rpartition(g, chares, **kw), TG.partition(tg, chares, **kw))


@pytest.mark.parametrize("layout", ("sd", "basic"))
@pytest.mark.parametrize("kind,scale", CASES)
def test_layout_facts_equal_reference(kind, scale, layout):
    rp, tp = partitions(kind, scale)
    want = RK.layout_cost_model(rp, layout)
    got = TK.layout_cost_model(tp, layout)
    for path in ("staged", "fused"):
        assert got[path]["tiles"] == want[path]["tiles"], path
    assert got["tile_ratio"] == want["tile_ratio"]
    assert got["tile_occupancy"] == want["tile_occupancy"]
    assert got["dispatch"] == want["dispatch"]
    assert got["fused"]["launches"] == TK.LAUNCHES["fused"] == 2
    assert got["staged"]["launches"] == TK.LAUNCHES["staged"] == 3


def _table_formula(band, valid, V, S, B=1, weighted=False):
    """PERF.md section 6's fused bytes and operations, counted from the
    arrays: 16 B per band column, (12 B, or 16 B with weights) x 256 per
    non-empty edge block, 4 B x (V + S) x B per row; two operations per
    valid edge and column."""
    C, _, nb = band.shape
    live = sum(1 for c in range(C) for j in range(nb) if band[c, 1, j] >= 0)
    nbytes = 16 * C * nb + live * 256 * (16 if weighted else 12) \
        + 4 * (V + S) * B * C
    return nbytes, 2 * valid * B


@pytest.mark.parametrize("kind,scale", CASES)
def test_card_bytes_follow_the_kernel_table(kind, scale):
    _, tp = partitions(kind, scale)
    band = np.asarray(tp.sd_band)
    C, E, K = tp.num_chunks, tp.edge_valid.shape[1], tp.chunk_size
    S = C * K
    valid = int(np.asarray(tp.edge_valid).sum())
    cm = TK.layout_cost_model(tp)
    nbytes, opers = _table_formula(band, valid, K, S)
    fused = cm["fused"]
    assert (fused["hbm_bytes"], fused["flops"]) == (nbytes, opers)
    assert fused["hbm_s"] == nbytes / HBM_BW
    assert fused["compute_s"] == opers / PEAK_FLOPS_F32
    assert fused["bound"] == "memory"
    # the staged pair: gather (8 B an edge + 4 B an edge written + 4 B a
    # vertex) and scatter (4 B an edge + 4 B an edge read + 4 B a segment)
    staged = cm["staged"]
    assert staged["hbm_bytes"] == C * (12 * E + 4 * K + 8 * E + 4 * S)
    assert staged["flops"] == valid
    for B in (1, 4, 16):
        for weighted in (False, True):
            assert TK.fused_bytes(band, K, S, B, weighted) == _table_formula(
                band, valid, K, S, B, weighted)[0]
    assert TK.gather_bytes(E, K, 4) == 8 * E + 16 * E + 16 * K
    assert TK.scatter_bytes(E, K, 4) == 4 * E + 16 * E + 16 * K
    assert TK.bound_s(nbytes, opers) == max(nbytes / HBM_BW,
                                            opers / PEAK_FLOPS_F32)


def test_kernel_cost_model_without_a_band_is_the_dense_grid():
    """No band: every edge block live, the fused tiles the dense grid's
    (the reference's worst case), the weighted planes 16 B an edge."""
    want = RK.kernel_cost_model(E=4096, V=1024, S=2048, chares=2,
                                weighted=True)
    got = TK.kernel_cost_model(E=4096, V=1024, S=2048, chares=2,
                               weighted=True)
    for path in ("staged", "fused"):
        assert got[path]["tiles"] == want[path]["tiles"]
    assert got["tile_occupancy"] == want["tile_occupancy"] == 1.0
    assert got["fused"]["hbm_bytes"] == 16 * 2 * 16 + 2 * 16 * 256 * 16 \
        + 4 * (1024 + 2048) * 2
    assert got["fused"]["flops"] == 2 * 2 * 4096
    assert got["staged"]["flops"] == 2 * 2 * 4096
    assert set(got["fused"]) == {"tiles", "launches", "flops", "hbm_bytes",
                                 "compute_s", "hbm_s", "bound"}


@pytest.mark.parametrize("kind,scale", CASES[:2])
def test_batched_models_on_the_card(kind, scale):
    rp, tp = partitions(kind, scale)
    band = np.asarray(tp.sd_band)
    C, K = tp.num_chunks, tp.chunk_size
    valid = int(np.asarray(tp.edge_valid).sum())
    edge, _ = _table_formula(band, valid, 0, 0)
    vert = 4 * (K + C * K) * C
    t = lambda b, extra=0: max((edge + (vert + extra) * b) / HBM_BW,
                               2 * valid * b / PEAK_FLOPS_F32)
    bm = TK.batched_cost_model(tp, 16)
    want = RK.batched_cost_model(rp, 16)
    assert bm["tiles_per_query_seq"] == want["tiles_per_query_seq"]
    assert bm["tiles_per_query_batched"] == want["tiles_per_query_batched"]
    assert bm["seq_s_per_query"] == t(1)
    assert bm["batched_s_per_query"] == t(16) / 16
    assert bm["speedup"] == pytest.approx(t(1) / (t(16) / 16), rel=1e-12)
    assert bm["speedup"] > 1
    fm = TK.fixediter_cost_model(tp, 16, iters=8)
    mask = C * C * K * 4
    assert fm["seq_s_per_query"] == 8 * t(1, mask)
    assert fm["batched_s_per_query"] == 8 * t(16) / 16
    assert set(fm) == set(RK.fixediter_cost_model(rp, 16, iters=8))


@pytest.mark.parametrize("batch", (1, 16))
def test_streaming_model_on_the_card(batch):
    rg = RG.load_dataset("soc-lj1-mini", scale_log2=11, weighted=True)
    rp = rpartition(rg, 1, "grid(1,1)")
    tp = TG.partition(TG.graph_from_reference(
        rg.num_vertices, np.asarray(rg.indptr), np.asarray(rg.dst),
        np.asarray(rg.weight)), 1, "grid(1,1)")
    got = TK.streaming_cost_model(tp, windows=4, batch=batch)
    want = RK.streaming_cost_model(rp, windows=4, batch=batch)
    for key in ("windows", "batch", "window_bytes", "total_edge_bytes",
                "edge_bytes_per_query"):
        assert got[key] == want[key], key
    assert got["copy_s"] == pytest.approx(
        got["total_edge_bytes"] / TK.HOST_LINK_BW, rel=1e-12)
    valid = int(np.asarray(tp.gr_edge_valid).sum())
    assert got["intensity_flops_per_byte"] == \
        2 * valid / got["total_edge_bytes"]
    assert got["crossover_intensity"] == PEAK_FLOPS_F32 / TK.HOST_LINK_BW
    assert got["crossover_batch"] == math.ceil(
        got["crossover_intensity"] / got["intensity_flops_per_byte"])
    assert got["bound"] == "copy"  # the H100's HBM outruns PCIe ~50x
    assert got["pipelined_superstep_s"] <= got["serialized_superstep_s"]


@pytest.mark.parametrize("fused", (True, False))
def test_validate_passes_on_the_plain_versions(fused):
    assert TK.validate(fused=fused, device="cpu") < 1e-4


def test_bench_ref_times_the_plain_push():
    t, E = TK.bench_ref(E=1 << 12, V=1 << 10, repeats=2, device="cpu")
    assert E == 1 << 12 and 0 < t < 5


def test_entry_points_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        assert TK.validate() < 1e-4
    else:
        with pytest.raises(RuntimeError):
            TK.validate()
