"""Host graph layer of the torch port against the JAX reference.

The port keeps its own numpy copies of ``repro.core.graph``,
``repro.core.partitioners`` and ``repro.kernels.blocks`` (the reference
pulls in JAX on import).  These tests hold every copy to the reference on
the same inputs: generators give identical graphs for the same seed, and
every layout array of a partition -- both edge orders, the band tables,
the per-vertex planes and the relabel maps -- is equal for 4 partitioners x
C in {1, 2, 4, 8}.  They also enforce the package rule: ``repro_torch``
imports neither ``jax`` nor ``repro``.
"""

import functools
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import (ALL_PARTITIONERS, DEGENERATE_GRAPHS, EQUIV_GRAPHS,
                      graph)
from repro.core import graph as RG
from repro.core import partitioners as RP
from repro.kernels import blocks as RB
from repro_torch.core import graph as TG
from repro_torch.core import partitioners as TP
from repro_torch.kernels import blocks as TB

ROOT = pathlib.Path(__file__).resolve().parents[1]
LAYOUT_GRAPHS = tuple(sorted(EQUIV_GRAPHS + ("rmat10",) + DEGENERATE_GRAPHS))
CHARES = (1, 2, 4, 8)

LAYOUT_FIELDS = ("src_local", "dst_global", "edge_weight", "band",
                 "sd_src_local", "sd_dst_global", "sd_edge_weight", "sd_band",
                 "edge_valid", "sd_edge_valid", "vertex_valid", "out_degree",
                 "out_weight", "global_to_local", "local_to_global")


def to_port(g):
    """The reference graph's arrays as a port Graph."""
    return TG.graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                   weight=g.weight, directed=g.directed)


@functools.lru_cache(maxsize=None)
def weighted(gname):
    return RG.random_weights(graph(gname), seed=5)


def assert_graphs_equal(port, ref):
    assert port.num_vertices == ref.num_vertices
    assert port.directed == ref.directed
    np.testing.assert_array_equal(port.indptr, ref.indptr)
    np.testing.assert_array_equal(port.dst, ref.dst)
    assert port.dst.dtype == ref.dst.dtype
    assert (port.weight is None) == (ref.weight is None)
    if ref.weight is not None:
        np.testing.assert_array_equal(port.weight, ref.weight)
        assert port.weight.dtype == ref.weight.dtype


def assert_partitions_equal(tp, rp):
    assert (tp.num_chunks, tp.chunk_size) == (rp.num_chunks, rp.chunk_size)
    for name in LAYOUT_FIELDS:
        got, want = getattr(tp, name), getattr(rp, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# Layouts: every array equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("gname", LAYOUT_GRAPHS)
def test_partition_layouts_equal_reference(gname, partitioner, chares):
    for ref_g in (graph(gname), weighted(gname)):
        rp = RG.partition(ref_g, chares, partitioner=partitioner)
        tp = TG.partition(to_port(ref_g), chares, partitioner=partitioner)
        assert_partitions_equal(tp, rp)
        np.testing.assert_array_equal(tp.plan.order, rp.plan.order)
        np.testing.assert_array_equal(tp.plan.chunk_counts,
                                      rp.plan.chunk_counts)


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
def test_build_pairwise_equals_reference(partitioner, chares):
    """The basic variant's pairwise layout, array for array, on weighted
    graphs with hubs (rmat10), with edgeless vertices and with V % C != 0."""
    for gname in ("rmat10", "isolated_vertices", "ring13"):
        ref_g = weighted(gname)
        rp = RG.partition(ref_g, chares, partitioner=partitioner)
        tp = TG.partition(to_port(ref_g), chares, partitioner=partitioner)
        want, got = RG.build_pairwise(rp), TG.build_pairwise(tp)
        assert got.pair_max == want.pair_max
        for name in ("pb_src_local", "pb_dst_local", "pb_valid",
                     "pb_weight"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{gname}/{name}")


@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
def test_partition_stats_equal_reference(partitioner):
    ref_g = graph("rmat10")
    rp = RG.partition(ref_g, 4, partitioner=partitioner)
    tp = TG.partition(to_port(ref_g), 4, partitioner=partitioner)
    frontier = np.random.default_rng(1).integers(
        0, 2, (tp.num_chunks, tp.chunk_size))
    for kw in ({}, {"frontier": frontier}):
        got = TP.partition_stats(tp, **kw)
        want = RP.partition_stats(rp, **kw)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_lazy_partition_builds_one_layout():
    tp = TG.partition(to_port(graph("rmat6")), 2, eager=False)
    assert tp._lazy == {}
    tp.sd_band
    assert set(tp._lazy) == {"sd"}
    rp = RG.partition(graph("rmat6"), 2)
    np.testing.assert_array_equal(tp.sd_src_local, rp.sd_src_local)
    with pytest.raises(ValueError):
        tp._layout("grid")


def test_sd_layout_is_block_granular_dest_sorted():
    """The sd order is the key (owner, seg block, src block) -- sorted at
    tile granularity, CSR order within a bucket -- as the reference builds
    it, not a full sort by destination."""
    tp = TG.partition(to_port(graph("rmat10")), 2)
    for c in range(tp.num_chunks):
        n = int(tp.edge_valid[c].sum())
        seg = tp.sd_dst_global[c, :n] // TB.BLOCK_S
        src = tp.sd_src_local[c, :n] // TB.BLOCK_V
        key = seg.astype(np.int64) * (1 << 20) + src
        assert np.all(np.diff(key) >= 0)


def test_grid_partitions_not_ported():
    """Grid partitions are built (held to the reference in
    ``tests/test_torch_grid.py``); an unknown partitioner still raises."""
    pg = TG.partition(to_port(graph("rmat6")), 4, partitioner="grid(2,2)")
    assert pg.is_grid and pg.grid_shape == (2, 2)
    with pytest.raises(ValueError):
        TG.partition(to_port(graph("rmat6")), 2, partitioner="nope")


# ---------------------------------------------------------------------------
# Generators and graph transforms: identical output for the same seed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda M: M.ring(12),
    lambda M: M.ring(13, weighted=True, weight_seed=4),
    lambda M: M.two_cliques(10),
    lambda M: M.two_cliques(11, weighted=True),
    lambda M: M.erdos_renyi(200, 900, seed=3),
    lambda M: M.erdos_renyi(64, 300, seed=1, weighted=True),
    lambda M: M.rmat(6, 300, seed=2),
    lambda M: M.rmat(10, 4000, seed=3, weighted=True),
    lambda M: M.load_dataset("soc-lj1-mini", scale_log2=9),
    lambda M: M.load_dataset("twitter-mini", scale_log2=8, seed=4),
    lambda M: M.random_weights(M.rmat(7, 500, seed=1), seed=9, low=2.0,
                               high=3.0),
    lambda M: M.rmat(7, 600, seed=5).to_undirected(),
    lambda M: M.random_weights(M.rmat(7, 600, seed=5), seed=1)
    .to_undirected(),
    lambda M: M.from_edges(5, np.array([3, 1, 3, 0]), np.array([1, 2, 0, 4]),
                           weight=np.array([1.5, 2.5, 3.5, 4.5])),
], ids=["ring", "ring_w", "cliques", "cliques_w", "er", "er_w", "rmat6",
        "rmat10_w", "soc-lj1", "twitter", "random_weights", "undirected",
        "undirected_w", "from_edges"])
def test_generators_identical(make):
    assert_graphs_equal(make(TG), make(RG))


@pytest.mark.parametrize("gname", DEGENERATE_GRAPHS)
def test_to_undirected_degenerate_equals_reference(gname):
    """Graphs with no edges or with edgeless vertices symmetrize as the
    reference's do, unweighted and weighted."""
    for ref_g in (graph(gname), weighted(gname)):
        assert_graphs_equal(to_port(ref_g).to_undirected(),
                            ref_g.to_undirected())


def test_dataset_registry_equal():
    assert TG.dataset_names() == RG.dataset_names()
    assert TG._DATASETS == RG._DATASETS


def test_graph_properties_equal():
    ref_g = weighted("rmat6")
    g = to_port(ref_g)
    np.testing.assert_array_equal(g.src, ref_g.src)
    np.testing.assert_array_equal(g.out_degrees, ref_g.out_degrees)
    np.testing.assert_array_equal(g.edge_weights, ref_g.edge_weights)
    assert g.num_edges == ref_g.num_edges


@pytest.mark.parametrize("partitioner", ["contiguous", "degree_sorted",
                                         "grid(2,2)"])
def test_padded_vertices_and_chunk_of_equal_reference(partitioner):
    ref_g = graph("rmat10")
    rp = RG.partition(ref_g, 4, partitioner=partitioner)
    tp = TG.partition(to_port(ref_g), 4, partitioner=partitioner)
    assert tp.padded_vertices == rp.padded_vertices
    v = np.arange(rp.padded_vertices)
    np.testing.assert_array_equal(tp.chunk_of(v), rp.chunk_of(v))
    # an original id goes through global_to_local first
    g2l = tp.global_to_local
    np.testing.assert_array_equal(tp.chunk_of(g2l), rp.chunk_of(g2l))


def test_row_plan_of_exported_and_equal_reference():
    from repro.core import row_plan_of as r_row_plan_of
    from repro_torch.core import row_plan_of

    ref_g = weighted("rmat10")
    for partitioner in ("contiguous", "edge_balanced", "grid(2,4)"):
        rp = RG.partition(ref_g, 8, partitioner=partitioner)
        tp = TG.partition(to_port(ref_g), 8, partitioner=partitioner)
        want, got = r_row_plan_of(rp.plan), row_plan_of(tp.plan)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_array_equal(got.chunk_counts, want.chunk_counts)
        assert got.chunk_size == want.chunk_size
        assert (got is tp.plan) == (want is rp.plan)


def test_graph_from_reference_round_trips():
    for ref_g in (graph("rmat10"), weighted("two_cliques10"),
                  graph("single_vertex")):
        g = to_port(ref_g)
        assert_graphs_equal(g, ref_g)
        back = RG.Graph(g.num_vertices, g.indptr, g.dst, g.directed,
                        g.weight)
        assert_graphs_equal(to_port(back), ref_g)
    with pytest.raises(ValueError):
        TG.graph_from_reference(3, np.array([0, 1]), np.array([0]))


# ---------------------------------------------------------------------------
# Tile geometry and band helpers (the numpy copy of repro.kernels.blocks)
# ---------------------------------------------------------------------------


def test_blocks_constants_equal():
    assert (TB.BLOCK_E, TB.BLOCK_V, TB.BLOCK_S) == \
        (RB.BLOCK_E, RB.BLOCK_V, RB.BLOCK_S)
    assert TB.BAND_OCC_FUSED_MAX == RB.BAND_OCC_FUSED_MAX


@pytest.mark.parametrize("chares", (1, 4))
def test_band_helpers_equal(chares):
    rp = RG.partition(graph("rmat10"), chares)
    for band, src, dst in ((rp.band, rp.src_local, rp.dst_global),
                           (rp.sd_band, rp.sd_src_local, rp.sd_dst_global)):
        np.testing.assert_array_equal(
            TB.edge_bands(src, dst, rp.edge_valid),
            RB.edge_bands(src, dst, rp.edge_valid))
        emax, K = rp.edge_valid.shape[1], rp.chunk_size
        assert TB.choose_push(band, emax, K, chares * K) == \
            RB.choose_push(band, emax, K, chares * K)
        assert TB.band_tiles(band) == RB.band_tiles(band)
        np.testing.assert_array_equal(TB.band_source_mask(band, 4),
                                      RB.band_source_mask(band, 4))


# ---------------------------------------------------------------------------
# Device upload
# ---------------------------------------------------------------------------


def test_device_arrays_cpu():
    tp = TG.partition(to_port(weighted("rmat10")), 2)
    arrs = tp.device_arrays("sd", "cpu")
    assert arrs is tp.device_arrays("sd", torch.device("cpu"))  # cached
    width = TB.num_edge_blocks(tp.edge_valid.shape[1]) * TB.BLOCK_E
    emax = tp.edge_valid.shape[1]
    for name in ("sd_src_local", "sd_dst_global", "sd_edge_valid",
                 "sd_edge_weight"):
        t = arrs[name]
        assert t.device.type == "cpu" and tuple(t.shape) == (2, width)
        host = getattr(tp, name)
        assert t.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[host.dtype]
        np.testing.assert_array_equal(t[:, :emax].numpy(), host)
    # padding edges are invalid, weight 1
    assert int(arrs["sd_edge_valid"][:, emax:].sum()) == 0
    assert bool((arrs["sd_edge_weight"][:, emax:] == 1).all())
    np.testing.assert_array_equal(arrs["sd_band"].numpy(), tp.sd_band)
    both = tp.device_arrays("both", "cpu")
    assert set(both) >= {"band", "sd_band", "src_local"}
    aux = tp.device_aux("cpu")
    np.testing.assert_array_equal(aux["out_weight"].numpy(), tp.out_weight)
    assert aux["out_degree"].dtype == torch.int32


def test_device_pairwise_cpu():
    tp = TG.partition(to_port(weighted("rmat10")), 4)
    arrs = tp.device_pairwise("cpu")
    assert arrs is tp.device_pairwise(torch.device("cpu"))  # cached
    pw = TG.build_pairwise(tp)
    recv = arrs["pb_recv_dst"]
    for name, t in arrs.items():
        assert t.device.type == "cpu"
        if name != "pb_recv_dst":
            np.testing.assert_array_equal(t.numpy(), getattr(pw, name))
    assert int(arrs["pb_valid"].sum()) == tp.graph.num_edges
    # receiver-major segment ids: row k is every sender's row [c, k]
    assert recv.is_contiguous() and recv.shape == (4, 4 * pw.pair_max)
    np.testing.assert_array_equal(
        recv.numpy(), pw.pb_dst_local.transpose(1, 0, 2).reshape(4, -1))


# ---------------------------------------------------------------------------
# Package rule: no JAX, no reference package
# ---------------------------------------------------------------------------


def test_import_leaves_jax_and_repro_out():
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.ops, repro_torch.kernels.push_fused, "
            "repro_torch.kernels.push_staged, repro_torch.kernels._build, "
            "repro_torch.core.cost, repro_torch.quickstart, "
            "repro_torch.configs, repro_torch.configs.graphs, "
            "repro_torch.launch.serve, repro_torch.benchmarks.run, "
            "repro_torch.benchmarks.tables, "
            "repro_torch.benchmarks.graphx_analogue, "
            "repro_torch.checkpoint, repro_torch.models, "
            "repro_torch.models.config, repro_torch.models.layers, "
            "repro_torch.models.frontends, repro_torch.models.model, "
            "repro_torch.models.serve, repro_torch.configs.gemma3_1b, "
            "repro_torch.configs.jamba_1_5_large_398b, "
            "repro_torch.models.sharding, repro_torch.models.train, "
            "repro_torch.optim, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.launch.elastic, "
            "repro_torch.launch.mesh\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "print(repr(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro|benchmarks)\b(?!_)|"
                        r"from\s+(jax|repro|benchmarks)\b(?!_))",
                        re.MULTILINE)


def test_source_scan_finds_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        text = path.read_text()
        hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
        assert not hits, f"{path}: {hits}"
    # the scan itself catches what it should and spares the port's own name
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from repro.core import graph")
    assert _FORBIDDEN.search("import repro")
    assert not _FORBIDDEN.search("from repro_torch.core import graph")
    assert not _FORBIDDEN.search("import repro_torch")
    # nor the top-level benchmarks package, which imports repro
    assert _FORBIDDEN.search("from benchmarks import tables")
    assert _FORBIDDEN.search("import benchmarks.tables as rtables")
    assert _FORBIDDEN.search("from benchmarks.graphx_analogue import bench")
    assert _FORBIDDEN.search("from benchmarks import graphx_analogue")
    assert not _FORBIDDEN.search("from repro_torch.benchmarks import run")
    assert not _FORBIDDEN.search(
        "from repro_torch.benchmarks.graphx_analogue import bench")
