"""The port's batched query plane (``Engine.run_batch``) on the CPU.

The twins of the reference's plane cells (``tests/test_batch.py`` and the
PPR cells of ``tests/test_graph_serve.py``) at the same small sizes, with
the port on the CPU (its kernels' plain versions):

* every sssp/bfs column bit-equal to the serial reference, with the same
  per-query superstep count, over 4 strategies x B in {1, 4, 16} x
  {contiguous, degree_sorted};
* personalized PageRank within 1e-6 of its sequential runs and 1e-5 of
  ``personalized_pagerank_serial``; betweenness within 1e-9 of
  ``betweenness_serial``;
* the chare axis at C in {2, 8} against the serial references;
* against ``repro`` itself on a subset (the reference compiles each plane
  width): its ``run_batch`` planes at B=4 on sortdest and basic, its
  ``init_batch`` / ``_teleport_plane`` arrays, ``_ppr_normalize``,
  ``_betweenness_from_depths`` and ``betweenness_ref``.
"""

import functools

import numpy as np
import pytest
import torch

from conftest import ALL_STRATEGIES, graph, program_graph
from repro.core import Engine as REngine
from repro.core import graph as RG
from repro.core import programs as RPROG
from repro.kernels import ref as rref
from repro_torch.core import Engine, get_spec, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import programs as TPROG
from repro_torch.kernels import ref as tref

BATCH_PARTITIONERS = ("contiguous", "degree_sorted")
SEED_SETS = [(0,), (7, 61), (3, 5, 40)]  # rmat6: 64 vertices


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


@functools.lru_cache(maxsize=None)
def port_graph(algo, gname):
    return to_port(program_graph(algo, gname))


def engine(algo, gname="rmat6", chares=1, partitioner="contiguous",
           strategy="sortdest"):
    pg = TG.partition(port_graph(algo, gname), chares,
                      partitioner=partitioner)
    return Engine(pg, strategy=strategy, device="cpu")


def _sources(num_vertices, n, seed):
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.integers(0, num_vertices, n)]


# ---------------------------------------------------------------------------
# Batched == sequential, bit for bit, column by column
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partitioner", BATCH_PARTITIONERS)
@pytest.mark.parametrize("B", [1, 4, 16])
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_batched_matches_sequential(algo, strategy, B, partitioner):
    """Every column of the plane equals its own serial run (values AND
    superstep count), with a ragged query count (n < B) so the padding
    columns are exercised and dropped."""
    rg = program_graph(algo, "rmat6")
    n = max(1, B - 1)
    sources = _sources(rg.num_vertices, n, seed=B)
    eng = engine(algo, partitioner=partitioner, strategy=strategy)
    plane, iters = eng.run_batch(algo, sources=sources, batch=B)
    assert plane.shape == (n, rg.num_vertices)
    assert iters.dtype == np.int64
    for i, s in enumerate(sources):
        want, want_it = RPROG.get_spec(algo).serial(rg, source=s)
        np.testing.assert_array_equal(plane[i], want, err_msg=f"query {i}")
        assert plane[i].dtype == want.dtype
        assert int(iters[i]) == want_it, f"query {i} iters"


def test_seed_set_column_is_elementwise_min():
    eng = engine("bfs")
    seeds = (3, 17, 40)
    plane, _ = eng.run_batch("bfs", sources=[seeds])
    singles, _ = eng.run_batch("bfs", sources=list(seeds))
    np.testing.assert_array_equal(plane[0], singles.min(axis=0))


def test_per_query_convergence_masking():
    """A query seeded at an edgeless vertex converges in one superstep while
    its batch-mate keeps running; each count equals the sequential one."""
    rg = graph("isolated_vertices")
    eng = Engine(TG.partition(to_port(rg), 1), device="cpu")
    plane, iters = eng.run_batch("bfs", sources=[0, 4], batch=4)
    for i, s in enumerate((0, 4)):
        want, want_it = RPROG.bfs_serial(rg, source=s)
        np.testing.assert_array_equal(plane[i], want)
        assert int(iters[i]) == want_it
    assert int(iters[1]) == 1
    assert int(iters[0]) > int(iters[1])
    assert eng.dispatch["supersteps"] == int(iters.max())


def test_bucket_rounds_up_to_power_of_two():
    got = [Engine._bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 16, 17)]
    assert got == [1, 2, 4, 4, 8, 8, 16, 16, 32]
    assert got == [REngine._bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 16, 17)]


def test_run_batch_argument_errors():
    rg = program_graph("bfs", "rmat6")
    eng = engine("bfs")
    with pytest.raises(ValueError, match="batched init"):
        eng.run_batch("labelprop", sources=[0])
    with pytest.raises(ValueError, match="sources"):
        eng.run_batch("bfs")  # bfs has no default source list
    with pytest.raises(ValueError, match="at least one query"):
        eng.run_batch("bfs", sources=[])
    with pytest.raises(ValueError, match="smaller"):
        eng.run_batch("bfs", sources=[0, 1, 2], batch=2)
    with pytest.raises(ValueError, match="out of range"):
        eng.run_batch("bfs", sources=[rg.num_vertices])
    with pytest.raises(ValueError, match="out of range"):
        eng.run_batch("personalized_pagerank", sources=[(0, -1)])
    with pytest.raises(ValueError, match="empty seed set"):
        eng.run_batch("bfs", sources=[()])
    with pytest.raises(TypeError, match="params"):
        eng.run_batch(TPROG.make_program("bfs"), sources=[0], source=1)
    # a resident engine never streams (the streamed cells are
    # tests/test_torch_stream.py)
    with pytest.raises(ValueError, match="residency='stream'"):
        eng.run_batch("bfs", sources=[0], residency="stream")
    with pytest.raises(ValueError, match="sync"):
        eng.run_batch("bfs", sources=[0], sync="bogus")


def test_seed_sets_equal_reference():
    for sources in (3, [1, 2], [(1, 2), 5, np.int64(7)], ((4,),)):
        assert TPROG.seed_sets(sources) == RPROG.seed_sets(sources)
    for bad, match in ((None, "sources"), ([], "sources is empty"),
                       ([()], "empty seed set")):
        for mod in (TPROG, RPROG):
            with pytest.raises(ValueError, match=match):
                mod.seed_sets(bad)


@pytest.mark.parametrize("algo", ["pagerank", "pagerank_weighted"])
def test_fixed_iter_batched_plane_matches_run(algo):
    """The pagerank family on the counted loop: every column equals the
    single-query ``run`` state bit for bit, each count is fixed_iters."""
    eng = engine(algo)
    want, want_it = eng.run(algo, iters=9)
    plane, q_it = eng.run_batch(algo, sources=[0, 5, 9], iters=9)
    assert want_it == 9 and list(q_it) == [9, 9, 9]
    for i in range(3):
        np.testing.assert_array_equal(plane[i], want)


# ---------------------------------------------------------------------------
# Personalized PageRank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_ppr_batched_matches_sequential(strategy):
    eng = engine("personalized_pagerank", strategy=strategy)
    plane, q_it = eng.run_batch("personalized_pagerank", sources=SEED_SETS,
                                batch=4, iters=7)
    assert list(q_it) == [7] * len(SEED_SETS)
    for i, seeds in enumerate(SEED_SETS):
        want, want_it = eng.run("personalized_pagerank", seeds=seeds,
                                iters=7)
        assert want_it == 7 and want.shape == plane[i].shape
        np.testing.assert_allclose(plane[i], want, atol=1e-6)
        assert abs(float(plane[i].sum()) - 1.0) < 1e-4


def test_ppr_matches_serial_reference():
    rg = program_graph("personalized_pagerank", "rmat6")
    eng = engine("personalized_pagerank", partitioner="edge_balanced")
    for seeds in SEED_SETS:
        got, _ = eng.run("personalized_pagerank", seeds=seeds, iters=30)
        want = RPROG.personalized_pagerank_serial(rg, seeds=seeds, iters=30)
        np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_array_equal(
            TPROG.personalized_pagerank_serial(to_port(rg), seeds=seeds,
                                               iters=30), want)


def test_ppr_empty_seed_set_rejected():
    eng = engine("personalized_pagerank")
    with pytest.raises(ValueError, match="empty seed set"):
        eng.run_batch("personalized_pagerank", sources=[(0,), ()])


def test_ppr_normalize_equals_reference():
    rng = np.random.default_rng(3)
    plane = rng.random((5, 300)).astype(np.float32)
    plane[2] = 0.0  # an all-zero row stays as it is
    got = TPROG._ppr_normalize(None, None, torch.from_numpy(plane))
    assert got.dtype == torch.float32
    with np.errstate(invalid="ignore"):  # the reference's 0/0 row
        want = RPROG._ppr_normalize(None, None, plane)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    assert not got[2].any()


# ---------------------------------------------------------------------------
# Betweenness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
def test_betweenness_engine_matches_serial_ref(strategy):
    rg = program_graph("betweenness", "rmat6")
    pivots = (0, 5, 9, 33)
    got, iters = engine("betweenness", strategy=strategy).betweenness(
        pivots=pivots)
    want, want_it = RPROG.betweenness_serial(rg, pivots=pivots)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert iters == want_it


def test_betweenness_registered_with_defaults():
    spec = get_spec("betweenness")
    assert spec.defaults["pivots"] == (0, 1, 2, 3)
    rg = program_graph("betweenness", "two_cliques10")
    got, _ = TPROG.run_parallel(to_port(rg), "betweenness", num_pes=1,
                                device="cpu")
    want, _ = RPROG.betweenness_serial(rg)
    assert spec.matches(got, want)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("gname", ["rmat6", "two_cliques10", "ring13",
                                   "isolated_vertices"])
def test_betweenness_ref_equals_reference(gname):
    rg = program_graph("betweenness", gname)
    pivots = (0, 1, 2, 3)
    got, it = tref.betweenness_ref(to_port(rg), pivots)
    want, want_it = rref.betweenness_ref(rg, pivots)
    np.testing.assert_array_equal(got, want)
    assert it == want_it
    got, it = TPROG.betweenness_serial(to_port(rg), pivots=pivots)
    np.testing.assert_array_equal(got, want)


def test_betweenness_from_depths_equals_reference():
    """The device Brandes accumulation against the reference's host one on
    the same depth plane (multi-seed sets included)."""
    rg = program_graph("betweenness", "rmat10")
    sets = ((0,), (5, 9), (100,))
    depths = np.stack([RPROG.bfs_serial(rg, source=s[0])[0] for s in sets])
    depths[1] = np.minimum(depths[1], RPROG.bfs_serial(rg, source=9)[0])
    got = TPROG._betweenness_from_depths(to_port(rg), sets,
                                         torch.from_numpy(depths))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(
        got.numpy(), RPROG._betweenness_from_depths(rg, sets, depths),
        rtol=1e-12, atol=1e-9)


# ---------------------------------------------------------------------------
# The chare axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("chares", [2, 8])
def test_chare_axis_matches_serial(chares, strategy):
    rg = program_graph("sssp", "rmat6")  # weighted: serves sssp and bfs
    sources = [0, 11, 30]
    eng = engine("sssp", chares=chares, strategy=strategy)
    for algo in ("sssp", "bfs"):
        plane, iters = eng.run_batch(algo, sources=sources, batch=4)
        for i, s in enumerate(sources):
            want, want_it = RPROG.get_spec(algo).serial(rg, source=s)
            np.testing.assert_array_equal(plane[i], want)
            assert int(iters[i]) == want_it
    plane, _ = eng.run_batch("personalized_pagerank", sources=SEED_SETS,
                             iters=12)
    for i, seeds in enumerate(SEED_SETS):
        np.testing.assert_allclose(
            plane[i], RPROG.personalized_pagerank_serial(rg, seeds=seeds,
                                                         iters=12),
            atol=1e-5)


# ---------------------------------------------------------------------------
# Against repro itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["sortdest", "basic"])
def test_planes_equal_reference_run_batch(strategy):
    """The reference's run_batch and the port's on the same graph,
    partition and queries at B=4: min planes and per-query counts bit-equal,
    PPR within 1e-6."""
    rg = program_graph("sssp", "rmat6")
    rpg = RG.partition(rg, 1, partitioner="degree_sorted")
    ref = REngine(rpg, strategy=strategy)
    eng = engine("sssp", partitioner="degree_sorted", strategy=strategy)
    for algo, sources in (("bfs", [3, 17, 40, 2]), ("sssp", [0, (7, 61)])):
        want, want_it = ref.run_batch(algo, sources=sources, batch=4)
        got, got_it = eng.run_batch(algo, sources=sources, batch=4)
        np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(got_it, np.asarray(want_it))
    want, _ = ref.run_batch("personalized_pagerank", sources=SEED_SETS,
                            batch=4, iters=7)
    got, _ = eng.run_batch("personalized_pagerank", sources=SEED_SETS,
                           batch=4, iters=7)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("partitioner", ["contiguous", "degree_sorted"])
@pytest.mark.parametrize("chares", [1, 3])
def test_seed_and_teleport_planes_equal_reference(chares, partitioner):
    rg = program_graph("sssp", "rmat6")
    rpg = RG.partition(rg, chares, partitioner=partitioner)
    tpg = TG.partition(to_port(rg), chares, partitioner=partitioner)
    sets = TPROG.seed_sets([(0,), (7, 61), (3, 5, 40), 63])
    for name in ("bfs", "sssp", "betweenness", "pagerank",
                 "personalized_pagerank"):
        want = RPROG.make_program(name).init_batch(rpg, sets)
        got = TPROG.make_program(name).init_batch(tpg, sets, "cpu")
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(
        TPROG._teleport_plane(tpg, sets, "cpu").numpy(),
        RPROG._teleport_plane(rpg, sets))


def test_device_relabel_is_cached():
    pg = TG.partition(port_graph("bfs", "rmat6"), 2,
                      partitioner="degree_sorted")
    a, b = pg.device_relabel("cpu"), pg.device_relabel("cpu")
    assert a is b
    np.testing.assert_array_equal(a["global_to_local"].numpy(),
                                  pg.global_to_local)
    np.testing.assert_array_equal(a["local_to_global"].numpy(),
                                  pg.local_to_global)
    assert a["global_to_local"].dtype == torch.int64
