"""The port's mid-run replanning against the JAX reference, on the CPU.

The twins of ``tests/test_replan.py``, of the batched cell of
``tests/test_batch.py``, of the plan-algebra property of
``tests/test_properties.py`` and of the replan cells of
``tests/test_multidevice.py`` (which the reference runs one device per
chare; the port keeps the chares as the leading axis of one device):

* ``PartitionPlan.compose``/``rebase``/``padded_map_from`` built from the
  reference's ``order`` and ``chunk_counts`` give the reference's arrays;
* ``repartition`` equals ``partition`` from scratch (and the reference's
  arrays), shares ``_prep``, builds lazily and starts with an empty device
  cache;
* bfs for every ordered pair of partitioners and every registered program
  across a rotating cover of switches, under every strategy: min programs
  bit-exact with the reference's superstep counts, PageRank < 1e-6 from
  the run without a replan; the reversed policy makes a real state move;
* the string shorthand, policy validation, ``_rebind``'s fresh uploads and
  its chare-count check;
* the batched plane across a replan against the plane without one (and the
  reference's);
* real moves at C=2 and C=8, and the 1-D <-> 2-D switches at C=8, against
  the serial references.
"""

import functools

import numpy as np
import pytest

from conftest import (ALL_PARTITIONERS, ALL_STRATEGIES, graph, program_graph,
                      serial_ref, source_params)
from repro.core import Engine as REngine
from repro.core import graph as RG
from repro.core import partitioners as RP
from repro.core import programs as RPROG
from repro.core.engine import ReplanPolicy as RReplanPolicy
from repro_torch.core import Engine, ReplanPolicy, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import partitioners as TP
from repro_torch.core import programs as TPROG

REPLAN_GRAPH = "rmat6"
PROGRAMS = tuple(TPROG.registered_names())
_ROTATED = list(zip(ALL_PARTITIONERS,
                    ALL_PARTITIONERS[1:] + ALL_PARTITIONERS[:1]))
ARRAY_FIELDS = ("src_local", "dst_global", "edge_valid", "edge_weight",
                "sd_src_local", "sd_dst_global", "sd_edge_weight", "band",
                "sd_band", "out_degree", "out_weight", "vertex_valid",
                "global_to_local", "local_to_global")


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


def twin(plan):
    """The port's plan with the reference plan's order and chunk counts."""
    return TP.PartitionPlan(plan.num_chunks, plan.order.copy(),
                            plan.chunk_counts.copy())


@functools.lru_cache(maxsize=None)
def port_graph(algo, gname):
    return to_port(program_graph(algo, gname))


def _params(name):
    return source_params(RPROG.get_spec(name))


@functools.lru_cache(maxsize=None)
def reference_run(name):
    """The reference engine's result and superstep count at C=1 without a
    replan (what a replanned run must reproduce)."""
    g = program_graph(name, REPLAN_GRAPH)
    out, iters = REngine(RG.partition(g, 1)).run(name, **_params(name))
    return np.asarray(out), int(iters)


@functools.lru_cache(maxsize=None)
def no_replan(name, strategy="sortdest"):
    return TPROG.run_parallel(port_graph(name, REPLAN_GRAPH), name,
                              strategy=strategy, device="cpu",
                              **_params(name))


def _serial(name, gname=REPLAN_GRAPH):
    return serial_ref(name, gname, tuple(sorted(_params(name).items())))


@pytest.fixture
def reverse_partitioner():
    """A test-only policy whose permutation is never the identity (V > 1),
    registered in both packages, so replans at C=1 make a real state move;
    removed on teardown."""

    def plan_with(cls):
        def _plan(g, C):
            n = g.num_vertices
            K = -(-n // C) if n else 1
            counts = np.clip(n - K * np.arange(C, dtype=np.int64), 0, K)
            return cls(C, np.arange(n - 1, -1, -1, dtype=np.int64), counts)
        return _plan

    RP.register_partitioner(RP.PartitionerSpec(
        "reversed", plan_with(RP.PartitionPlan), wins="test-only"))
    TP.register_partitioner(TP.PartitionerSpec(
        "reversed", plan_with(TP.PartitionPlan), wins="test-only"))
    yield "reversed"
    RP.PARTITIONERS.pop("reversed", None)
    TP.PARTITIONERS.pop("reversed", None)


# ---------------------------------------------------------------------------
# Composition algebra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a", ALL_PARTITIONERS)
@pytest.mark.parametrize("b", ALL_PARTITIONERS)
def test_compose_rebase_padded_map_equal_reference(a, b):
    g = graph(REPLAN_GRAPH)
    RA, RB = RP.make_plan(g, 3, a), RP.make_plan(g, 3, b)
    A, B = twin(RA), twin(RB)
    D, RD = B.rebase(A), RB.rebase(RA)
    np.testing.assert_array_equal(D.order, RD.order)
    np.testing.assert_array_equal(D.chunk_counts, RD.chunk_counts)
    np.testing.assert_array_equal(A.compose(D).order, RA.compose(RD).order)
    assert A.compose(D).same_as(B)
    np.testing.assert_array_equal(B.padded_map_from(A),
                                  RB.padded_map_from(RA))
    # the padded map IS B's g2l on top of A's l2g
    m = B.padded_map_from(A)
    g2l_a, l2g_a = A.relabel()
    g2l_b, _ = B.relabel()
    live = l2g_a >= 0
    np.testing.assert_array_equal(m[live], g2l_b[l2g_a[live]])
    assert (m[~live] == -1).all()
    # the port's own planner gives the same plans
    assert TP.make_plan(to_port(g), 3, a).same_as(A)


def test_compose_identity_associativity_and_roundtrip():
    g = to_port(graph(REPLAN_GRAPH))
    ident = TP.make_plan(g, 3, "contiguous")
    A = TP.make_plan(g, 3, "striped")
    B = TP.make_plan(g, 3, "degree_sorted")
    D = TP.make_plan(g, 3, "edge_balanced")
    assert ident.compose(B).same_as(B)
    assert A.compose(ident).order.tolist() == A.order.tolist()
    assert A.compose(B).compose(D).same_as(A.compose(B.compose(D)))
    g2l, l2g = A.compose(B).relabel()
    assert np.array_equal(l2g[g2l], np.arange(g.num_vertices))
    other = TP.make_plan(to_port(graph("ring12")), 3, "contiguous")
    with pytest.raises(ValueError):
        A.compose(other)
    with pytest.raises(ValueError):
        A.rebase(other)


@pytest.mark.parametrize("seed", range(12))
def test_plan_composition_on_random_plans(seed):
    """Arbitrary valid plans (any permutation, any split, empty chunks
    included), the reference's property drawn from a numpy seed: rebase
    inverts compose, and every array equals the reference's."""
    rng = np.random.default_rng(seed)
    n, C = int(rng.integers(2, 60)), int(rng.integers(1, 6))

    def draw():
        order = rng.permutation(n).astype(np.int64)
        cuts = np.sort(rng.integers(0, n + 1, size=C - 1))
        counts = np.diff(np.concatenate(([0], cuts, [n]))).astype(np.int64)
        return RP.PartitionPlan(C, order, counts)

    RA, RB = draw(), draw()
    A, B = twin(RA), twin(RB)
    assert A.compose(B.rebase(A)).same_as(B)
    np.testing.assert_array_equal(B.padded_map_from(A),
                                  RB.padded_map_from(RA))
    g2l, l2g = A.compose(B.rebase(A)).relabel()
    assert np.array_equal(l2g[g2l], np.arange(n))


# ---------------------------------------------------------------------------
# Repartition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("target", ALL_PARTITIONERS + ("grid(2,2)",))
def test_repartition_equals_partition_from_scratch(target):
    rg = RG.random_weights(graph("rmat10"), seed=5)
    g = to_port(rg)
    pg = TG.partition(g, 4)
    rp, fs = pg.repartition(target), TG.partition(g, 4, target)
    ref = RG.partition(rg, 4).repartition(target)
    fields = (("gr_src_local", "gr_dst_col", "gr_edge_valid",
               "gr_edge_weight", "gr_band", "gr_row_to_col", "vertex_valid",
               "global_to_local", "local_to_global")
              if target.startswith("grid") else ARRAY_FIELDS)
    for f in fields:
        np.testing.assert_array_equal(getattr(rp, f), getattr(fs, f),
                                      err_msg=f"{target}.{f}")
        np.testing.assert_array_equal(getattr(rp, f), getattr(ref, f),
                                      err_msg=f"{target}.{f} (reference)")
    assert rp.partitioner == target and rp.plan.same_as(fs.plan)


def test_repartition_is_lazy_shares_prep_and_starts_uncached():
    g = to_port(graph("rmat10"))
    pg = TG.partition(g, 2)
    pg.device_arrays("sd", "cpu")
    assert pg._dev
    rp = pg.repartition("degree_sorted")
    assert rp._prep is pg._prep  # plan-independent prep reused
    assert rp._lazy == {} and rp._dev == {}
    rp.sd_band
    assert set(rp._lazy) == {"sd"}  # only the demanded layout built
    fs = TG.partition(g, 2, "degree_sorted")
    np.testing.assert_array_equal(rp.sd_src_local, fs.sd_src_local)
    np.testing.assert_array_equal(rp.band, fs.band)


# ---------------------------------------------------------------------------
# Mid-run repartition against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", ALL_PARTITIONERS)
@pytest.mark.parametrize("target", ALL_PARTITIONERS)
def test_bfs_replan_bit_exact_all_partitioner_pairs(start, target):
    want, want_iters = reference_run("bfs")
    got, iters = TPROG.run_parallel(
        port_graph("bfs", REPLAN_GRAPH), "bfs", partitioner=start,
        replan=ReplanPolicy(target, every=2, mode="always"), device="cpu",
        source=3)
    np.testing.assert_array_equal(got, _serial("bfs"))
    np.testing.assert_array_equal(got, want)
    assert iters == want_iters


@pytest.mark.parametrize("start,target", _ROTATED)
@pytest.mark.parametrize("name", PROGRAMS)
def test_all_programs_survive_midrun_repartition(name, start, target):
    """Min programs bit-exact with the reference's superstep count;
    PageRank < 1e-6 from the run without a replan (the tiled add's
    fixed order follows the layout, so only the float order moves)."""
    want, want_iters = reference_run(name)
    base, base_iters = no_replan(name)
    got, iters = TPROG.run_parallel(
        port_graph(name, REPLAN_GRAPH), name, partitioner=start,
        replan=ReplanPolicy(target, every=3, mode="always"), device="cpu",
        **_params(name))
    assert iters == want_iters == base_iters
    if RPROG.get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
    else:
        dev = np.max(np.abs(np.asarray(got, np.float64)
                            - np.asarray(base, np.float64)))
        assert dev < 1e-6, f"{name}: {start}->{target} deviates {dev}"


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("name", ("bfs", "sssp", "pagerank"))
def test_replan_under_every_strategy(strategy, name):
    want, want_iters = reference_run(name)
    got, iters = TPROG.run_parallel(
        port_graph(name, REPLAN_GRAPH), name, strategy=strategy,
        replan=ReplanPolicy("degree_sorted", every=2, mode="always"),
        device="cpu", **_params(name))
    assert iters == want_iters
    if RPROG.get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
    else:
        base, _ = no_replan(name, strategy)
        assert np.max(np.abs(got - base)) < 1e-6


def test_replan_to_reversed_is_a_real_state_move(reverse_partitioner):
    g = program_graph("sssp", REPLAN_GRAPH)
    eng = Engine(TG.partition(to_port(g), 1, "contiguous"), device="cpu")
    policy = dict(partitioner=reverse_partitioner, every=2, mode="always")
    got, iters = eng.run("sssp", source=3, replan=ReplanPolicy(**policy))
    assert eng.pg.partitioner == reverse_partitioner
    assert not np.array_equal(eng.pg.global_to_local,
                              np.arange(g.num_vertices))
    np.testing.assert_array_equal(got, _serial("sssp"))
    reng = REngine(RG.partition(g, 1, "contiguous"))
    want, want_iters = reng.run("sssp", source=3,
                                replan=RReplanPolicy(**policy))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert iters == want_iters
    np.testing.assert_array_equal(eng.pg.global_to_local,
                                  reng.pg.global_to_local)


def test_replan_string_shorthand_and_policy_validation():
    got, _ = TPROG.run_parallel(port_graph("bfs", REPLAN_GRAPH), "bfs",
                                source=3, replan="edge_balanced",
                                device="cpu")
    np.testing.assert_array_equal(got, _serial("bfs"))
    with pytest.raises(ValueError):
        ReplanPolicy("edge_balanced", mode="sometimes")
    with pytest.raises(ValueError):
        ReplanPolicy("edge_balanced", every=0)
    eng = Engine(TG.partition(port_graph("bfs", REPLAN_GRAPH), 2),
                 device="cpu")
    with pytest.raises(ValueError, match="chares"):
        eng.run("bfs", replan="grid(2,2)")  # a grid must keep C
    with pytest.raises(ValueError):
        eng.run("bfs", replan="nope")


def test_rebind_uploads_afresh_and_keeps_the_chare_count():
    g = port_graph("bfs", REPLAN_GRAPH)
    eng = Engine(TG.partition(g, 1, "contiguous"), device="cpu")
    eng.run("bfs", source=0)
    old_arrays = eng.arrays
    new_pg = eng.pg.repartition("degree_sorted")
    assert new_pg._dev == {}  # nothing resident from the old placement
    eng._rebind(new_pg)
    assert eng.pg is new_pg and eng.arrays is not old_arrays
    assert eng.arrays["sd_band"] is not old_arrays["sd_band"]
    np.testing.assert_array_equal(eng.arrays["sd_band"].numpy(),
                                  new_pg.sd_band)
    got, _ = eng.run("bfs", source=0)
    np.testing.assert_array_equal(got, RPROG.bfs_serial(
        program_graph("bfs", REPLAN_GRAPH), source=0)[0])
    with pytest.raises(ValueError):
        eng._rebind(TG.partition(g, 2))


# ---------------------------------------------------------------------------
# The batched plane across a replan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,sources", [
    ("sssp", [0, 11, 30]),
    ("bfs", [3, 5]),
    ("personalized_pagerank", [(0,), (3, 7)]),
])
def test_batched_replan_matches_unreplanned(name, sources):
    g = port_graph(name, REPLAN_GRAPH)
    want_plane, want_it = Engine(TG.partition(g, 1), device="cpu").run_batch(
        name, sources=sources)
    policy = dict(partitioner="degree_sorted", every=2, mode="always",
                  max_replans=2)
    eng = Engine(TG.partition(g, 1), device="cpu")
    got_plane, got_it = eng.run_batch(name, sources=sources,
                                      replan=ReplanPolicy(**policy))
    assert eng.pg.partitioner == "degree_sorted"
    np.testing.assert_array_equal(got_it, want_it)
    if RPROG.get_spec(name).exact:
        np.testing.assert_array_equal(got_plane, want_plane)
    else:
        assert np.max(np.abs(got_plane - want_plane)) < 1e-6
    rplane, rit = REngine(RG.partition(program_graph(name, REPLAN_GRAPH),
                                       1)).run_batch(
        name, sources=sources, replan=RReplanPolicy(**policy))
    np.testing.assert_array_equal(got_it, np.asarray(rit))
    if RPROG.get_spec(name).exact:
        np.testing.assert_array_equal(got_plane, np.asarray(rplane))


def test_betweenness_replans_through_run():
    g = port_graph("betweenness", REPLAN_GRAPH)
    want, want_it = Engine(TG.partition(g, 2), device="cpu").run(
        "betweenness")
    got, it = Engine(TG.partition(g, 2), device="cpu").run(
        "betweenness", replan=ReplanPolicy("striped", every=2,
                                           mode="always"))
    assert it == want_it
    np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# Real moves across chares, and 1-D <-> 2-D switches (against serial)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pes", (2, 8))
@pytest.mark.parametrize("target", ("edge_balanced", "striped",
                                    "degree_sorted"))
def test_multi_chare_replan_against_serial(pes, target):
    name = "sssp"
    got, iters = TPROG.run_parallel(
        port_graph(name, "rmat10"), name, num_pes=pes, source=7,
        replan=ReplanPolicy(target, every=2, mode="always"), device="cpu")
    want, want_it = RPROG.sssp_serial(program_graph(name, "rmat10"),
                                      source=7)
    np.testing.assert_array_equal(got, want)
    base, base_it = TPROG.run_parallel(port_graph(name, "rmat10"), name,
                                       num_pes=pes, source=7, device="cpu")
    assert iters == base_it


@pytest.mark.parametrize("start,target", [
    ("contiguous", "grid(2,4)"), ("edge_balanced", "grid(4,2)"),
    ("grid(2,4)", "degree_sorted"), ("grid(4,2)", "grid(2,4)")])
def test_one_d_two_d_replans_against_serial(start, target):
    got, iters = TPROG.run_parallel(
        port_graph("sssp", REPLAN_GRAPH), "sssp", num_pes=8,
        partitioner=start, source=3,
        replan=ReplanPolicy(target, every=2, mode="always"), device="cpu")
    np.testing.assert_array_equal(got, _serial("sssp"))
    assert iters == reference_run("sssp")[1]


def test_one_d_to_grid_pagerank_and_the_engine_follows():
    g = port_graph("pagerank", REPLAN_GRAPH)
    eng = Engine(TG.partition(g, 8), strategy="pairs", device="cpu")
    got, _ = eng.run("pagerank",
                     replan=ReplanPolicy("grid(2,4)", every=5,
                                         mode="always"))
    assert eng.pg.is_grid and eng.strategy == "grid2d"
    assert np.max(np.abs(got - _serial("pagerank"))) < 1e-5
    # back to 1-D: the constructor's strategy comes back
    eng.run("bfs", source=3, replan=ReplanPolicy("contiguous", every=2,
                                                 mode="always"))
    assert not eng.pg.is_grid and eng.strategy == "pairs"
