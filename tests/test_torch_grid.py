"""The port's 2-D grid (``grid(R,C)`` partitions, the ``grid2d`` two-phase
reduce) against the JAX reference, on the CPU.

The twins of ``tests/test_grid.py`` and of the grid cells of
``tests/test_multidevice.py``, with the port's kernels' plain versions:

* host side: ``GridPlan``, every ``gr_*`` array, ``gr_band``,
  ``gr_row_to_col``, ``rect_degree``, the replicated vertex planes and
  ``partition_stats``' grid fields equal to ``repro``'s for shapes (1,1),
  (1,2), (2,1), (2,2), (2,3), (4,2) and (2,4) on the conftest graphs;
* ``grid(1,1)`` through the port's ``Engine`` against ``repro``'s
  ``Engine`` for every registered program: min bit-exact, add < 1e-5;
* the five multi-rectangle shapes of the reference's subprocess suite --
  the reference needs one device per rectangle there, the port keeps the
  rectangles as the chare axis of one device -- against the serial
  references: min programs bit-exact with equal superstep counts, the
  PageRanks < 1e-6 from ``grid(1,1)``; ``grouped`` against ``full``;
* ``run_batch`` on a grid against per-query runs and the reference;
* ``wire_model``'s grid entry and ``grid_collective_bytes`` equal to the
  reference's (4/7 at grid(2,4)), and the bytes phase 2 counts equal to
  ``grid_collective_bytes`` for both lowerings;
* ``run_cost``'s grid cells, and a grid table whose dispatch picks the
  staged pair (its scatter side is the column space ``C*Kc``).
"""

import functools

import numpy as np
import pytest
import torch

from conftest import (DEGENERATE_GRAPHS, EQUIV_GRAPHS, graph, program_graph,
                      serial_ref, source_params)
from repro.core import Engine as REngine
from repro.core import cost as rcost
from repro.core import graph as RG
from repro.core import partitioners as RP
from repro.core import programs as RPROG
from repro.kernels import blocks as RB
from repro_torch.core import Engine, cost, get_spec, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import partitioners as TP
from repro_torch.core import programs as TPROG
from repro_torch.core import strategies as TS

SHAPES = ((1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (4, 2), (2, 4))
MULTI = ((1, 2), (2, 1), (2, 2), (4, 2), (2, 4))
HOST_GRAPHS = tuple(sorted(EQUIV_GRAPHS + ("rmat10",) + DEGENERATE_GRAPHS))
PROGRAMS = tuple(TPROG.registered_names())

LAYOUT_FIELDS = ("gr_src_local", "gr_dst_col", "gr_edge_valid",
                 "gr_edge_weight", "gr_band", "gr_row_to_col", "rect_degree",
                 "vertex_valid", "out_degree", "out_weight", "edge_valid",
                 "global_to_local", "local_to_global")


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


def name_of(shape):
    return f"grid({shape[0]},{shape[1]})"


@functools.lru_cache(maxsize=None)
def host_graph(gname):
    """A conftest graph, weighted where it has edges (the weight plane is
    part of the layout)."""
    g = graph(gname)
    return RG.random_weights(g, seed=5) if g.num_edges else g


@functools.lru_cache(maxsize=None)
def port_graph(algo, gname):
    return to_port(program_graph(algo, gname))


@functools.lru_cache(maxsize=None)
def port_engine(algo, gname, shape, collectives="auto"):
    pg = TG.partition(port_graph(algo, gname), shape[0] * shape[1],
                      partitioner=name_of(shape))
    return Engine(pg, device="cpu", collectives=collectives)


@functools.lru_cache(maxsize=None)
def port_run(algo, gname, shape, collectives="auto"):
    eng = port_engine(algo, gname, shape, collectives)
    out, iters = eng.run(algo, **source_params(get_spec(algo)))
    return out, iters, dict(eng.dispatch["collectives"])


def assert_same(name, got, want, tol):
    if get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Family parsing and the guards (test_grid.py's cells)
# ---------------------------------------------------------------------------


def test_grid_family_parsing():
    assert TP.grid_shape("grid(2,4)") == (2, 4)
    assert TP.grid_shape("grid(4x2)") == (4, 2)
    assert TP.grid_shape("grid(2,2,edge_balanced)") == (2, 2)
    assert TP.grid_shape("contiguous") is None
    spec = TP.get_partitioner("grid(2,4)")
    assert spec.name == "grid(2,4)"
    assert TP.get_partitioner("grid(2,4)") is spec  # family specs cached
    assert TP.get_partitioner("grid(2,2,edge_balanced)") is not None
    assert TP.get_partitioner("grid(2,2,striped,degree_sorted)") is not None
    for bad in ("grid(2,2,metis)", "grid(0,2)", "grid(2,2,striped,metis)",
                "nope"):
        with pytest.raises(ValueError):
            TP.get_partitioner(bad)
    # the static 1-D registry is untouched by family lookups
    assert all(TP.grid_shape(n) is None for n in TP.partitioner_names())
    assert TP.partitioner_names() == RP.partitioner_names()


def test_grid_plan_requires_matching_chare_count():
    g = to_port(graph("rmat6"))
    with pytest.raises(ValueError, match="num_chunks"):
        TP.make_plan(g, 4, "grid(2,4)")


def test_grid_partition_guards():
    pg = TG.partition(to_port(graph("rmat6")), 4, partitioner="grid(2,2)")
    for which in ("basic", "sd"):
        with pytest.raises(ValueError):
            pg._layout(which)
    with pytest.raises(ValueError):
        _ = pg.sd_src_local
    with pytest.raises(ValueError):
        TG.build_pairwise(pg)
    assert set(pg.device_arrays("both", "cpu")) == {
        "gr_src_local", "gr_dst_col", "gr_edge_valid", "gr_edge_weight",
        "gr_band", "gr_row_to_col"}
    one_d = TG.partition(to_port(graph("rmat6")), 2)
    assert not one_d.is_grid and one_d.grid_shape is None
    for attr in ("gr_src_local", "gr_band", "gr_edge_valid", "gr_row_to_col",
                 "rect_degree", "col_chunk_size"):
        with pytest.raises(ValueError):
            getattr(one_d, attr)


def test_engine_strategy_follows_partition():
    g = to_port(graph("rmat6"))
    pg = TG.partition(g, 4, partitioner="grid(2,2)")
    # any requested 1-D strategy resolves to grid2d on a grid partition
    for strategy in ("reduction", "sortdest", "basic", "pairs", "grid2d"):
        eng = Engine(pg, strategy=strategy, device="cpu")
        assert eng.strategy == "grid2d"
        assert eng.dispatch["layout"] == "grid"
        assert eng.dispatch["choice"] in ("fused", "staged")
        assert eng.dispatch["collectives"]["lowering"] == "grouped"
    assert Engine(pg, device="cpu", collectives="full") \
        .dispatch["collectives"]["lowering"] == "full"
    # grid2d on a 1-D partition is an error, as is an unknown lowering
    with pytest.raises(ValueError, match="grid"):
        Engine(TG.partition(g, 1), strategy="grid2d", device="cpu")
    with pytest.raises(ValueError, match="collectives"):
        Engine(pg, device="cpu", collectives="psum")


def test_grid_groups_equal_reference():
    from repro.core import strategies as RS
    from repro_torch.core.mesh import grid_groups

    for R, C in SHAPES:
        assert grid_groups(R, C) == RS.grid_groups(R, C)


# ---------------------------------------------------------------------------
# Host arrays equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gname", HOST_GRAPHS)
def test_grid_plan_equals_reference(gname, shape):
    rg = host_graph(gname)
    P = shape[0] * shape[1]
    want = RP.make_plan(rg, P, name_of(shape))
    got = TP.make_plan(to_port(rg), P, name_of(shape))
    assert isinstance(got, TP.GridPlan)
    for attr in ("rows", "cols", "num_chunks", "num_vertices", "chunk_size",
                 "col_chunk_size"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for attr in ("rect_counts", "rect_starts"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr), err_msg=attr)
    np.testing.assert_array_equal(got.edges_per_chunk(to_port(rg)),
                                  want.edges_per_chunk(rg))
    for axis in ("row", "col"):
        g_ax, w_ax = getattr(got, axis), getattr(want, axis)
        np.testing.assert_array_equal(g_ax.order, w_ax.order)
        np.testing.assert_array_equal(g_ax.chunk_counts, w_ax.chunk_counts)
    assert TP.row_plan_of(got) is got.row
    assert got.same_as(TP.make_plan(to_port(rg), P, name_of(shape)))
    assert not got.same_as(got.row)
    assert not got.row.same_as(got)
    # rectangle bounds tile [0, E)
    assert int(got.rect_counts.sum()) == rg.num_edges


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("gname", HOST_GRAPHS)
def test_grid_layout_equals_reference(gname, shape):
    """Every array of the rectangle decomposition, the replicated vertex
    planes and the relabel maps equal the reference's, and so do
    ``partition_stats`` with and without a frontier."""
    rg = host_graph(gname)
    P = shape[0] * shape[1]
    rp = RG.partition(rg, P, partitioner=name_of(shape))
    tp = TG.partition(to_port(rg), P, partitioner=name_of(shape))
    assert tp.is_grid and tp.grid_shape == rp.grid_shape == shape
    assert tp.col_chunk_size == rp.col_chunk_size
    assert (tp.num_chunks, tp.chunk_size) == (rp.num_chunks, rp.chunk_size)
    for k in LAYOUT_FIELDS:
        got, want = getattr(tp, k), getattr(rp, k)
        np.testing.assert_array_equal(got, want, err_msg=k)
        assert got.dtype == want.dtype, k
    rng = np.random.default_rng(P)
    frontier = rng.integers(0, 2, (P, tp.chunk_size)).astype(np.int32)
    for front in (None, frontier):
        got = TP.partition_stats(tp, frontier=front)
        want = RP.partition_stats(rp, frontier=front)
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key


@pytest.mark.parametrize("policy", ("edge_balanced", "striped,degree_sorted"))
def test_grid_policies_equal_reference(policy):
    rg = host_graph("rmat10")
    name = f"grid(2,3,{policy})"
    rp = RG.partition(rg, 6, partitioner=name)
    tp = TG.partition(to_port(rg), 6, partitioner=name)
    for k in LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(tp, k), getattr(rp, k),
                                      err_msg=k)


@pytest.mark.parametrize("shape", ((2, 2), (3, 1), (1, 3)))
def test_grid_replicated_state_planes(shape):
    """Per-vertex planes are the row layout replicated across each row's
    columns, g2l names the column-0 replica, and row_to_col maps live
    slots onto the column relabel."""
    rows, cols = shape
    pg = TG.partition(to_port(graph("rmat6")), rows * cols,
                      partitioner=name_of(shape))
    V = pg.graph.num_vertices
    K = pg.chunk_size
    for plane in (pg.vertex_valid, pg.out_degree, pg.out_weight,
                  pg.local_to_global.reshape(-1, K), pg.gr_row_to_col):
        r = plane.reshape(rows, cols, K)
        for c in range(1, cols):
            np.testing.assert_array_equal(r[:, c], r[:, 0])
    assert np.array_equal(pg.local_to_global[pg.global_to_local],
                          np.arange(V))
    assert ((pg.global_to_local // K) % cols == 0).all()
    col_g2l, _ = pg.plan.col.relabel()
    flat_map = pg.gr_row_to_col.reshape(-1)
    live = pg.local_to_global >= 0
    np.testing.assert_array_equal(flat_map[live],
                                  col_g2l[pg.local_to_global[live]])
    assert (flat_map[~live] == -1).all()


# ---------------------------------------------------------------------------
# The engine: grid(1,1) against the reference's engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname", sorted(EQUIV_GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_grid11_matches_reference_engine(name, gname):
    params = source_params(get_spec(name))
    got, iters, _ = port_run(name, gname, (1, 1))
    want, ref_iters = REngine(RG.partition(
        program_graph(name, gname), 1, partitioner="grid(1,1)")).run(
            name, **params)
    assert iters == ref_iters
    assert_same(name, got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("gname", ("rmat10", "ring13"))
def test_grid11_dispatch_equals_reference(gname):
    rg = graph(gname)
    want = REngine(RG.partition(rg, 1, partitioner="grid(1,1)")).dispatch
    got = Engine(TG.partition(to_port(rg), 1, partitioner="grid(1,1)"),
                 device="cpu").dispatch
    for k in ("choice", "mode", "layout", "threshold", "gather_tiles",
              "scatter_tiles", "max_occupancy", "tile_occupancy"):
        assert got[k] == want[k], k
    assert got["collectives"]["lowering"] == want["collectives"] == "grouped"


@pytest.mark.parametrize("shape", MULTI)
def test_grid_dispatch_prices_the_column_space(shape):
    """At the multi-rectangle shapes (the reference's engine needs one
    device per rectangle there): the reference's rule on its own
    ``gr_band`` with the column-space scatter side ``C*Kc``."""
    rg = graph("rmat10")
    P = shape[0] * shape[1]
    rp = RG.partition(rg, P, partitioner=name_of(shape))
    choice, occ = RB.choose_push(rp.gr_band, rp.edge_valid.shape[1],
                                 rp.chunk_size, shape[1] * rp.col_chunk_size)
    got = Engine(TG.partition(to_port(rg), P, partitioner=name_of(shape)),
                 device="cpu").dispatch
    assert got["choice"] == choice
    for k, v in occ.items():
        assert got[k] == v, k


# ---------------------------------------------------------------------------
# Phase 1 row by row against the reference's shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hook", (False, True))
@pytest.mark.parametrize("name", ("bfs", "labelprop", "pagerank",
                                  "pagerank_weighted", "sssp"))
def test_phase1_rows_equal_reference_shards(name, hook):
    """grid2d's phase 1 pushes every rectangle in one call; row k of its
    ``[R*C, C*Kc]`` partial equals the reference's ``grid2d_phase1`` on
    shard k's arrays (a plain jnp function, callable without a mesh) --
    staged on both sides, or through both packages' push hooks.  The
    one-call ``STRATEGIES["grid2d"]`` is phase 2 of that partial."""
    import jax.numpy as jnp

    from repro.core import strategies as RS
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops

    R, C = 2, 4
    P = R * C
    rg = program_graph(name, "rmat6")
    rp = RG.partition(rg, P, partitioner="grid(2,4)")
    tp = TG.partition(to_port(rg), P, partitioner="grid(2,4)")
    prog_t, prog_r = TPROG.make_program(name), RPROG.make_program(name)
    K, Kc = tp.chunk_size, tp.col_chunk_size
    meta = (R, C, Kc)
    rng = np.random.default_rng(1)
    unreached = rng.integers(0, 3, (P, K)) == 0
    if prog_t.combiner.name == "add":
        vals = rng.uniform(0, 1, (P, K)).astype(np.float32)
    elif name == "sssp":
        vals = np.where(unreached, np.inf, rng.uniform(0, 50, (P, K))
                        ).astype(np.float32)
    else:
        vals = np.where(unreached, TPROG.INT_SENTINEL,
                        rng.integers(0, 100, (P, K))).astype(np.int32)
    arrs = tp.device_arrays("grid", "cpu")
    kw = dict(edge_value=prog_t.edge_value,
              push_fn=ops.make_push_fn() if hook else None,
              edge_semiring=prog_t.edge_semiring)
    got = TS.grid2d_phase1(torch.from_numpy(vals), arrs, prog_t.combiner,
                           P, K, grid_meta=meta, **kw)
    assert tuple(got.shape) == (P, C * Kc)
    for k in range(P):
        shard = {f: jnp.asarray(getattr(rp, f)[k])
                 for f in ("gr_src_local", "gr_dst_col", "gr_edge_valid",
                           "gr_edge_weight", "gr_band")}
        want = np.asarray(RS.grid2d_phase1(
            jnp.asarray(vals[k]), shard, prog_r.combiner, P, K,
            edge_value=prog_r.edge_value,
            push_fn=rops.make_push_fn() if hook else None,
            edge_semiring=prog_r.edge_semiring, grid_meta=meta))
        if get_spec(name).exact:
            np.testing.assert_array_equal(got[k].numpy(), want)
        else:
            scale = float(np.max(np.abs(want)))
            np.testing.assert_allclose(got[k].numpy(), want, rtol=1e-6,
                                       atol=1e-6 * scale)
    for collectives in ("grouped", "full"):
        one_call = TS.STRATEGIES["grid2d"](
            torch.from_numpy(vals), arrs, prog_t.combiner, P, K,
            grid_meta=meta, collectives=collectives, **kw)
        phased = TS.grid2d_phase2(got, arrs, prog_t.combiner, P, K,
                                  grid_meta=meta, collectives=collectives)
        assert torch.equal(one_call, phased)


# ---------------------------------------------------------------------------
# The engine: the multi-rectangle shapes against serial and each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname", sorted(EQUIV_GRAPHS))
@pytest.mark.parametrize("shape", MULTI)
@pytest.mark.parametrize("name", PROGRAMS)
def test_grid_shapes_match_serial(name, shape, gname):
    spec = get_spec(name)
    params = source_params(spec)
    got, iters, _ = port_run(name, gname, shape)
    ref = serial_ref(name, gname, tuple(sorted(params.items())))
    assert spec.matches(got, ref)
    one, one_iters, _ = port_run(name, gname, (1, 1))
    assert iters == one_iters
    if spec.exact:
        np.testing.assert_array_equal(got, one)
        if spec.returns_iters and name != "labelprop":
            serial = RPROG.get_spec(name).serial(
                program_graph(name, gname), **{**spec.defaults, **params})
            assert iters == serial[1]
    else:
        assert float(np.max(np.abs(got - one))) < 1e-6


@pytest.mark.parametrize("shape", MULTI)
@pytest.mark.parametrize("name", PROGRAMS)
def test_grouped_equals_full(name, shape):
    got, iters, wire_g = port_run(name, "rmat6", shape, "grouped")
    want, want_iters, wire_f = port_run(name, "rmat6", shape, "full")
    assert iters == want_iters
    assert (wire_g["lowering"], wire_f["lowering"]) == ("grouped", "full")
    if get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert float(np.max(np.abs(got - want))) < 1e-6


@pytest.mark.parametrize("name", ("sssp", "bfs", "labelprop"))
def test_seeds_hit_every_replica(name):
    """A source (or an id-valued init) seeds all C replicas of its row
    slot: a seed in one column only would start the other columns'
    rectangles from the wrong state."""
    R, C = 2, 4
    pg = port_engine(name, "rmat6", (R, C)).pg
    prog = TPROG.make_program(name, **source_params(get_spec(name)))
    state = prog.init(pg).reshape(R, C, -1)
    for c in range(1, C):
        np.testing.assert_array_equal(state[:, c], state[:, 0])
    if name != "labelprop":
        assert int((state == 0).sum()) == C
    plane = prog.init_batch(pg, ((3,), (5, 9)), torch.device("cpu")) \
        if prog.init_batch is not None else None
    if plane is not None:
        plane = plane.numpy().reshape(R, C, -1, 2)
        for c in range(1, C):
            np.testing.assert_array_equal(plane[:, c], plane[:, 0])
        assert int((plane[..., 1] == 0).sum()) == 2 * C


@pytest.mark.parametrize("name", ("bfs", "sssp", "personalized_pagerank"))
def test_run_batch_on_grid(name):
    """The plane on grid(2,4): each column equals its own run on the same
    grid (PPR within 1e-6), and the reference's plane on grid(1,1) (its
    engine runs one rectangle per device) in values and superstep
    counts; the teleport plane is replicated across the grid's columns."""
    rg = program_graph(name, "rmat6")
    eng = port_engine(name, "rmat6", (2, 4))
    ppr = name == "personalized_pagerank"
    sources = [(0,), (7, 61), (3, 5, 40), (12,)] if ppr else [3, 0, 17, 40]
    plane, iters = eng.run_batch(name, sources=sources)
    for i, s in enumerate(sources):
        params = {"seeds": s} if ppr else {"source": s}
        one, it = eng.run(name, **params)
        assert it == iters[i]
        if ppr:
            assert float(np.abs(plane[i] - one).max()) < 1e-6
        else:
            np.testing.assert_array_equal(plane[i], one)
    want, want_iters = REngine(RG.partition(rg, 1, partitioner="grid(1,1)")
                               ).run_batch(name, sources=sources)
    np.testing.assert_array_equal(iters, np.asarray(want_iters))
    assert_same(name, plane, np.asarray(want), 1e-5)
    if ppr:
        tele = TPROG._teleport_plane(eng.pg, TPROG.seed_sets(sources),
                                     torch.device("cpu"))
        tele = tele.numpy().reshape(2, 4, eng.pg.chunk_size, -1)
        for c in range(1, 4):
            np.testing.assert_array_equal(tele[:, c], tele[:, 0])


# ---------------------------------------------------------------------------
# Wire bytes: the models against the reference, the counts against the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_grid_wire_models_equal_reference(shape):
    rg = graph("rmat10")
    P = shape[0] * shape[1]
    for batch in (1, 4):
        got = cost.wire_model(to_port(rg), P, partitioner=name_of(shape),
                              batch=batch)
        assert set(got) == {"grid2d"}
        assert got == rcost.wire_model(rg, P, partitioner=name_of(shape),
                                       batch=batch)
        assert cost.grid_collective_bytes(
            to_port(rg), P, name_of(shape), batch=batch) == \
            rcost.grid_collective_bytes(rg, P, name_of(shape), batch=batch)


def test_grid_collective_ratio_at_grid24():
    g = to_port(graph("rmat10"))
    m = cost.grid_collective_bytes(g, 8, "grid(2,4)")
    assert m["ratio"] == pytest.approx(4 / 7)
    assert m["ratio"] <= 0.6
    with pytest.raises(ValueError):
        cost.grid_collective_bytes(g, 8, "contiguous")


def test_wire_model_grid_terms():
    g = to_port(graph("rmat10"))
    # degenerate axes: R=1 has no column combine, C=1 no redistribution
    plan = TP.make_plan(g, 2, "grid(1,2)")
    assert cost.wire_model(g, 2, partitioner="grid(1,2)")["grid2d"] == \
        plan.chunk_size * 4 * (2 - 1) / 2
    plan21 = TP.make_plan(g, 2, "grid(2,1)")
    assert cost.wire_model(g, 2, partitioner="grid(2,1)")["grid2d"] == \
        2 * min(plan21.col_chunk_size, int(plan21.rect_counts.max())) * 4 / 2


@pytest.mark.parametrize("collectives", ("grouped", "full"))
@pytest.mark.parametrize("shape", SHAPES)
def test_counted_bytes_equal_the_model(shape, collectives):
    """Each lowering's reduces count, per rectangle per superstep, what
    ``grid_collective_bytes`` prices, for one query and for a B=4 plane."""
    g = port_graph("bfs", "rmat10")
    P = shape[0] * shape[1]
    eng = Engine(TG.partition(g, P, partitioner=name_of(shape)),
                 device="cpu", collectives=collectives)
    lowering = "full" if shape == (1, 1) else collectives
    _, iters = eng.run("bfs", source=3)
    got = eng.dispatch["collectives"]
    want = cost.grid_collective_bytes(g, P, name_of(shape))
    assert got["lowering"] == collectives and got["supersteps"] == iters
    assert got["bytes_per_superstep"] == pytest.approx(want[lowering])
    assert got["bytes"] == pytest.approx(want[lowering] * iters)
    eng.run_batch("bfs", sources=[3, 5, 7, 9], batch=4)
    want4 = cost.grid_collective_bytes(g, P, name_of(shape), batch=4)
    assert eng.dispatch["collectives"]["bytes_per_superstep"] == \
        pytest.approx(want4[lowering])


# ---------------------------------------------------------------------------
# The COST harness and the staged choice
# ---------------------------------------------------------------------------


def test_run_cost_threads_grid_cells():
    g = port_graph("pagerank", "rmat6")
    report = cost.run_cost(g, "pagerank", pe_counts=(1, 4),
                           partitioners=("contiguous", "grid(1,1)",
                                         "grid(2,2)"),
                           repeats=1, device="cpu", iters=2)
    for cell in (("grid(1,1)", "grid2d", 1), ("grid(2,2)", "grid2d", 4)):
        assert cell in report.parallel_s
        assert report.dispatch[cell]["layout"] == "grid"
        assert cell[:2] in report.cost
    # a grid runs only at its own chare count, only grid2d
    assert not any(k[0].startswith("grid") and k[1] != "grid2d"
                   for k in report.parallel_s)
    assert ("grid(2,2)", "grid2d", 1) not in report.parallel_s
    # 1-D cells are unaffected
    assert ("contiguous", "sortdest", 1) in report.parallel_s


def test_run_cost_skips_unmeasurable_grid_cells():
    """A grid whose R*C is not in the chare sweep produces NO verdict."""
    g = port_graph("pagerank", "rmat6")
    report = cost.run_cost(g, "pagerank", pe_counts=(1,),
                           partitioners=("contiguous", "grid(2,2)"),
                           repeats=1, device="cpu", iters=2)
    assert not any(k[0] == "grid(2,2)" for k in report.parallel_s)
    assert not any(k[0] == "grid(2,2)" for k in report.cost)
    assert ("contiguous", "sortdest") in report.cost


@pytest.mark.parametrize("name", ("sssp", "pagerank"))
def test_staged_choice_on_a_grid_table(name):
    """Where ``choose_push`` picks ``staged`` on ``gr_band``, the staged
    pair runs with the column space ``C*Kc`` as its segment count (not the
    1-D ``C*K``), and the result still equals serial."""
    rg = program_graph(name, "rmat6")
    pg = TG.partition(to_port(rg), 4, partitioner="grid(2,2)")
    eng = Engine(pg, device="cpu")
    assert eng.dispatch["choice"] == "staged"
    assert eng.push_fn.fused is False
    assert pg.grid_shape[1] * pg.col_chunk_size != \
        pg.num_chunks * pg.chunk_size
    seen = []
    hook = eng.push_fn

    def recording(vals, src, dst, valid, weight, num_segments, **kw):
        seen.append(num_segments)
        return hook(vals, src, dst, valid, weight, num_segments, **kw)

    eng.push_fn = recording
    params = source_params(get_spec(name))
    got, _ = eng.run(name, **params)
    assert seen and set(seen) == {pg.grid_shape[1] * pg.col_chunk_size}
    assert get_spec(name).matches(
        got, serial_ref(name, "rmat6", tuple(sorted(params.items()))))
