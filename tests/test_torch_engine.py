"""The torch port's engine against the JAX reference and the serial programs.

The 5 single-query programs x {reduction, sortdest, basic, pairs} x 4
partitioners x C in {1, 2, 8}, on the equivalence trio, with the port on
the CPU:

* at C=1 the port is held against ``repro``'s ``Engine.run`` in-process:
  min programs bit-equal in values and iteration counts, add programs
  within rtol=atol=1e-5 of the reference (the two sum in different orders)
  and < 1e-3 of serial;
* at C in {2, 8} the reference cannot run here -- its chares are mesh
  shards and this process sees one CPU device (its own sweep runs at
  num_pes=1 too) -- so the port is held against the serial references and
  against its own C=1 run: min programs bit-equal (values and iteration
  counts), add programs within 1e-5.
"""

import functools

import numpy as np
import pytest
import torch

from conftest import (ALL_PARTITIONERS, EQUIV_GRAPHS, graph, program_graph,
                      serial_ref, source_params)
from repro.core import Engine as REngine
from repro.core import cost as rcost
from repro.core import get_spec as rget_spec
from repro.core import graph as RG
from repro.core import labelprop as rlabelprop
from repro.core import pagerank as rpagerank
from repro.core import programs as RPROG
from repro_torch.core import Engine, cost, get_spec, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import labelprop, pagerank
from repro_torch.core import programs as TPROG
from repro_torch.kernels import ops

PROGRAMS = ("bfs", "labelprop", "pagerank", "pagerank_weighted", "sssp")
STRATEGIES = ("reduction", "sortdest", "pairs")  # the dense-layout ones
ALL_STRATEGIES = STRATEGIES + ("basic",)


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


@functools.lru_cache(maxsize=None)
def port_graph(name, gname):
    return to_port(program_graph(name, gname))


@functools.lru_cache(maxsize=None)
def port_run(name, gname, strategy, partitioner, chares):
    spec = get_spec(name)
    eng = Engine(TG.partition(port_graph(name, gname), chares,
                              partitioner=partitioner),
                 strategy=strategy, device="cpu")
    return eng.run(name, **source_params(spec))


def check_serial(name, gname, got, iters):
    spec = get_spec(name)
    params = source_params(spec)
    ref = serial_ref(name, gname, tuple(sorted(params.items())))
    assert spec.matches(got, ref), (
        f"{name}/{gname}: max deviation "
        f"{np.max(np.abs(np.asarray(got, np.float64) - ref))}")
    if spec.exact and spec.returns_iters and name != "labelprop":
        serial = rget_spec(name).serial(program_graph(name, gname),
                                        **{**spec.defaults, **params})
        assert iters == serial[1]


def assert_same(name, got, want, tol):
    if get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    else:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("gname", sorted(EQUIV_GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_matches_reference_at_one_chare(name, gname, strategy,
                                               partitioner):
    params = source_params(get_spec(name))
    got, iters = port_run(name, gname, strategy, partitioner, 1)
    want, ref_iters = REngine(RG.partition(program_graph(name, gname), 1,
                                           partitioner=partitioner),
                              strategy=strategy).run(name, **params)
    assert iters == ref_iters
    assert_same(name, got, np.asarray(want), 1e-5)
    check_serial(name, gname, got, iters)


@pytest.mark.parametrize("chares", (2, 8))
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("gname", sorted(EQUIV_GRAPHS))
@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_chare_axis(name, gname, strategy, partitioner, chares):
    got, iters = port_run(name, gname, strategy, partitioner, chares)
    one, one_iters = port_run(name, gname, strategy, partitioner, 1)
    assert iters == one_iters
    assert_same(name, got, one, 1e-5)
    check_serial(name, gname, got, iters)


@pytest.mark.parametrize("strategy,hook", [("reduction", False),
                                           ("sortdest", False),
                                           ("sortdest", True)])
@pytest.mark.parametrize("name", PROGRAMS)
def test_phase1_rows_equal_reference_shards(name, strategy, hook):
    """Phase 1 pushes every chare in one call; row c of its [C, C*K]
    partial equals the reference's ``_dense_contrib`` on shard c's arrays
    (a plain jnp function, callable without a mesh) -- staged on both
    sides, or through both packages' push hooks."""
    import jax.numpy as jnp

    from repro.core import strategies as RS
    from repro.kernels import ops as rops
    from repro_torch.core import strategies as TS

    C = 4
    rg = program_graph(name, "rmat6")
    rp = RG.partition(rg, C, partitioner="striped")
    tp = TG.partition(to_port(rg), C, partitioner="striped")
    prog_t, prog_r = TPROG.make_program(name), RPROG.make_program(name)
    K = tp.chunk_size
    rng = np.random.default_rng(0)
    unreached = rng.integers(0, 3, (C, K)) == 0
    if prog_t.combiner.name == "add":
        vals = rng.uniform(0, 1, (C, K)).astype(np.float32)
    elif name == "sssp":
        vals = np.where(unreached, np.inf, rng.uniform(0, 50, (C, K))
                        ).astype(np.float32)
    else:
        vals = np.where(unreached, TPROG.INT_SENTINEL,
                        rng.integers(0, 100, (C, K))).astype(np.int32)
    layout = TS.STRATEGY_LAYOUT[strategy]
    got = TS.PHASES[strategy][0](
        torch.from_numpy(vals), tp.device_arrays(layout, "cpu"),
        prog_t.combiner, C, K, edge_value=prog_t.edge_value,
        push_fn=ops.make_push_fn() if hook else None,
        edge_semiring=prog_t.edge_semiring).numpy()
    assert got.shape == (C, C * K)
    pre = "sd_" if layout == "sd" else ""
    plane = lambda field, c: jnp.asarray(getattr(rp, pre + field)[c])
    for c in range(C):
        want = np.asarray(RS._dense_contrib(
            jnp.asarray(vals[c]), plane("src_local", c),
            plane("dst_global", c), plane("edge_valid", c),
            plane("edge_weight", c), prog_r.combiner, C, K,
            edge_value=prog_r.edge_value,
            push_fn=rops.make_push_fn() if hook else None,
            band=plane("band", c), edge_semiring=prog_r.edge_semiring))
        if get_spec(name).exact:
            np.testing.assert_array_equal(got[c], want)
        else:
            scale = float(np.max(np.abs(want)))
            np.testing.assert_allclose(got[c], want, rtol=1e-6,
                                       atol=1e-6 * scale)


@pytest.mark.parametrize("chares", (1, 2, 8))
@pytest.mark.parametrize("name", PROGRAMS)
def test_push_hook_on_cpu_equals_staged(name, chares):
    """The engine's kernel path (the push hook: on the CPU, the kernels'
    plain version) agrees with the plain staged pipeline that
    ``push_fn=None`` runs on the CPU."""
    spec = get_spec(name)
    pg = TG.partition(port_graph(name, "rmat6"), chares)
    params = source_params(spec)
    hooked = Engine(pg, device="cpu", push_fn=ops.make_push_fn())
    staged = Engine(pg, device="cpu", push_fn=None)
    got, it = hooked.run(name, **params)
    want, it_s = staged.run(name, **params)
    assert it == it_s
    assert_same(name, got, want, 1e-5)
    assert hooked.dispatch["choice"] == "explicit"
    assert staged.dispatch["choice"] == "staged"


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("gname", ("rmat10", "ring13"))
def test_dispatch_decision_equals_reference(gname, strategy):
    """The staged-vs-fused choice and its occupancy numbers equal the
    reference engine's at C=1, and the reference rule on the reference's
    own band table at C=4 (its engine needs 4 devices there)."""
    from repro.kernels import blocks as RB

    rg = graph(gname)
    keys = ("choice", "gather_tiles", "scatter_tiles", "max_occupancy",
            "tile_occupancy")
    want = REngine(RG.partition(rg, 1), strategy=strategy).dispatch
    d = Engine(TG.partition(to_port(rg), 1), strategy=strategy,
               device="cpu").dispatch
    assert d["kernel"] == "plain"  # CUDA kernels only on a CUDA device
    for k in keys + ("mode", "layout", "threshold"):
        assert d[k] == want[k], k
    rp = RG.partition(rg, 4)
    band = rp.sd_band if d["layout"] == "sd" else rp.band
    choice, occ = RB.choose_push(band, rp.edge_valid.shape[1],
                                 rp.chunk_size, 4 * rp.chunk_size)
    d4 = Engine(TG.partition(to_port(rg), 4), strategy=strategy,
                device="cpu").dispatch
    assert d4["choice"] == choice
    for k in keys[1:]:
        assert d4[k] == occ[k], k


@pytest.mark.parametrize("gname", ("rmat10", "ring13"))
def test_auto_dispatch_installs_the_hook_for_either_choice(gname):
    """``choose_push``'s choice picks the hook: the fused push for "fused"
    (rmat10), the staged pair for "staged" (ring13) -- the CUDA kernels on
    the card, their plain version here."""
    rg = graph(gname)
    want = REngine(RG.partition(rg, 1), strategy="sortdest").dispatch
    eng = Engine(TG.partition(to_port(rg), 1), device="cpu")
    assert eng.dispatch["choice"] == want["choice"]
    assert eng.push_fn is not None
    assert eng.push_fn.fused == (want["choice"] == "fused")
    got, iters = eng.run("bfs", source=0)
    ref, ref_iters = RPROG.bfs_serial(rg, source=0)
    np.testing.assert_array_equal(got, ref)
    assert iters == ref_iters


def test_staged_pipeline_takes_cpu_tensors_only():
    """The plain staged pipeline runs only on the CPU: given tensors on
    another device (``meta`` here) the staged kernels' wrappers raise
    instead of running plain torch there, hook or no hook."""
    from repro_torch.core import strategies as TS

    pg = TG.partition(port_graph("bfs", "rmat6"), 2)
    arrs = {k: v.to("meta")
            for k, v in pg.device_arrays("sd", "cpu").items()}
    vals = torch.zeros((2, pg.chunk_size), dtype=torch.int32, device="meta")
    prog = TPROG.make_program("bfs")
    for hook in (None, ops.make_push_fn(), ops.make_push_fn(fused=False)):
        with pytest.raises(ValueError, match="meta"):
            TS.sortdest_phase1(vals, arrs, prog.combiner, 2, pg.chunk_size,
                               edge_value=prog.edge_value, push_fn=hook,
                               edge_semiring=prog.edge_semiring)


@pytest.mark.parametrize("chares", (1, 2))
@pytest.mark.parametrize("gname", ("single_vertex", "isolated_vertices"))
def test_labelprop_on_degenerate_graphs(gname, chares):
    """labelprop symmetrizes its graph first; graphs with no edges or with
    edgeless vertices go through ``to_undirected`` and the engine, and
    agree with the reference engine and the components oracle."""
    rg = program_graph("labelprop", gname)
    got, iters = Engine(TG.partition(to_port(graph(gname)).to_undirected(),
                                     chares), device="cpu").run("labelprop")
    np.testing.assert_array_equal(got, rlabelprop.components_oracle(rg))
    if chares == 1:
        want, ref_iters = REngine(RG.partition(rg, 1)).run("labelprop")
        np.testing.assert_array_equal(got, np.asarray(want))
        assert iters == ref_iters


def test_engine_shares_device_arrays():
    pg = TG.partition(port_graph("pagerank", "rmat6"), 2)
    a, b = Engine(pg, "sortdest", "cpu"), Engine(pg, "pairs", "cpu")
    assert a.arrays is b.arrays
    assert a.aux is b.aux
    r = Engine(pg, "reduction", "cpu")
    assert set(r.arrays) == {"src_local", "dst_global", "edge_valid",
                             "edge_weight", "band"}


def test_thin_wrappers():
    rg = program_graph("sssp", "rmat6")
    eng = Engine(TG.partition(to_port(rg), 2), device="cpu")
    np.testing.assert_array_equal(eng.sssp(source=3)[0],
                                  RPROG.sssp_serial(rg, source=3)[0])
    np.testing.assert_array_equal(eng.bfs(source=3)[0],
                                  RPROG.bfs_serial(rg, source=3)[0])
    np.testing.assert_allclose(eng.pagerank(iters=5),
                               rpagerank.pagerank_serial(rg, iters=5),
                               atol=1e-5)
    np.testing.assert_allclose(eng.pagerank_weighted(iters=5),
                               RPROG.pagerank_weighted_serial(rg, iters=5),
                               atol=1e-5)
    gu = program_graph("labelprop", "two_cliques10")
    labels, _ = Engine(TG.partition(to_port(gu), 2),
                       device="cpu").labelprop()
    np.testing.assert_array_equal(labels,
                                  rlabelprop.components_oracle(gu))


def test_serial_references_equal_reference():
    for gname in sorted(EQUIV_GRAPHS):
        rw = program_graph("sssp", gname)
        tw = to_port(rw)
        for fn_t, fn_r in ((TPROG.sssp_serial, RPROG.sssp_serial),
                           (TPROG.bfs_serial, RPROG.bfs_serial)):
            (a, ia), (b, ib) = fn_t(tw, source=1), fn_r(rw, source=1)
            np.testing.assert_array_equal(a, b)
            assert ia == ib
        np.testing.assert_array_equal(TPROG.pagerank_weighted_serial(tw),
                                      RPROG.pagerank_weighted_serial(rw))
        np.testing.assert_array_equal(pagerank.pagerank_serial(tw),
                                      rpagerank.pagerank_serial(rw))
        ru = program_graph("labelprop", gname)
        tu = to_port(ru)
        (a, ia), (b, ib) = (labelprop.labelprop_serial(tu),
                            rlabelprop.labelprop_serial(ru))
        np.testing.assert_array_equal(a, b)
        assert ia == ib
        np.testing.assert_array_equal(labelprop.components_oracle(tu),
                                      rlabelprop.components_oracle(ru))


def test_registry_and_specs_match_reference():
    names = PROGRAMS + ("betweenness", "personalized_pagerank")
    assert sorted(TPROG.registered_names()) == sorted(names)
    assert sorted(RPROG.registered_names()) == sorted(names)
    for name in names:
        t, r = get_spec(name), rget_spec(name)
        for k in ("defaults", "weighted", "undirected", "exact",
                  "returns_iters", "table"):
            assert getattr(t, k) == getattr(r, k), (name, k)
        tp, rp = TPROG.make_program(name), RPROG.make_program(name)
        assert (tp.key, tp.combiner.name, tp.combiner.identity,
                tp.edge_semiring, tp.fixed_iters, tp.max_iters,
                tp.sources) == \
            (rp.key, rp.combiner.name, rp.combiner.identity,
             rp.edge_semiring, rp.fixed_iters, rp.max_iters, rp.sources)
        for hook in ("init_batch", "query_plane", "finalize",
                     "finalize_batch"):
            assert (getattr(tp, hook) is None) == \
                (getattr(rp, hook) is None), (name, hook)
    with pytest.raises(ValueError):
        get_spec("nope")
    with pytest.raises(TypeError):
        TPROG.make_program("pagerank", bogus=1)


def test_run_parallel_and_parallel_entry_points():
    g = port_graph("pagerank", "rmat6")
    got, iters = TPROG.run_parallel(g, "pagerank", num_pes=2,
                                    partitioner="striped", device="cpu")
    assert iters == 20
    np.testing.assert_allclose(
        got, pagerank.pagerank_parallel(g, 2, device="cpu",
                                        partitioner="striped"), atol=1e-6)
    gu = port_graph("labelprop", "ring12")
    labels, _ = labelprop.labelprop_parallel(gu, 2, device="cpu")
    assert np.all(labels == 0)


@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("pes", (1, 2, 8))
def test_wire_model_equals_reference(pes, partitioner):
    rg = graph("rmat10")
    for batch in (1, 4):
        assert cost.wire_model(to_port(rg), pes, partitioner=partitioner,
                               batch=batch) == \
            rcost.wire_model(rg, pes, partitioner=partitioner, batch=batch)


def test_run_cost_on_cpu():
    rep = cost.run_cost(port_graph("pagerank", "rmat6"), "pagerank",
                        pe_counts=(1, 2), repeats=1, device="cpu", iters=2)
    # the reference's default sweep: its four strategies
    assert set(rep.parallel_s) == {("contiguous", s, p)
                                   for s in ALL_STRATEGIES for p in (1, 2)}
    assert rep.serial_s > 0
    assert set(rep.cost) == {("contiguous", s) for s in ALL_STRATEGIES}
    assert rep.dispatch[("contiguous", "basic", 2)]["choice"] == "staged"
    rows = list(rep.rows())
    assert rows[0][0] == "serial" and len(rows) == 9


# ---------------------------------------------------------------------------
# What this slice does not port raises, naming the ROADMAP item
# ---------------------------------------------------------------------------


def test_unported_options_raise():
    pg = TG.partition(port_graph("sssp", "rmat6"), 2)
    eng = Engine(pg, device="cpu")
    # replan, sync="overlap", gate="frontier" and the streamed residency
    # are ported (their cells are tests/test_torch_replan.py,
    # tests/test_torch_async.py and tests/test_torch_stream.py): a resident
    # engine refuses to stream, and a 1-D partition cannot stream at all
    cases = [
        (lambda: eng.run("sssp", residency="stream"), "residency='stream'"),
        (lambda: eng.run_batch("bfs", sources=[0, 1], residency="stream"),
         "residency='stream'"),
        (lambda: Engine(pg, device="cpu", residency="stream"), "grid"),
    ]
    for case, match in cases:
        with pytest.raises(ValueError, match=match):
            case()
    for bad in (dict(replan="nope"), dict(sync="async"),
                dict(gate="bands")):
        with pytest.raises(ValueError):
            eng.run("sssp", **bad)
        with pytest.raises(ValueError):
            eng.run_batch("bfs", sources=[0, 1], **bad)
    with pytest.raises(ValueError):
        Engine(pg, strategy="nope", device="cpu")
    # grid2d needs a grid(R,C) partition
    with pytest.raises(ValueError, match="grid"):
        Engine(pg, strategy="grid2d", device="cpu")
    with pytest.raises(ValueError, match="segment_fn"):
        Engine(pg, device="cpu", segment_fn="kernel")
    with pytest.raises(ValueError):
        eng.run("sssp", sync="bogus")


def test_default_device_is_cuda():
    """Without ``device=`` the engine runs on CUDA, and raises where there
    is none instead of falling back to the CPU."""
    pg = TG.partition(port_graph("bfs", "rmat6"), 1)
    if torch.cuda.is_available():
        assert Engine(pg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(pg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(pg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        cost.run_cost(port_graph("bfs", "rmat6"), "bfs", pe_counts=(1,))
    assert Engine(pg, device="cpu").device.type == "cpu"
