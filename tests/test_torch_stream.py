"""The port's out-of-core streaming (``residency="stream"``) against the JAX
reference, on the CPU.

The twins of the cells of ``tests/test_stream.py`` (all but the scale-20
cells and the warm-cache timing race, which run on the card in
``chip_smoke.py``'s phase ``stream``), of the streamed cells of
``tests/test_multidevice.py`` and of the layout-cache cells of
``tests/test_checkpoint.py``, on the same numpy-made graphs:

* streamed == resident (the port's and ``repro``'s): min programs bit for
  bit with equal superstep counts, per query on the batched plane; the
  PageRanks within ``rtol=1e-5, atol=1e-7`` and two streamed runs
  bit-identical; the serialized run; the frontier gate's exact skips on
  the block chain; the budget sizing and every guard;
* every integer of ``dispatch["stream"]`` equal to ``repro``'s for the same
  graph and config, and the staging slots ``read_window`` fills and the
  window gate masks equal to the reference's;
* the disk layout cache: cold then warm, stale entries, a tampered entry,
  every partitioner's round trip, and entries shared with ``repro`` both
  ways (the same fingerprint);
* the on-device layout build (``REPRO_DEVICE_BUILD=device``, the CPU here)
  bit-identical to the host build and to ``repro``'s, streamed end to end;
* grid(2,2) and grid(2,4) streamed on one device against the serial
  references and the resident plane.
"""

import functools
import json
import os

import numpy as np
import pytest

import repro.core as R
from repro.checkpoint import store as rstore
from repro.core import Engine as REngine
from repro.core import StreamConfig as RStreamConfig
from repro.launch.serve import GraphQueryServer as RServer
from repro_torch.checkpoint import store as tstore
from repro_torch.core import (Engine, ShardSource, StreamConfig, get_spec,
                              graph_from_reference, partition)
from repro_torch.launch.serve import GraphQueryServer

MIN_PROGRAMS = (("sssp", {"source": 3}), ("bfs", {"source": 3}),
                ("labelprop", {}))
STREAM_INTS = ("windows", "blocks_per_window", "window_bytes",
               "resident_edge_bytes", "total_edge_bytes", "supersteps",
               "fetches", "fetched_bytes", "fetch_slots", "fetch_skipped")


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


@functools.lru_cache(maxsize=None)
def ref_graph(scale=11, edges=16000, seed=1):
    return R.random_weights(R.rmat(scale, edges, seed=seed))


@functools.lru_cache(maxsize=None)
def prepared(prog, scale=11, edges=16000, seed=1):
    """The reference's graph for ``prog`` and the port's twin of it."""
    g = R.get_spec(prog).prepare_graph(ref_graph(scale, edges, seed))
    return g, to_port(g)


@functools.lru_cache(maxsize=None)
def block_chain(nblocks=8, per=256):
    """The reference's block chain (``tests/test_stream.py``): each block a
    star from its first vertex, bridged to the next, so a BFS frontier
    stays inside about one vertex block and the gate has windows to skip
    even at grid(1,1)."""
    srcs, dsts = [], []
    for b in range(nblocks):
        lo = b * per
        srcs += [lo] * (per - 1)
        dsts += list(range(lo + 1, lo + per))
        if b + 1 < nblocks:
            srcs.append(lo + 1)
            dsts.append(lo + per)
    g = R.from_edges(nblocks * per, np.array(srcs, np.int32),
                     np.array(dsts, np.int32))
    return g, to_port(g)


def stream_engine(tg, windows=3, eager=True, shape="grid(1,1)", **kw):
    pg = partition(tg, _rects(shape), shape, eager=eager)
    return Engine(pg, device="cpu", residency="stream",
                  stream=StreamConfig(windows=windows, **kw))


def resident_engine(tg, shape="grid(1,1)"):
    return Engine(partition(tg, _rects(shape), shape), device="cpu")


def ref_stream_engine(rg, windows=3, **kw):
    return REngine(R.partition(rg, 1, "grid(1,1)"), residency="stream",
                   stream=RStreamConfig(windows=windows, **kw))


def _rects(shape):
    r, c = R.partitioners.grid_shape(shape)
    return r * c


@functools.lru_cache(maxsize=None)
def ref_resident_run(prog, key, params=()):
    rg = block_chain()[0] if key == "chain" else prepared(prog)[0]
    out, it = REngine(R.partition(rg, 1, "grid(1,1)")).run(prog,
                                                           **dict(params))
    return np.asarray(out), it


@functools.lru_cache(maxsize=None)
def ref_resident_batch(prog, key, sources, B, params=()):
    rg = block_chain()[0] if key == "chain" else prepared(prog)[0]
    out, it = REngine(R.partition(rg, 1, "grid(1,1)")).run_batch(
        prog, sources=list(sources), batch=B, **dict(params))
    return np.asarray(out), np.asarray(it)


def assert_stream_ints(got, want):
    for k in STREAM_INTS:
        if k in want:
            assert got[k] == want[k], (k, got[k], want[k])


# ---------------------------------------------------------------------------
# Residency equivalence: streamed == resident
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prog,params", MIN_PROGRAMS,
                         ids=[p for p, _ in MIN_PROGRAMS])
def test_stream_matches_resident(prog, params):
    """Min programs are bit-exact with equal superstep counts against the
    port's resident engine and ``repro``'s: the window folds chain through
    the min, which is exact."""
    _, tg = prepared(prog)
    ref, ref_it = ref_resident_run(prog, "main", tuple(params.items()))
    res, res_it = resident_engine(tg).run(prog, **params)
    eng = stream_engine(tg)
    got, it = eng.run(prog, **params)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, res)
    assert got.dtype == res.dtype
    assert it == ref_it == res_it
    st = eng.dispatch["stream"]
    assert eng.dispatch["residency"] == "stream"
    assert st["supersteps"] == it
    assert st["fetches"] == it * st["windows"] and st["fetched_bytes"] > 0


@pytest.mark.parametrize("prog", ["pagerank", "pagerank_weighted"])
def test_stream_pagerank_allclose(prog):
    """Add folds reassociate across windows: allclose to resident at the
    reference's tolerance, and two streamed runs bit-identical."""
    _, tg = prepared(prog)
    ref, _ = ref_resident_run(prog, "main")
    res, _ = resident_engine(tg).run(prog)
    eng = stream_engine(tg)
    got, it = eng.run(prog)
    again, _ = eng.run(prog)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, res, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got, again)
    assert it == get_spec(prog).defaults.get("iters", it)


def test_stream_serialized_matches():
    """prefetch=False (the serialized baseline) is exact, only the timing
    differs; its stall is the whole copy."""
    _, tg = prepared("sssp")
    ref, ref_it = ref_resident_run("sssp", "main", (("source", 3),))
    eng = stream_engine(tg, prefetch=False)
    got, it = eng.run("sssp", source=3)
    np.testing.assert_array_equal(got, ref)
    assert it == ref_it
    st = eng.dispatch["stream"]
    assert st["pipelined"] is False
    assert st["stall_s"] == pytest.approx(st["copy_s"])


# ---------------------------------------------------------------------------
# Frontier gating: skipped windows are never fetched
# ---------------------------------------------------------------------------


def test_stream_frontier_gate_exact_and_skips_fetches():
    rg, tg = block_chain()
    ref, ref_it = ref_resident_run("bfs", "chain", (("source", 0),))
    eng = stream_engine(tg, windows=4)
    got, it = eng.run("bfs", source=0, gate="frontier")
    np.testing.assert_array_equal(got, ref)
    assert it == ref_it
    st = eng.dispatch["stream"]
    # every (superstep x window) slot is fetched or skipped, never both
    assert st["fetch_slots"] == st["fetches"] + st["fetch_skipped"]
    assert st["fetch_skip_fraction"] >= 0.4, st
    assert st["fetch_skip_fraction"] == pytest.approx(
        st["fetch_skipped"] / st["fetch_slots"])
    gate = eng.dispatch["gate"]
    assert gate["enabled"] and gate["skipped_fraction"] > 0
    # the same skips, fetches and bytes as the reference's streamed run
    reng = ref_stream_engine(rg, windows=4)
    reng.run("bfs", source=0, gate="frontier")
    assert_stream_ints(st, reng.dispatch["stream"])
    assert gate["skipped_launches"] == \
        reng.dispatch["gate"]["skipped_launches"]


def test_stream_ungated_fetches_every_slot():
    _, tg = prepared("bfs")
    eng = stream_engine(tg, windows=4)
    _, it = eng.run("bfs", source=3)
    st = eng.dispatch["stream"]
    assert st["fetch_skipped"] == 0
    assert st["fetches"] == it * st["windows"]


# ---------------------------------------------------------------------------
# Budget sizing and the guards
# ---------------------------------------------------------------------------


def test_budget_sizes_the_double_buffer():
    rg, tg = prepared("sssp")
    pg = partition(tg, 1, "grid(1,1)")
    total = pg.shard_source(windows=1).total_edge_bytes
    assert total == R.partition(rg, 1, "grid(1,1)").shard_source(
        windows=1).total_edge_bytes
    budget = total // 4
    eng = Engine(pg, device="cpu", residency="stream",
                 stream=StreamConfig(budget_bytes=budget))
    st = eng.dispatch["stream"]
    assert st["budget_bytes"] == budget
    assert st["resident_edge_bytes"] <= budget < st["total_edge_bytes"]
    assert st["edge_fraction_resident"] < 1.0
    reng = REngine(R.partition(rg, 1, "grid(1,1)"), residency="stream",
                   stream=RStreamConfig(budget_bytes=budget))
    assert_stream_ints(st, reng.dispatch["stream"])
    assert st["edge_fraction_resident"] == \
        reng.dispatch["stream"]["edge_fraction_resident"]
    ref, _ = ref_resident_run("sssp", "main", (("source", 3),))
    got, _ = eng.run("sssp", source=3)
    np.testing.assert_array_equal(got, ref)


def test_budget_too_small_raises():
    pg = partition(prepared("sssp")[1], 1, "grid(1,1)")
    with pytest.raises(ValueError, match="budget_bytes"):
        pg.shard_source(budget_bytes=16)


def test_stream_config_validation():
    with pytest.raises(ValueError, match="not both"):
        StreamConfig(windows=4, budget_bytes=1 << 20)
    with pytest.raises(ValueError, match="windows"):
        StreamConfig(windows=0)


def test_stream_needs_grid_partition():
    pg = partition(prepared("sssp")[1], 1, "contiguous")
    with pytest.raises(ValueError, match="grid"):
        Engine(pg, device="cpu", residency="stream")
    with pytest.raises(ValueError, match="grid"):
        pg.shard_source(windows=2)


def test_stream_engine_guards():
    _, tg = prepared("sssp")
    eng = stream_engine(tg)
    with pytest.raises(ValueError, match="resident"):
        eng.run("sssp", source=3, residency="resident")
    with pytest.raises(ValueError, match="unknown residency"):
        eng.run("sssp", source=3, residency="disk")
    # every refusal names the WORKING configuration
    for kw, word in ((dict(sync="overlap"), "overlap"),
                     (dict(replan="grid(1,1)"), "replan")):
        with pytest.raises(ValueError, match=word):
            eng.run("sssp", source=3, **kw)
        with pytest.raises(ValueError, match="resident"):
            eng.run("sssp", source=3, **kw)
        with pytest.raises(ValueError, match="resident"):
            eng.run_batch("sssp", sources=[0, 1], batch=2, **kw)
    # a resident engine refuses to stream (its planes are already up)
    res = resident_engine(tg)
    with pytest.raises(ValueError, match="stream"):
        res.run("sssp", source=3, residency="stream")
    # a stream config without the residency is a construction error
    with pytest.raises(ValueError, match="residency"):
        Engine(partition(tg, 1, "grid(1,1)"), device="cpu",
               stream=StreamConfig(windows=2))
    with pytest.raises(ValueError, match="residency"):
        Engine(partition(tg, 1, "grid(1,1)"), device="cpu",
               residency="disk")


# ---------------------------------------------------------------------------
# The batched query plane: one window upload serves all B columns
# ---------------------------------------------------------------------------


def test_stream_run_batch_no_longer_refuses():
    eng = stream_engine(prepared("sssp")[1])
    plane, q_it = eng.run_batch("sssp", sources=[0, 1], batch=2)
    assert plane.shape[0] == 2 and q_it.shape == (2,)
    assert eng.dispatch["stream"]["batch"] == 2


BATCH_CELLS = [(1, (5,)), (4, (3, 100, 7)), (16, tuple(range(11)))]


@pytest.mark.parametrize("prog", ["sssp", "bfs"])
@pytest.mark.parametrize("B,sources", BATCH_CELLS,
                         ids=[f"B{b}" for b, _ in BATCH_CELLS])
def test_stream_run_batch_matches_resident(prog, B, sources):
    """Streamed run_batch is bit-exact against the resident planes (the
    port's and ``repro``'s) -- values AND per-query superstep counts --
    with ragged convergence and padding columns; the integers of its
    accounting equal the reference's streamed plane's."""
    rg, tg = prepared(prog)
    ref, ref_it = ref_resident_batch(prog, "main", sources, B)
    res, res_it = resident_engine(tg).run_batch(prog, sources=sources,
                                                batch=B)
    eng = stream_engine(tg)
    got, it = eng.run_batch(prog, sources=sources, batch=B)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, res)
    np.testing.assert_array_equal(it, ref_it)
    np.testing.assert_array_equal(it, res_it)
    st = eng.dispatch["stream"]
    assert st["batch"] == B
    assert st["supersteps"] == int(it.max())
    assert st["fetched_bytes_per_query"] == \
        pytest.approx(st["fetched_bytes"] / B)
    if B == 4:
        reng = ref_stream_engine(rg)
        reng.run_batch(prog, sources=list(sources), batch=B)
        assert_stream_ints(st, reng.dispatch["stream"])


def test_stream_batched_bytes_per_query_amortized():
    """B=16 streams at most 1/8 of the edge bytes PER QUERY of B=1, through
    the prefetcher's byte accounting (the reference's bar)."""
    _, tg = prepared("sssp")
    singles = []
    for s in range(4):
        eng = stream_engine(tg)
        eng.run_batch("sssp", sources=[s], batch=1)
        singles.append(eng.dispatch["stream"]["fetched_bytes_per_query"])
    eng = stream_engine(tg)
    eng.run_batch("sssp", sources=list(range(16)), batch=16)
    per_q = eng.dispatch["stream"]["fetched_bytes_per_query"]
    assert per_q <= np.mean(singles) / 8.0, (per_q, singles)


def test_stream_batched_union_frontier_gate():
    """The batched gate skips a window only when it is dead for EVERY live
    query: two chain walks from opposite ends still gate off fetches, bit
    for bit with the resident plane and with the reference's counts."""
    rg, tg = block_chain()
    sources = (0, tg.num_vertices - 256)
    ref, ref_it = ref_resident_batch("bfs", "chain", sources, 2)
    eng = stream_engine(tg, windows=4)
    got, it = eng.run_batch("bfs", sources=sources, batch=2,
                            gate="frontier")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(it, ref_it)
    st = eng.dispatch["stream"]
    assert st["fetch_slots"] == st["fetches"] + st["fetch_skipped"]
    assert st["fetch_skipped"] > 0, st
    reng = ref_stream_engine(rg, windows=4)
    reng.run_batch("bfs", sources=list(sources), batch=2, gate="frontier")
    assert_stream_ints(st, reng.dispatch["stream"])


def test_stream_batched_ppr_and_run_routing():
    """The fixed-iteration query plane streams too, and ``run`` of a
    multi-source program routes through the streamed plane."""
    _, tg = prepared("personalized_pagerank")
    res = resident_engine(tg)
    ref, ref_it = ref_resident_batch("personalized_pagerank", "main", (3, 7),
                                     2, (("iters", 5),))
    want, want_it = res.run_batch("personalized_pagerank", sources=[3, 7],
                                  batch=2, iters=5)
    eng = stream_engine(tg)
    got, it = eng.run_batch("personalized_pagerank", sources=[3, 7],
                            batch=2, iters=5)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(it, ref_it)
    np.testing.assert_array_equal(it, want_it)
    ref1, _ = res.run("personalized_pagerank", seeds=[3, 7], iters=5)
    got1, _ = stream_engine(tg).run("personalized_pagerank", seeds=[3, 7],
                                    iters=5)
    np.testing.assert_allclose(got1, ref1, rtol=1e-5, atol=1e-7)


def test_stream_betweenness_routes_through_the_plane():
    """Betweenness (multi-source pivots) runs on the streamed plane and
    equals the resident engine's, with the same superstep count."""
    rg, tg = prepared("betweenness")
    pivots = (0, 1, 2, 3)
    want, want_it = resident_engine(tg).run("betweenness", pivots=pivots)
    ref, ref_it = REngine(R.partition(rg, 1, "grid(1,1)")).run(
        "betweenness", pivots=pivots)
    eng = stream_engine(tg)
    got, it = eng.run("betweenness", pivots=pivots)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert it == want_it == ref_it
    assert eng.dispatch["stream"]["batch"] == 4


def test_stream_served_queries_match_resident():
    """A GraphQueryServer over a streamed engine drains mixed traffic and
    every row equals the same server's over the resident engines (the
    port's and ``repro``'s)."""
    rg, tg = prepared("bfs")

    def serve(server):
        ids = [server.submit("bfs", s) for s in (3, 100, 7, 9, 2)]
        server.drain()
        return {i: server.result(i) for i in ids}

    ref = serve(RServer(REngine(R.partition(rg, 1, "grid(1,1)")), batch=4))
    res = serve(GraphQueryServer(resident_engine(tg), batch=4))
    got = serve(GraphQueryServer(stream_engine(tg), batch=4))
    assert ref.keys() == got.keys() == res.keys()
    for i in ref:
        np.testing.assert_array_equal(got[i][0], np.asarray(ref[i][0]))
        np.testing.assert_array_equal(got[i][0], res[i][0])
        assert got[i][1] == ref[i][1] == res[i][1]


# ---------------------------------------------------------------------------
# The staging slots and window gates, against the reference's
# ---------------------------------------------------------------------------


def test_read_window_and_gate_masks_equal_reference():
    """``read_window`` fills the reference's slot (the valid plane, the
    band slice, every active row's planes) and counts the reference's
    bytes, for the ragged tail and with rectangles gated off; the window
    gate masks and the fetch schedule are the reference's."""
    rg = prepared("sssp")[0]
    tg = prepared("sssp")[1]
    rsb = R.partition(rg, 8, "grid(2,4)").shard_source(windows=3)
    tsb = partition(tg, 8, "grid(2,4)").shard_source(windows=3)
    assert isinstance(tsb, ShardSource)
    nsb = 4
    np.testing.assert_array_equal(tsb.gate_masks(nsb), rsb.gate_masks(nsb))
    fb = np.random.default_rng(0).random((8, nsb)) < 0.3
    gm = tsb.gate_masks(nsb)
    np.testing.assert_array_equal(tsb.active_windows(gm, fb),
                                  rsb.active_windows(gm, fb))
    rst, tst = rsb.make_staging(), tsb.make_staging()
    active = np.array([1, 0, 1, 1, 0, 1, 1, 1], dtype=bool)
    for k in range(tsb.num_windows):
        for act in (None, active, np.zeros(8, dtype=bool)):
            assert tsb.read_window(k, tst, act) == \
                rsb.read_window(k, rst, act)
            live = np.ones(8, bool) if act is None else act
            np.testing.assert_array_equal(tst["gr_edge_valid"],
                                          rst["gr_edge_valid"])
            np.testing.assert_array_equal(tst["gr_band"], rst["gr_band"])
            np.testing.assert_array_equal(tst["row_active"],
                                          live.astype(np.int32))
            for name in ("gr_src_local", "gr_dst_col", "gr_edge_weight"):
                np.testing.assert_array_equal(tst[name][live],
                                              rst[name][live])


# ---------------------------------------------------------------------------
# The disk layout cache
# ---------------------------------------------------------------------------


def test_disk_cache_cold_then_warm_bit_exact(tmp_path):
    _, tg = prepared("sssp")
    ref, ref_it = ref_resident_run("sssp", "main", (("source", 3),))
    d = str(tmp_path / "layouts")
    cold_eng = stream_engine(tg, cache_dir=d)
    cold, it_c = cold_eng.run("sssp", source=3)
    assert len([e for e in os.listdir(d) if e.startswith("layout_")]) == 1
    # eager=False defers the build, so a warm hit memory-maps the cached
    # planes and never sorts
    warm_eng = stream_engine(tg, cache_dir=d, eager=False)
    warm, it_w = warm_eng.run("sssp", source=3)
    assert warm_eng.dispatch["stream"]["origin"] == "disk"
    assert warm_eng.pg.layout_builds["grid"] == "disk"
    for got, it in ((cold, it_c), (warm, it_w)):
        np.testing.assert_array_equal(got, ref)
        assert it == ref_it


def test_stale_cache_entry_is_a_miss(tmp_path):
    d = str(tmp_path / "layouts")
    partition(to_port(ref_graph(seed=1)), 1, "grid(1,1)",
              eager=False).shard_source(windows=2, cache_dir=d)
    sb = partition(to_port(ref_graph(seed=2)), 1, "grid(1,1)",
                   eager=False).shard_source(windows=2, cache_dir=d)
    assert sb.origin == "memory"  # the second graph missed and rebuilt
    assert len([e for e in os.listdir(d) if e.startswith("layout_")]) == 2


@functools.lru_cache(maxsize=None)
def cache_graph(seed=4):
    return R.random_weights(R.rmat(9, 1500, seed=seed), seed=seed)


@pytest.mark.parametrize("spec,chunks", [
    ("contiguous", 4), ("edge_balanced", 4), ("striped", 4),
    ("degree_sorted", 4), ("grid(1,1)", 1), ("grid(2,2)", 4),
    ("grid(2,4)", 8),
])
def test_layout_cache_roundtrip_bit_identical(tmp_path, spec, chunks):
    """Every partitioner and grid shape: the memory-mapped warm entry is
    byte for byte the cold build, and the reference's."""
    g = cache_graph()
    tg = to_port(g)
    which = "grid" if spec.startswith("grid") else "basic"
    d = str(tmp_path / "layouts")
    built = partition(tg, chunks, spec).cached_layout(which, d)
    warm = partition(tg, chunks, spec, eager=False).cached_layout(which, d)
    assert any(isinstance(a, np.memmap) for a in warm)
    ref = R.partition(g, chunks, spec)._layout(which)
    for a, b, r, name in zip(built, warm, ref,
                             ("src", "dst", "weight", "band")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"{spec} {name}")
        np.testing.assert_array_equal(np.asarray(b), np.asarray(r),
                                      err_msg=f"{spec} {name}")


def test_layout_cache_distinct_inputs_never_collide():
    """Graph bytes, partitioner, chare count and layout name all feed the
    fingerprint, and every fingerprint is the reference's."""
    g1, g2 = cache_graph(4), cache_graph(5)
    cases = [(g1, "grid(2,2)", 4, "grid"), (g2, "grid(2,2)", 4, "grid"),
             (g1, "grid(4,1)", 4, "grid"), (g1, "grid(2,2)", 4, "basic"),
             (g1, "contiguous", 4, "basic")]
    fps = [tstore.layout_fingerprint(to_port(g), *rest)
           for g, *rest in cases]
    assert len(set(fps)) == 5
    assert fps == [rstore.layout_fingerprint(g, *rest) for g, *rest in cases]


def test_layout_cache_tampered_entry_rejected(tmp_path):
    """A stored fingerprint that disagrees with the requested one raises
    instead of serving wrong shards; an absent entry is a clean miss."""
    tg = to_port(cache_graph())
    d = str(tmp_path / "layouts")
    partition(tg, 4, "grid(2,2)").cached_layout("grid", d)
    fp = tstore.layout_fingerprint(tg, "grid(2,2)", 4, "grid")
    meta = os.path.join(d, f"layout_{fp[:16]}", "meta.json")
    with open(meta) as f:
        m = json.load(f)
    m["fingerprint"] = "0" * 64
    with open(meta, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="stale"):
        tstore.open_layout_cache(d, fp)
    assert tstore.open_layout_cache(d, "f" * 64) is None


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_layout_cache_shared_with_reference(tmp_path, writer):
    """An entry written by either package is a warm hit for the other,
    with the same planes."""
    g = cache_graph()
    tg = to_port(g)
    d = str(tmp_path / "layouts")
    if writer == "repro":
        R.partition(g, 4, "grid(2,2)").cached_layout("grid", d)
        pg = partition(tg, 4, "grid(2,2)", eager=False)
        got = pg.cached_layout("grid", d)
        assert pg.layout_builds["grid"] == "disk"
        want = R.partition(g, 4, "grid(2,2)")._layout("grid")
    else:
        partition(tg, 4, "grid(2,2)").cached_layout("grid", d)
        got = R.partition(g, 4, "grid(2,2)", eager=False).cached_layout(
            "grid", d)
        want = partition(tg, 4, "grid(2,2)")._layout("grid")
    assert all(isinstance(a, np.memmap) for a in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert len(os.listdir(d)) == 1


# ---------------------------------------------------------------------------
# The on-device layout build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,chunks", [("grid(1,1)", 1), ("grid(2,4)", 8),
                                         ("contiguous", 4)])
def test_device_build_bit_identical(monkeypatch, spec, chunks):
    """The torch build (``REPRO_DEVICE_BUILD=device``; on the CPU here)
    gives the host build's planes and band table bit for bit, and the
    reference's; ``layout_builds`` records which build ran."""
    g = R.random_weights(R.rmat(12, 30000, seed=7))
    tg = to_port(g)
    which = "grid" if spec.startswith("grid") else "sd"

    def layout(mode):
        monkeypatch.setenv("REPRO_DEVICE_BUILD", mode)
        pg = partition(tg, chunks, spec, eager=False)
        return pg._layout(which), pg.layout_builds[which]

    host, hb = layout("host")
    dev, db = layout("device")
    auto, ab = layout("auto")  # below 2^21 edges: the host build
    assert (hb, db, ab) == ("host", "cpu", "host")
    ref = R.partition(g, chunks, spec)._layout(which)
    for h, d, r, name in zip(host, dev, ref, ("src", "dst", "weight",
                                              "band")):
        np.testing.assert_array_equal(d, h, err_msg=name)
        np.testing.assert_array_equal(d, np.asarray(r), err_msg=name)
        assert d.dtype == h.dtype


def test_device_build_streamed_end_to_end(monkeypatch):
    """The device-built layout feeds the streamed run unchanged."""
    _, tg = prepared("sssp")
    ref, ref_it = ref_resident_run("sssp", "main", (("source", 3),))
    monkeypatch.setenv("REPRO_DEVICE_BUILD", "device")
    eng = stream_engine(tg)
    assert eng.pg.layout_builds["grid"] == "cpu"
    got, it = eng.run("sssp", source=3)
    np.testing.assert_array_equal(got, ref)
    assert it == ref_it


# ---------------------------------------------------------------------------
# Multi-rectangle streamed cells (tests/test_multidevice.py's, on one
# device: the rectangles are the chare axis)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def multi_graph():
    g = R.random_weights(R.rmat(10, 6000, seed=3), seed=5)
    return g, to_port(g)


@pytest.mark.parametrize("shape", ["grid(2,2)", "grid(2,4)"])
def test_multi_rectangle_streamed_cells(shape, tmp_path):
    """sssp and bfs with and without the gate, and B=8 planes of five
    sources, streamed through the layout cache on 4 or 8 rectangles:
    bit-exact against the serial references and the resident engine with
    equal superstep counts; slots are rectangle-granular and fetches
    window-granular; a second engine warm-starts off the cache."""
    rg, tg = multi_graph()
    pes = _rects(shape)
    cache = str(tmp_path / "cache")
    res = resident_engine(tg, shape)
    eng = stream_engine(tg, windows=4, eager=False, shape=shape,
                        cache_dir=cache)
    skip_max = 0.0
    for prog in ("sssp", "bfs"):
        ref, ref_it = getattr(R, f"{prog}_serial")(rg, 7)
        want, want_it = res.run(prog, source=7)
        for gate in (None, "frontier"):
            got, it = eng.run(prog, source=7, gate=gate)
            np.testing.assert_array_equal(got, np.asarray(ref))
            np.testing.assert_array_equal(got, want)
            assert it == ref_it == want_it
            st = eng.dispatch["stream"]
            assert st["fetch_slots"] == pes * st["windows"] * it
            assert st["fetches"] <= st["windows"] * it
            assert st["fetch_skipped"] <= st["fetch_slots"]
            assert st["supersteps"] == it
            if gate:
                skip_max = max(skip_max, st["fetch_skip_fraction"])
        sources = [7, 100, 3, 250, 9]
        bwant, bwant_it = res.run_batch(prog, sources=sources, batch=8)
        got, it = eng.run_batch(prog, sources=sources, batch=8)
        np.testing.assert_array_equal(got, bwant)
        np.testing.assert_array_equal(it, bwant_it)
        st = eng.dispatch["stream"]
        assert st["batch"] == 8 and st["supersteps"] == int(it.max())
        assert st["fetched_bytes_per_query"] == st["fetched_bytes"] / 8
    assert 0.0 <= skip_max <= 1.0
    warm = stream_engine(tg, windows=4, eager=False, shape=shape,
                         cache_dir=cache)
    assert warm.dispatch["stream"]["origin"] == "disk"
    got, it = warm.run("sssp", source=7)
    ref, ref_it = R.sssp_serial(rg, 7)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert it == ref_it
