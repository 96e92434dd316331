"""The port's barrier relaxation (``sync="overlap"``) and frontier gating
(``gate="frontier"``) against the JAX reference, on the CPU.

The twins of ``tests/test_async.py`` and of the async properties of
``tests/test_properties.py``, with the port's kernels' plain versions:

* overlap against barrier for sssp and bfs under the four strategies: both
  bit-exact against serial, the barrier count the serial one, the overlap
  count the reference's and within ``it_b <= it_o <= 2 * it_b + 2``;
* overlap plus gate bit-exact, and ``dispatch["gate"]`` equal to
  ``repro.Engine``'s at C=1 (with the gate off: nothing skipped);
* a replan in the middle of overlap drains; the batched plane's overlap
  holds per query; ``_validate_async`` raises the reference's messages;
* the gate's geometry (``band_source_mask``, ``device_gate_blocks``)
  equal to the reference's, and sound;
* ``async_min_fixpoint_ref`` equal to the reference's for the same
  schedules;
* C=2, C=8 and grid(2,4) against serial, their gate counts against a
  numpy recount from the frontiers the run went through, and the row mask
  the push hook received equal to that recount;
* the gated plain kernels: a gated row is its ``init`` row or the
  identity, an active row the call without the gate.
"""

import functools

import numpy as np
import pytest
import torch

from conftest import ALL_STRATEGIES, program_graph
from repro.core import Engine as REngine
from repro.core import graph as RG
from repro.core import partition as rpartition
from repro.core import programs as RPROG
from repro.core.engine import ReplanPolicy as RReplanPolicy
from repro.kernels import blocks as RB
from repro.kernels import ref as rref
from repro_torch.core import Engine, ReplanPolicy, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import programs as TPROG
from repro_torch.core import strategies as TS
from repro_torch.kernels import blocks as TB
from repro_torch.kernels import ops, push_fused, push_staged, ref

G = RG.rmat(7, 600, seed=3)
GW = RG.random_weights(G, seed=5)
SSSP_REF, SSSP_IT = RPROG.sssp_serial(GW, source=7)
BFS_REF, BFS_IT = RPROG.bfs_serial(G, source=7)


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


TGR, TGW = to_port(G), to_port(GW)


def case(algo):
    return ((GW, TGW, SSSP_REF, SSSP_IT) if algo == "sssp"
            else (G, TGR, BFS_REF, BFS_IT))


@functools.lru_cache(maxsize=None)
def reference(algo, strategy, sync, gate):
    g = case(algo)[0]
    eng = REngine(rpartition(g, 1), strategy=strategy)
    out, it = eng.run(algo, source=7, sync=sync, gate=gate)
    return np.asarray(out), int(it), dict(eng.dispatch["gate"])


# -- overlap against barrier -------------------------------------------------


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_overlap_matches_barrier(algo, strategy):
    _, tg, want, want_it = case(algo)
    eng = Engine(TG.partition(tg, 1), strategy=strategy, device="cpu")
    got_b, it_b = eng.run(algo, source=7)
    got_o, it_o = eng.run(algo, source=7, sync="overlap")
    np.testing.assert_array_equal(got_b, want)
    np.testing.assert_array_equal(got_o, want)
    assert it_b == want_it
    assert it_b <= it_o <= 2 * it_b + 2
    assert it_o == reference(algo, strategy, "overlap", None)[1]


@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("sync", ["barrier", "overlap"])
@pytest.mark.parametrize("algo", ["sssp", "bfs"])
def test_gate_accounting_equals_reference(algo, sync, strategy):
    _, tg, want, _ = case(algo)
    eng = Engine(TG.partition(tg, 1), strategy=strategy, device="cpu")
    got, it = eng.run(algo, source=7, sync=sync, gate="frontier")
    r_out, r_it, r_gate = reference(algo, strategy, sync, "frontier")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, r_out)
    assert it == r_it
    assert eng.dispatch["gate"] == r_gate


def test_overlap_gate_bit_exact_and_accounted():
    eng = Engine(TG.partition(TGW, 1), device="cpu")
    got, it = eng.run("sssp", source=7, sync="overlap", gate="frontier")
    np.testing.assert_array_equal(got, SSSP_REF)
    rec = eng.dispatch["gate"]
    assert rec["sync"] == "overlap" and rec["enabled"]
    assert rec["launch_slots"] == it + 1  # the pre-loop seed push
    assert rec["launched"] + rec["skipped_launches"] == rec["launch_slots"]
    # the pipeline alternates live and empty frontiers: at one chare the
    # gate skips the empty half
    assert rec["skipped_fraction"] >= 0.4
    got_b, it_b = eng.run("sssp", source=7, gate="frontier")
    np.testing.assert_array_equal(got_b, SSSP_REF)
    rec_b = eng.dispatch["gate"]
    assert rec_b["sync"] == "barrier" and rec_b["launch_slots"] == it_b
    assert rec_b["skipped_launches"] <= rec_b["launch_slots"]


@pytest.mark.parametrize("sync", ["barrier", "overlap"])
def test_gate_off_records_zero(sync):
    eng = Engine(TG.partition(TGR, 1), device="cpu")
    _, it = eng.run("bfs", source=7, sync=sync)
    rec = eng.dispatch["gate"]
    assert not rec["enabled"]
    assert rec["skipped_launches"] == 0
    assert rec["skipped_fraction"] == 0.0
    assert rec == reference("bfs", "sortdest", sync, None)[2]
    eng.run("pagerank", iters=3)
    assert eng.dispatch["gate"]["launch_slots"] == 3
    assert eng.dispatch["gate"]["skipped_launches"] == 0


def test_replan_mid_overlap_drains():
    policy = dict(partitioner="edge_balanced", every=2, mode="always")
    got, it = TPROG.run_parallel(TGW, "sssp", source=7, sync="overlap",
                                 gate="frontier", device="cpu",
                                 replan=ReplanPolicy(**policy))
    np.testing.assert_array_equal(got, SSSP_REF)
    assert it <= 2 * SSSP_IT + 2
    want, want_it = RPROG.run_parallel(GW, "sssp", source=7, sync="overlap",
                                       gate="frontier",
                                       replan=RReplanPolicy(**policy))
    assert it == want_it


@pytest.mark.parametrize("strategy", ["reduction", "basic"])
def test_batch_overlap_per_query(strategy):
    srcs = [7, 0, 91]
    eng = Engine(TG.partition(TGW, 1), strategy=strategy, device="cpu")
    plane, q_it = eng.run_batch("sssp", sources=srcs, batch=4,
                                sync="overlap", gate="frontier")
    for i, s in enumerate(srcs):
        want, want_it = RPROG.sssp_serial(GW, source=s)
        np.testing.assert_array_equal(plane[i], want)
        assert want_it <= int(q_it[i]) <= 2 * want_it + 2
    reng = REngine(rpartition(GW, 1), strategy=strategy)
    rplane, r_it = reng.run_batch("sssp", sources=srcs, batch=4,
                                  sync="overlap", gate="frontier")
    np.testing.assert_array_equal(q_it, np.asarray(r_it))
    np.testing.assert_array_equal(plane, np.asarray(rplane))
    assert eng.dispatch["gate"] == reng.dispatch["gate"]


def test_betweenness_overlaps_through_run():
    eng = Engine(TG.partition(TGR, 2), device="cpu")
    want, _ = eng.run("betweenness", pivots=(7, 0))
    got, _ = eng.run("betweenness", pivots=(7, 0), sync="overlap",
                     gate="frontier")
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_validate_async_errors():
    eng = Engine(TG.partition(TGR, 1), device="cpu")
    with pytest.raises(ValueError, match="min-monoid"):
        eng.run("pagerank", sync="overlap")
    with pytest.raises(ValueError, match="convergence"):
        eng.run("pagerank", gate="frontier")
    with pytest.raises(ValueError, match="sync"):
        eng.run("bfs", source=0, sync="async")
    with pytest.raises(ValueError, match="gate"):
        eng.run("bfs", source=0, gate="bands")
    with pytest.raises(ValueError, match="min-monoid"):
        eng.run_batch("personalized_pagerank", sources=[0], sync="overlap")
    with pytest.raises(ValueError, match="collectives"):
        Engine(TG.partition(TGR, 1), collectives="ring", device="cpu")


# -- the gate's geometry -----------------------------------------------------


def test_band_source_mask_geometry():
    band = np.zeros((2, 4, 2), np.int32)
    band[0, 0] = [0, 2]
    band[0, 1] = [1, 3]
    band[1, 0] = [4, 0]
    band[1, 1] = [4, -1]
    want = np.array([[1, 1, 1, 1, 0, 0],
                     [0, 0, 0, 0, 1, 0]], np.int32)
    np.testing.assert_array_equal(TB.band_source_mask(band, 6), want)
    np.testing.assert_array_equal(TB.band_source_mask(band[0], 6), want[:1])


@pytest.mark.parametrize("seed", range(8))
def test_band_source_mask_equals_reference(seed):
    rng = np.random.default_rng(seed)
    C, NB, n = (int(rng.integers(1, 5)), int(rng.integers(1, 40)),
                int(rng.integers(1, 30)))
    band = np.zeros((C, 4, NB), np.int32)
    band[:, 0] = rng.integers(-2, n + 3, (C, NB))
    band[:, 1] = band[:, 0] + rng.integers(-3, 8, (C, NB))
    np.testing.assert_array_equal(TB.band_source_mask(band, n),
                                  RB.band_source_mask(band, n))


@pytest.mark.parametrize("pes,partitioner,strategy", [
    (1, "contiguous", "sortdest"), (4, "contiguous", "reduction"),
    (4, "striped", "basic"), (8, "grid(2,4)", "sortdest")])
def test_engine_gate_blocks_equal_reference(pes, partitioner, strategy):
    eng = Engine(TG.partition(TGW, pes, partitioner), strategy=strategy,
                 device="cpu")
    gm = eng.gate_blocks
    assert gm.dtype == torch.bool and gm.shape == (pes, eng._gate_nsb)
    if pes == 1:  # the reference engine needs one device per chare
        reng = REngine(rpartition(GW, 1), strategy=strategy)
        assert eng._gate_nsb == reng._gate_nsb
        want = np.asarray(reng.arrays["gate_blocks"])
    else:  # what the reference's _bind computes on its partition
        rpg = rpartition(GW, pes, partitioner)
        band = ("gr_band" if rpg.is_grid else
                {"reduction": "band", "sortdest": "sd_band"}.get(strategy))
        want = (np.ones((pes, eng._gate_nsb), np.int32) if band is None
                else RB.band_source_mask(np.asarray(getattr(rpg, band)),
                                         eng._gate_nsb))
    np.testing.assert_array_equal(gm.numpy().astype(np.int32), want)
    # shared per layout: a second engine aliases the same tensor
    assert Engine(eng.pg, strategy=strategy, device="cpu").gate_blocks is gm


@pytest.mark.parametrize("seed", range(6))
def test_gate_mask_is_conservative(seed):
    """When a chare's source blocks miss every live frontier block, no valid
    edge of that chare reads a frontier vertex."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 600))
    e = int(rng.integers(1, 250))
    g = TG.from_edges(n, rng.integers(0, n, e).astype(np.int32),
                      rng.integers(0, n, e).astype(np.int32))
    pg = TG.partition(g, int(rng.integers(1, 4)))
    nsb = max(-(-pg.chunk_size // TB.BLOCK_V), 1)
    gmask = pg.device_gate_blocks("sd", "cpu").numpy()
    for c in range(pg.num_chunks):
        frontier = rng.integers(0, 2, size=pg.chunk_size).astype(np.int32)
        fb = TB.frontier_block_mask(frontier, nsb).astype(bool)
        live = pg.sd_edge_valid[c] == 1
        if not (gmask[c] & fb).any():
            assert not frontier[pg.sd_src_local[c][live]].any()


# -- the stale-read simulator ------------------------------------------------


def _sssp_init(g, source):
    init = np.full(g.num_vertices, np.inf, np.float32)
    init[source] = 0.0
    return init


@pytest.mark.parametrize("max_stale,seed", [(0, 0), (1, 0), (1, 1), (2, 2),
                                            (3, 1)])
def test_async_ref_equals_reference(max_stale, seed):
    w = np.asarray(GW.edge_weights, np.float32)
    args = (np.asarray(GW.src), np.asarray(GW.dst), _sssp_init(GW, 7))
    got, sweeps = ref.async_min_fixpoint_ref(*args, weight=w,
                                             max_stale=max_stale, seed=seed)
    want, want_sweeps = rref.async_min_fixpoint_ref(
        *args, weight=w, max_stale=max_stale, seed=seed)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, SSSP_REF)
    assert sweeps == want_sweeps
    assert sweeps <= (max_stale + 1) * (SSSP_IT + 1)


def test_async_ref_explicit_schedule_and_bfs():
    src, dst = np.asarray(GW.src), np.asarray(GW.dst)
    w = np.asarray(GW.edge_weights, np.float32)
    ages = np.full((1, len(src)), 2)
    got, n = ref.async_min_fixpoint_ref(src, dst, _sssp_init(GW, 7),
                                        weight=w, max_stale=2, ages=ages)
    want, m = rref.async_min_fixpoint_ref(src, dst, _sssp_init(GW, 7),
                                          weight=w, max_stale=2, ages=ages)
    np.testing.assert_array_equal(got, want)
    assert n == m
    got, _ = ref.async_min_fixpoint_ref(
        np.asarray(G.src), np.asarray(G.dst), _sssp_init(G, 7),
        weight=np.ones(G.num_edges, np.float32), max_stale=1, seed=4)
    sentinel = np.iinfo(np.int32).max
    want = np.where(np.asarray(BFS_REF) >= sentinel, np.inf,
                    np.asarray(BFS_REF, np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


# -- multi-chare and grid gating against serial and a host recount ----------


def _recount(eng):
    """Wrap ``eng._push`` and the push hook: record, per gated push, the
    frontier it saw and the row mask the hook received.  Returns the lists
    the run fills."""
    seen, masks = [], []
    push = eng._push

    def recording(program, vals, frontier=None, gate=False):
        if gate:
            seen.append(frontier.clone())
        return push(program, vals, frontier, gate)

    eng._push = recording
    if eng.push_fn is not None:
        hook = eng.push_fn

        def hooked(*args, **kw):
            masks.append(kw.get("row_active"))
            return hook(*args, **kw)

        eng.push_fn = hooked
    return seen, masks


def _expected_active(eng, frontier):
    """numpy: which chare rows a frontier leaves active."""
    f = frontier.numpy()
    if f.ndim == 3:
        f = f.any(axis=-1)
    nsb = eng._gate_nsb
    layout = TS.STRATEGY_LAYOUT[eng.strategy]
    band = {"basic": "band", "sd": "sd_band", "grid": "gr_band"}.get(layout)
    gmask = (RB.band_source_mask(getattr(eng.pg, band), nsb) != 0
             if band else np.ones((eng._C, nsb), bool))
    return np.array([(RB.frontier_block_mask(f[c], nsb).astype(bool)
                      & gmask[c]).any() for c in range(eng._C)])


@pytest.mark.parametrize("sync", ["barrier", "overlap"])
@pytest.mark.parametrize("pes,partitioner,strategy", [
    (2, "contiguous", "sortdest"), (8, "contiguous", "sortdest"),
    (8, "striped", "reduction"), (8, "contiguous", "basic"),
    (8, "degree_sorted", "pairs"), (8, "grid(2,4)", "sortdest")])
def test_gate_counts_equal_host_recount(pes, partitioner, strategy, sync):
    eng = Engine(TG.partition(TGW, pes, partitioner), strategy=strategy,
                 device="cpu")
    seen, masks = _recount(eng)
    got, it = eng.run("sssp", source=7, sync=sync, gate="frontier")
    np.testing.assert_array_equal(got, SSSP_REF)
    rec = eng.dispatch["gate"]
    active = [_expected_active(eng, f) for f in seen]
    assert len(seen) == it + (sync == "overlap")
    assert rec["launch_slots"] == pes * len(seen)
    assert rec["skipped_launches"] == sum(int((~a).sum()) for a in active)
    if masks:  # the hook got the same mask, as a [C] int32 tensor
        for a, m in zip(active, masks):
            assert m.dtype == torch.int32
            np.testing.assert_array_equal(m.numpy() != 0, a)
    if sync == "overlap":  # the empty half of the pipeline is skipped
        assert rec["skipped_launches"] > 0
    base, base_it = Engine(TG.partition(TGW, pes, partitioner),
                           strategy=strategy, device="cpu").run(
        "sssp", source=7, sync=sync)
    np.testing.assert_array_equal(got, base)
    assert it == base_it


@pytest.mark.parametrize("pes,partitioner", [(8, "contiguous"),
                                             (8, "grid(2,4)")])
def test_gated_batch_plane_against_serial_and_recount(pes, partitioner):
    srcs = [7, 0, 91, 5]
    eng = Engine(TG.partition(TGR, pes, partitioner), device="cpu")
    seen, _ = _recount(eng)
    plane, q_it = eng.run_batch("bfs", sources=srcs, sync="overlap",
                                gate="frontier")
    for i, s in enumerate(srcs):
        want, want_it = RPROG.bfs_serial(G, source=s)
        np.testing.assert_array_equal(plane[i], want)
        assert want_it <= int(q_it[i]) <= 2 * want_it + 2
    rec = eng.dispatch["gate"]
    assert rec["skipped_launches"] == sum(
        int((~_expected_active(eng, f)).sum()) for f in seen)


# -- the gated plain kernels --------------------------------------------------


def _layout(seed, C=3, E=700, V=300, S=400):
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, V, (C, E)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, S, (C, E)).astype(np.int32))
    valid = torch.from_numpy((rng.random((C, E)) < 0.9).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.5, 2.0, (C, E)).astype(np.float32))
    return rng, src, dst, valid, w, V, S


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("combine,dtype", [("add", torch.float32),
                                           ("min", torch.float32),
                                           ("min", torch.int32)])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("seeded", [False, True])
def test_gated_push_rows(fused, combine, dtype, batch, seeded):
    rng, src, dst, valid, w, V, S = _layout(3)
    C = src.shape[0]
    tail = () if batch is None else (batch,)
    vals = torch.from_numpy(rng.uniform(0, 50, (C, V) + tail)).to(dtype)
    init = None
    if seeded:
        init = torch.from_numpy(rng.uniform(0, 60, (C, S) + tail)).to(dtype)
    weight = w if combine == "add" else w.to(dtype) if dtype.is_floating_point \
        else torch.ones_like(src)
    row_active = torch.tensor([1, 0, 1], dtype=torch.int32)
    kw = dict(combine=combine, weight=weight, fused=fused, init=init)
    full = ops.push(vals, src, dst, valid, S, **kw)
    gated = ops.push(vals, src, dst, valid, S, row_active=row_active, **kw)
    assert torch.equal(gated[0], full[0]) and torch.equal(gated[2], full[2])
    if init is not None:
        want = init.to(gated.dtype)
    else:
        ident = 0 if combine == "add" else (float("inf")
                                           if dtype.is_floating_point
                                           else ref.SENTINEL)
        want = torch.full_like(gated, ident)
    assert torch.equal(gated[1], want[1])
    allgated = ops.push(vals, src, dst, valid, S,
                        row_active=torch.zeros(C, dtype=torch.int32), **kw)
    assert torch.equal(allgated, want)


def test_gated_kernels_plain_versions():
    rng, src, dst, valid, w, V, S = _layout(5)
    vals = torch.from_numpy(rng.uniform(0, 9, (3, V))).float()
    ra = torch.tensor([0, 1, 1], dtype=torch.int32)
    for gather, fill in ((push_staged.gather_sum, 0.0),
                         (push_staged.gather_min, push_fused.SENTINEL_F32)):
        full, got = gather(src, valid, vals), gather(src, valid, vals, ra)
        assert torch.equal(got[1:], full[1:])
        assert torch.equal(got[0], torch.full_like(got[0], fill))
    c = torch.from_numpy(rng.uniform(0, 9, src.shape)).float()
    for scatter, fill in ((push_staged.scatter_sum, 0.0),
                          (push_staged.scatter_min, push_fused.SENTINEL_F32)):
        full, got = scatter(dst, c, S), scatter(dst, c, S, ra)
        assert torch.equal(got[1:], full[1:])
        assert torch.equal(got[0], torch.full_like(got[0], fill))
    out = ops.segment_reduce(c, dst, S, combine="min", row_active=ra)
    assert torch.isinf(out[0]).all()
    # fused_push_plain: the same through the padded kernel operands
    pad = (-src.shape[1]) % TB.BLOCK_E
    p = lambda t, f: torch.cat([t, torch.full((3, pad), f, dtype=t.dtype)], 1)
    sp, dp, vp = p(src, 0), p(dst, 0), p(valid, 0)
    full = push_fused.fused_push_plain(None, sp, dp, vp, None, vals, S,
                                       combine="add")
    got = push_fused.fused_push(None, sp, dp, vp, None, vals, S,
                                combine="add", row_active=ra)
    assert torch.equal(got[1:], full[1:]) and not got[0].any()


def test_row_gate_is_checked():
    rng, src, dst, valid, w, V, S = _layout(7)
    vals = torch.zeros((3, V))
    with pytest.raises(ValueError, match="1-D"):
        ops.push(vals[0], src[0], dst[0], valid[0], S,
                 row_active=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="1-D"):
        push_staged.gather_sum(src[0], valid[0], vals[0],
                               torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="row_active"):
        ops.push(vals, src, dst, valid, S,
                 row_active=torch.ones(2, dtype=torch.int32))
    with pytest.raises(TypeError, match="row_active"):
        ops.push(vals, src, dst, valid, S, row_active=torch.ones(3))


@pytest.mark.parametrize("strategy", ALL_STRATEGIES + ("grid2d",))
def test_phase1_identity_is_what_an_all_gated_push_gives(strategy):
    pes, part = (8, "grid(2,4)") if strategy == "grid2d" else (4, "striped")
    eng = Engine(TG.partition(TGW, pes, part), strategy=strategy,
                 device="cpu")
    prog = TPROG.make_program("sssp", source=7)
    state = torch.from_numpy(prog.init(eng.pg))
    vals = prog.update(state, eng.aux)
    none = torch.zeros((pes, eng._K), dtype=torch.bool)
    got = eng._push(prog, vals, none, gate=True)
    meta = (eng.pg.grid_shape + (eng.pg.col_chunk_size,)
            if eng.pg.is_grid else None)
    want = TS.phase1_identity(eng.strategy, vals, eng.arrays, prog.combiner,
                              eng._C, eng._K, meta)
    assert got.shape == want.shape
    assert torch.equal(got, want)
