"""The port's graph query server (``repro_torch.launch.serve``) and its
serving tables (``repro_torch.benchmarks``) on the CPU.

The twins of the server cells of ``tests/test_graph_serve.py`` on rmat6
with ``device="cpu"`` (the kernels' plain versions), and against ``repro``
itself:

* the port's ``GreedyPolicy`` and ``DeadlinePolicy`` select the same ids as
  the reference's on drawn queues, over a sequence of calls (Hypothesis);
* the same submissions through both servers, with each module's
  ``time.perf_counter`` replaced by a counter of fixed steps so both
  measure the same dispatch time, give the same admissions, dispatch
  counts, EWMAs and ``QueryStats``; result rows bit-equal for min
  programs, within 1e-6 for personalized PageRank;
* ``latency_table`` with the same fixed step gives the reference's curve,
  and the ``wire*`` and ``imbalance`` tables the reference's rows.

No test asserts on a measured time.
"""

import argparse
import dataclasses
import functools
import time

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import benchmarks.tables as rtables
from conftest import program_graph
from repro.core import Engine as REngine
from repro.core import partition as rpartition
from repro.launch import serve as rserve
from repro_torch.benchmarks import run as brun
from repro_torch.benchmarks import tables
from repro_torch.core import Engine, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import programs as P
from repro_torch.launch import serve
from repro_torch.launch.serve import (DeadlinePolicy, GraphQueryServer,
                                      GreedyPolicy, QueryRequest,
                                      VirtualClock)

SEED_SETS = [(0,), (7, 61), (3, 5, 40)]  # rmat6: 64 vertices


@functools.lru_cache(maxsize=None)
def port_graph(algo):
    g = program_graph(algo, "rmat6")
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


def _engine(algo="sssp"):
    return Engine(TG.partition(port_graph(algo), 1), device="cpu")


def _server(batch=4, policy=None, clock=None, algo="sssp"):
    # the weighted rmat6 graph serves sssp AND bfs
    return port_graph(algo), GraphQueryServer(_engine(algo), batch=batch,
                                              policy=policy, clock=clock)


class FixedStepTime:
    """Stands in for a module's ``time``: ``perf_counter`` advances by a
    fixed step per call, so every dispatch measures ``step`` seconds; with
    ``steps``, by each of them in turn (an odd count, so the dispatches
    measure them in turn too).  Two of them give two modules the same
    dispatch times."""

    def __init__(self, step=0.25, steps=None):
        self.t, self.steps, self.calls = 0.0, steps or (step,), 0
        self.monotonic, self.time = time.monotonic, time.time

    def perf_counter(self):
        self.t += self.steps[self.calls % len(self.steps)]
        self.calls += 1
        return self.t


# ---------------------------------------------------------------------------
# Server behaviour: B=1, mixed programs, deadlines
# ---------------------------------------------------------------------------


def test_server_batch_one():
    """A width-1 server degenerates to sequential serving but keeps the
    whole protocol (per-query results, stats, read-once)."""
    g, server = _server(batch=1)
    srcs = [1, 7, 22]
    ids = [server.submit("bfs", s) for s in srcs]
    assert server.drain() == 3
    assert server.dispatches == 3
    for rid, s in zip(ids, srcs):
        row, it = server.result(rid)
        want, want_it = P.bfs_serial(g, source=s)
        np.testing.assert_array_equal(row, want)
        assert it == want_it


def test_server_mixed_program_arrival_order():
    """Greedy admission across interleaved programs: each step serves the
    queue head's program, and within each program queries complete in
    arrival order."""
    _, server = _server(batch=2)
    a0 = server.submit("bfs", 1)
    b0 = server.submit("sssp", 2)
    a1 = server.submit("bfs", 3)
    b1 = server.submit("sssp", 4)
    a2 = server.submit("bfs", 5)
    order = []
    while server.pending():
        order.extend(server.step())
    assert order == [a0, a1, b0, b1, a2]
    assert server.dispatches == 3


def test_server_deadline_expired_served_and_flagged():
    clock = VirtualClock()
    _, server = _server(batch=2, policy=DeadlinePolicy(), clock=clock)
    rid = server.submit("bfs", 1, deadline=0.05)
    clock.advance(1.0)  # blow the deadline before any dispatch
    assert server.step() == [rid]  # zero slack forces dispatch
    st_ = server.stats[rid]
    assert st_.deadline_missed and st_.latency >= 1.0
    row, _ = server.result(rid)
    assert np.asarray(row).shape[0] == 64


def test_server_rejects_empty_seed_set():
    _, server = _server()
    with pytest.raises(ValueError, match="non-empty seed set"):
        server.submit("personalized_pagerank", [])
    assert server.pending() == 0


def test_server_serves_ppr_seed_sets():
    g, server = _server(batch=4, algo="personalized_pagerank")
    ids = [server.submit("personalized_pagerank", seeds, iters=6)
           for seeds in SEED_SETS]
    assert server.drain() == len(ids)
    eng = _engine("personalized_pagerank")
    for rid, seeds in zip(ids, SEED_SETS):
        row, it = server.result(rid)
        want, _ = eng.run("personalized_pagerank", seeds=seeds, iters=6)
        np.testing.assert_allclose(row, want, atol=1e-6)
        assert it == 6


# ---------------------------------------------------------------------------
# DeadlinePolicy unit behaviour (EDF, holds, slack dispatch, interleaving)
# ---------------------------------------------------------------------------


def _req(rid, program, deadline=None, params=()):
    return QueryRequest(rid, program, rid, tuple(params), submit_time=0.0,
                        deadline=deadline)


def test_deadline_policy_holds_underfull_then_dispatches_on_slack():
    pol = DeadlinePolicy()
    queue = (_req(0, "bfs", deadline=10.0), _req(1, "bfs", deadline=12.0))
    assert pol.select(queue, 4, now=0.0, est_dispatch_s=0.1,
                      force=False) == []
    got = pol.select(queue, 4, now=9.95, est_dispatch_s=0.1, force=False)
    assert [r.id for r in got] == [0, 1]
    assert len(DeadlinePolicy().select(queue, 4, now=0.0, est_dispatch_s=0.1,
                                       force=True)) == 2


def test_deadline_policy_edf_and_interleave():
    pol = DeadlinePolicy()
    urgent = _req(5, "sssp", deadline=1.0)
    lax = (_req(0, "bfs", deadline=50.0), _req(1, "bfs", deadline=60.0))
    got = pol.select(lax + (urgent,), 1, 0.0, 0.01, force=False)
    assert [r.id for r in got] == [5]  # EDF: the later, urgent one wins
    pol2 = DeadlinePolicy()
    queue = (_req(2, "sssp"), _req(3, "sssp"), _req(4, "bfs"))
    got = pol2.select(queue, 2, 0.0, 0.01, force=True)
    assert [r.id for r in got] == [2, 3]
    got = pol2.select(queue, 2, 0.0, 0.01, force=True)
    assert all(r.program == "bfs" for r in got)  # stale sssp ranks behind


def test_deadline_policy_end_to_end_mixed_traffic():
    """Mixed bfs + PPR under DeadlinePolicy on a virtual clock: everything
    drains, and with equal deadlines the dispatches alternate programs."""
    clock = VirtualClock()
    _, server = _server(batch=2, policy=DeadlinePolicy(), clock=clock,
                        algo="personalized_pagerank")
    for i in range(8):
        prog = "bfs" if i % 2 == 0 else "personalized_pagerank"
        src = (i + 1) if prog == "bfs" else (i + 1, i + 2)
        kw = {} if prog == "bfs" else {"iters": 5}
        server.submit(prog, src, deadline=30.0, **kw)
    seq = []
    while server.pending():
        done = server.step(force=True)
        assert done
        seq.append(server.stats[done[0]].program)
    assert len(server.stats) == 8
    assert not any(s.deadline_missed for s in server.stats.values())
    assert all(a != b for a, b in zip(seq, seq[1:]))


# ---------------------------------------------------------------------------
# Measured dispatch budgets: per-(program, B) EWMA
# ---------------------------------------------------------------------------


def test_dispatch_times_recorded_per_program_bucket():
    _, server = _server(batch=2, algo="personalized_pagerank")
    for i in range(2):
        server.submit("bfs", i + 1)
        server.submit("personalized_pagerank", (i + 1,), iters=3)
    server.drain()
    assert set(server.dispatch_times) == {("bfs", 2),
                                          ("personalized_pagerank", 2)}
    for prog in ("bfs", "personalized_pagerank"):
        assert server.est_dispatch(prog) == server.dispatch_times[(prog, 2)]
        assert server.est_dispatch(prog) > 0.0


def test_est_dispatch_fallbacks():
    _, server = _server(batch=2)
    assert server.est_dispatch("bfs") == 0.0  # cold: no estimate at all
    server.submit("sssp", 1)
    server.submit("sssp", 2)
    server.drain()
    assert server.est_dispatch("sssp") == server.dispatch_times[("sssp", 2)]
    assert server.est_dispatch("bfs") == server.dispatch_time  # global


def test_deadline_policy_prices_per_program_estimate():
    pol = DeadlinePolicy()
    est = {"bfs": 0.01, "personalized_pagerank": 5.0}.get
    cheap = (_req(0, "bfs", deadline=10.0),)
    assert pol.select(cheap, 4, now=0.0, est_dispatch_s=lambda p: est(p),
                      force=False) == []
    costly = (_req(1, "personalized_pagerank", deadline=10.0),)
    got = pol.select(costly, 4, now=6.0, est_dispatch_s=lambda p: est(p),
                     force=False)
    assert [r.id for r in got] == [1]
    assert pol.select(cheap, 4, now=0.0, est_dispatch_s=0.1,
                      force=False) == []


# ---------------------------------------------------------------------------
# The three serving fixes of the reference, and the held result blocks
# ---------------------------------------------------------------------------


def test_empty_sources_clear_error_and_empty_queue_is_a_no_op():
    with pytest.raises(ValueError, match="at least one query"):
        _engine("bfs").run_batch("bfs", sources=[])
    _, server = _server()
    assert server.step() == [] and server.drain() == 0


def test_server_results_memory_bounded():
    """``result()`` is read-once: once every row is read the server holds
    no result block (scalar stats persist); until then a dispatch's block
    counts once however many of its rows are unread."""
    _, server = _server(batch=4)
    ids = [server.submit("bfs", s) for s in (1, 2, 3, 4, 5)]
    assert server.held_result_bytes() == 0
    assert server.drain() == 5
    assert len(server._results) == 5
    # two dispatches: a [4, 64] and a [1, 64] int32 block
    assert server.held_result_bytes() == (4 + 1) * 64 * 4
    server.result(ids[0])
    assert server.held_result_bytes() == (4 + 1) * 64 * 4
    for rid in ids[1:4]:
        server.result(rid)
    assert server.held_result_bytes() == 64 * 4
    server.result(ids[4])
    assert server._results == {} and server.held_result_bytes() == 0
    assert len(server.stats) == 5
    with pytest.raises(KeyError, match="not finished"):
        server.result(ids[0])


def _cli_args(**kw):
    base = dict(scale=6, queries=10, batch=4, policy="deadline",
                programs="bfs,personalized_pagerank", deadline=5.0,
                ppr_iters=4, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_graph_main_qps_counts_timed_drain_only():
    m = serve._graph_main(_cli_args())
    assert m["queries"] == 10
    assert 1 <= m["warmup"] <= 4
    assert m["drained"] == m["queries"] - m["warmup"]
    assert m["qps"] == pytest.approx(m["drained"] / m["wall_s"], rel=1e-6)
    assert m["dispatches"] >= 2 and m["p50_s"] > 0.0


@pytest.mark.parametrize("policy", ["greedy", "deadline"])
def test_cli_serves_on_the_cpu_and_matches_the_reference_admissions(
        policy, monkeypatch, capsys):
    """``--graph --device cpu`` serves; with a fixed dispatch step both
    CLIs admit the same queries in the same dispatches."""
    argv = ["--graph", "--device", "cpu", "--scale", "6", "--queries", "12",
            "--batch", "4", "--policy", policy,
            "--programs", "bfs,personalized_pagerank", "--ppr-iters", "3"]
    monkeypatch.setattr(serve, "time", FixedStepTime())
    got = serve.main(argv)
    args = vars(_cli_args(queries=12, policy=policy, deadline=None,
                          ppr_iters=3))
    args.pop("device")
    monkeypatch.setattr(rserve, "time", FixedStepTime())
    want = rserve._graph_main(argparse.Namespace(**args))
    for key in ("queries", "warmup", "drained", "dispatches",
                "deadline_missed"):
        assert got[key] == want[key], key
    assert "[serve-graph] sample result" in capsys.readouterr().out


def test_cli_serves_streamed_and_matches_the_reference(monkeypatch):
    """``--residency stream`` serves out of core: with a fixed dispatch step
    both CLIs admit the same queries in the same dispatches over a streamed
    grid(1,1) engine."""
    argv = ["--graph", "--device", "cpu", "--scale", "6", "--queries", "12",
            "--batch", "4", "--residency", "stream", "--windows", "3",
            "--programs", "bfs,personalized_pagerank", "--ppr-iters", "3"]
    monkeypatch.setattr(serve, "time", FixedStepTime())
    got = serve.main(argv)
    args = vars(_cli_args(queries=12, policy="greedy", deadline=None,
                          ppr_iters=3, residency="stream", windows=3))
    args.pop("device")
    monkeypatch.setattr(rserve, "time", FixedStepTime())
    want = rserve._graph_main(argparse.Namespace(**args))
    for key in ("queries", "warmup", "drained", "dispatches",
                "deadline_missed"):
        assert got[key] == want[key], key


# ---------------------------------------------------------------------------
# Against repro itself: the policies on drawn queues
# ---------------------------------------------------------------------------

# few batch keys, so that queues of two or three groups are common
_REQUEST = st.tuples(
    st.sampled_from(["bfs", "personalized_pagerank"]),
    st.sampled_from([(), (("iters", 3),)]),
    st.one_of(st.integers(0, 63),
              st.lists(st.integers(0, 63), min_size=1, max_size=3)),
    # deadlines from a few values too, so groups tie on urgency and the
    # interleave rule decides
    st.one_of(st.none(), st.sampled_from([1.0, 2.0, 5.0]),
              st.floats(0.0, 10.0)),
    st.floats(0.0, 2.0))
_CALL = st.tuples(
    st.one_of(st.sampled_from([0.0, 1.0]), st.floats(0.0, 12.0)),  # now
    st.one_of(st.floats(0.0, 3.0),  # one global estimate, or per program
              st.fixed_dictionaries({p: st.floats(0.0, 3.0) for p in
                                     ("bfs", "personalized_pagerank")})),
    st.booleans(),  # force
    st.integers(1, 5))  # batch


@settings(max_examples=300, deadline=None)
@example(  # two groups tie on urgency: the interleave rule decides
    requests=[("bfs", (), 0, None, 0.0), ("bfs", (), 1, None, 0.0),
              ("personalized_pagerank", (), 2, None, 0.0)],
    calls=[(0.0, 0.1, False, 1), (0.0, 0.1, False, 1)], slack_factor=1.0,
    interleave=True)
@given(requests=st.lists(_REQUEST, min_size=1, max_size=12),
       calls=st.lists(_CALL, min_size=1, max_size=6),
       slack_factor=st.sampled_from([0.5, 1.0, 2.0]),
       interleave=st.booleans())
def test_policies_select_what_the_reference_selects(requests, calls,
                                                    slack_factor, interleave):
    """Each call removes what it admitted from both queues, so the
    deadline policies carry ``_last_key`` from call to call."""
    def queue(cls):
        return [cls(i, prog, tuple(src) if isinstance(src, list) else src,
                    params, submit_time=t0, deadline=dl)
                for i, (prog, params, src, dl, t0) in enumerate(requests)]

    for ours, theirs in (
            (GreedyPolicy(), rserve.GreedyPolicy()),
            (DeadlinePolicy(slack_factor, interleave),
             rserve.DeadlinePolicy(slack_factor, interleave))):
        q_ours, q_theirs = queue(QueryRequest), queue(rserve.QueryRequest)
        for now, est, force, batch in calls:
            if not q_ours:
                break
            e = est.get if isinstance(est, dict) else est
            got = ours.select(tuple(q_ours), batch, now, e, force)
            want = theirs.select(tuple(q_theirs), batch, now, e, force)
            assert [r.id for r in got] == [r.id for r in want]
            taken = {r.id for r in got}
            q_ours = [r for r in q_ours if r.id not in taken]
            q_theirs = [r for r in q_theirs if r.id not in taken]
        if isinstance(ours, DeadlinePolicy):
            assert ours._last_key == theirs._last_key


# ---------------------------------------------------------------------------
# Against repro itself: the same submissions through both servers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_engine():
    # one engine for every case: the reference compiles each plane once
    return REngine(rpartition(program_graph("sssp", "rmat6"), 1))


TRAFFIC = [  # (program, source, relative deadline, params)
    ("bfs", 1, 2.0, {}), ("sssp", 2, None, {}),
    ("personalized_pagerank", (7, 61), 1.0, {"iters": 4}),
    ("bfs", 9, 3.0, {}), ("sssp", 11, 0.5, {}),
    ("personalized_pagerank", 0, 4.0, {"iters": 4}),
    ("bfs", 33, None, {}), ("bfs", 40, 0.75, {}),
    ("personalized_pagerank", (3, 5, 40), 2.5, {"iters": 4}),
    ("sssp", 63, 1.5, {}), ("bfs", 5, 6.0, {}), ("bfs", 6, 6.0, {}),
]


def _state(server):
    return (server.dispatches, server.dispatch_time,
            dict(server.dispatch_times), server.last_dispatch_s,
            {k: dataclasses.astuple(v) for k, v in server.stats.items()},
            [dataclasses.astuple(r) for r in server.queued()])


@pytest.mark.parametrize("policy", ["greedy", "deadline"])
def test_server_matches_the_reference_server(policy, monkeypatch):
    """Submissions in three waves, steps between them (the deadline policy
    holds under-full planes), then a drain: after every step both servers
    hold the same state, and every row equals the reference's."""
    steps = (0.25, 0.5, 0.125)  # the EWMAs see three dispatch times
    monkeypatch.setattr(serve, "time", FixedStepTime(steps=steps))
    monkeypatch.setattr(rserve, "time", FixedStepTime(steps=steps))
    pair = []
    for mod, eng in ((serve, _engine()), (rserve, _reference_engine())):
        pol = (mod.DeadlinePolicy() if policy == "deadline"
               else mod.GreedyPolicy())
        clock = mod.VirtualClock()
        pair.append((mod.GraphQueryServer(eng, batch=4, policy=pol,
                                          clock=clock), clock))
    done = [[], []]
    for wave in (TRAFFIC[:5], TRAFFIC[5:9], TRAFFIC[9:]):
        for k, (server, clock) in enumerate(pair):
            for prog, src, dl, kw in wave:
                server.submit(prog, src, deadline=dl, **kw)
            for _ in range(2):
                done[k].append(server.step())
            clock.advance(0.5)
        assert done[0] == done[1]
        assert _state(pair[0][0]) == _state(pair[1][0])
    assert pair[0][0].drain() == pair[1][0].drain()
    assert _state(pair[0][0]) == _state(pair[1][0])
    assert pair[0][0].dispatches >= 4
    for rid, (prog, *_rest) in enumerate(TRAFFIC):
        row, it = pair[0][0].result(rid)
        want, want_it = pair[1][0].result(rid)
        want = np.asarray(want)
        assert it == want_it and row.dtype == want.dtype
        if prog == "personalized_pagerank":
            np.testing.assert_allclose(row, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(row, want)


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["bfs", "personalized_pagerank"])
def test_throughput_table_rows_are_well_formed(algo):
    tp = tables.throughput_table(scale_log2=7, algo=algo, B=4, budget=3,
                                 repeats=1, device="cpu")
    assert set(tp) == {"graph", "algo", "B", "superstep_budget",
                       "batched_s", "seq_s", "qps_batched", "qps_seq",
                       "measured_speedup", "query_supersteps"}
    assert len(tp["query_supersteps"]) == 4
    assert all(1 <= i <= 3 for i in tp["query_supersteps"])
    assert (tp["graph"], tp["algo"], tp["B"], tp["superstep_budget"]) == \
        ("soc-lj1-mini", algo, 4, 3)
    assert tp["batched_s"] > 0 and tp["seq_s"] > 0
    assert tp["qps_batched"] == pytest.approx(4 / tp["batched_s"])
    assert tp["measured_speedup"] == pytest.approx(
        tp["seq_s"] / tp["batched_s"])


def test_throughput_table_runs_on_a_given_engine():
    eng = _engine("bfs")
    tp = tables.throughput_table(algo="bfs", B=2, budget=2, repeats=1,
                                 engine=eng)
    assert tp["B"] == 2 and tp["qps_seq"] > 0


_CURVE_KEYS = {"load", "offered_qps", "achieved_qps", "p50_s", "p99_s",
               "missed_frac", "dispatches", "mean_fill"}


def test_latency_table_equals_the_reference_curve(monkeypatch):
    """With every dispatch measuring the same fixed step, the port's curve
    is the reference's, key for key, and the reference's two assertions
    on it hold."""
    monkeypatch.setattr(serve, "time", FixedStepTime(0.125))
    got = tables.latency_table(scale_log2=7, B=4, device="cpu")
    monkeypatch.setattr(rserve, "time", FixedStepTime(0.125))
    want = rtables.latency_table(scale_log2=7, B=4)
    assert set(got) == set(want)
    for key in ("graph", "B", "queries_per_load", "capacity_qps",
                "dispatch_s", "budget_s", "slo_s"):
        assert got[key] == want[key], key
    assert len(got["curve"]) == len(want["curve"]) == 3
    for row, ref in zip(got["curve"], want["curve"]):
        assert set(row) == _CURVE_KEYS | {"dispatch_supersteps",
                                          "dispatch_seconds",
                                          "max_held_result_bytes",
                                          "missed_frac_by_program"}
        assert row["dispatch_seconds"] == [0.125] * row["dispatches"]
        assert row["missed_frac"] == pytest.approx(
            (3 * row["missed_frac_by_program"]["bfs"]
             + row["missed_frac_by_program"]["personalized_pagerank"]) / 4)
        assert {k: row[k] for k in _CURVE_KEYS} == ref
        assert len(row["dispatch_supersteps"]) == row["dispatches"]
        assert 0 < row["max_held_result_bytes"] <= 32 * 128 * 4
    assert tables.curve_checks(got["curve"]) == {"monotone_in_load": True,
                                                 "p99_rises_1.2x": True}


def test_latency_table_on_a_given_engine_equals_its_own_build(monkeypatch):
    monkeypatch.setattr(serve, "time", FixedStepTime())
    built = tables.latency_table(scale_log2=6, B=2, loads=(0.5, 2.0),
                                 device="cpu")
    eng = Engine(TG.partition(TG.load_dataset("soc-lj1-mini", scale_log2=6),
                              1), device="cpu")
    given_ = tables.latency_table(B=2, loads=(0.5, 2.0), engine=eng)
    assert given_ == built


def test_curve_checks_flag_a_flat_or_falling_curve():
    row = lambda p50, p99: {"p50_s": p50, "p99_s": p99}
    assert tables.curve_checks([row(1, 1), row(1, 1.1), row(1, 1.19)]) == \
        {"monotone_in_load": True, "p99_rises_1.2x": False}
    assert tables.curve_checks([row(1, 1), row(0.8, 2), row(2, 3)]) == \
        {"monotone_in_load": False, "p99_rises_1.2x": True}


def test_wire_tables_equal_the_reference():
    assert tables.wire_table(scale_log2=7) == rtables.wire_table(scale_log2=7)
    assert tables.wire_batch_table(scale_log2=7) == \
        rtables.wire_batch_table(scale_log2=7)


def test_imbalance_table_equals_the_reference():
    got = tables.imbalance_table(scale_log2=7, pe_counts=(8, 3))
    want = rtables.imbalance_table(scale_log2=7, pe_counts=(8, 3))
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for (*_, ours), (*_, theirs) in zip(got, want):
        assert ours.keys() == theirs.keys()
        for key, value in theirs.items():
            assert ours[key] == pytest.approx(value, rel=1e-12), key


def test_benchmark_run_prints_the_ported_sections(monkeypatch, tmp_path,
                                                  capsys):
    """``repro_torch.benchmarks.run`` prints the imbalance, wire,
    wire_batch, throughput, serving, async and streaming rows by the
    reference's names beside the table, cost, fig12, grid, kernel,
    dispatch and roofline rows (``test_torch_tables.py`` holds those),
    every section of the reference's, passes the curve's, the async and
    the streaming assertions and writes BENCH_cost.json's serving, async
    and streaming sections."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(serve, "time", FixedStepTime())
    out = brun.main(["--scale", "7", "--device", "cpu", "--json"])
    lines = capsys.readouterr().out.splitlines()
    heads = {line.split(",")[0].split(".")[0] for line in lines}
    assert heads == {"device", "imbalance", "wire", "wire_batch",
                     "throughput", "serving", "json", "table2", "table3",
                     "table4", "table5", "table6", "table7", "table8",
                     "cost", "fig12", "grid", "async", "streaming",
                     "kernel", "dispatch", "roofline"}
    names = {line.split(",")[0] for line in lines}
    for name in ("throughput.soc-lj1-mini.bfs.batched@B16",
                 "throughput.soc-lj1-mini.bfs.seq_loop@B16",
                 "throughput.soc-lj1-mini.bfs.measured_speedup",
                 "serving.soc-lj1-mini.ppr.batched@B16",
                 "serving.soc-lj1-mini.ppr.measured_speedup",
                 "serving.capacity_qps", "serving.soc-lj1-mini.load0.25x",
                 "serving.soc-lj1-mini.load1x", "serving.soc-lj1-mini.load4x",
                 "wire.soc-LiveJournal1.basic+edge_balanced@64",
                 "wire_batch.uk-2007-05.basic@B16",
                 "imbalance.twitter_rv.degree_sorted@8",
                 "async.sssp.barrier@1", "async.sssp.overlap@1",
                 "async.sssp.superstep_s",
                 "async.gating_model.lockstep_skipped",
                 "async.grid24.gate_skipped",
                 "async.grid24.collective_ratio",
                 "streaming.sssp.resident@1", "streaming.sssp.streamed@1",
                 "streaming.sssp.superstep_s",
                 "streaming.overlap_efficiency", "streaming.edge_bandwidth",
                 "streaming.gate_skip_fraction",
                 "streaming.cache_prep_speedup",
                 "streaming.batched.bytes_per_query@B16",
                 "streaming.batched.qps@B16"):
        assert name in names, name
    assert lines[0] == "device,cpu,type=cpu count=1"
    saved = __import__("json").loads((tmp_path / "BENCH_cost.json")
                                     .read_text())
    assert set(saved) >= {"throughput", "serving", "async", "streaming"}
    assert saved["async"]["grid24"]["bit_exact"]
    assert saved["streaming"]["bit_exact"]
    assert saved["streaming"]["batched"]["bytes_per_query_ratio"] <= 0.125
    assert saved["serving"]["checks"] == out["serving"]["checks"]


class ProgramTimedEngine:
    """An engine whose every dispatch of a program takes that program's
    fixed seconds on a stand-in clock (``FixedStepTime`` with step 0)."""

    def __init__(self, eng, fake_time, seconds):
        self.eng, self.time, self.seconds = eng, fake_time, seconds
        self.pg = eng.pg

    def run_batch(self, program, **kw):
        self.time.t += self.seconds[program]
        return self.eng.run_batch(program, **kw)


def test_hold_ends_where_the_held_programs_budget_says():
    """A group held on its own program's budget, below the global one,
    dispatches at its head's deadline less that budget; asking moves none
    of the policy's state."""
    _, server = _server(batch=4, policy=DeadlinePolicy(slack_factor=2.0),
                        clock=VirtualClock())
    server.dispatch_time = 0.3
    server.dispatch_times.update({("bfs", 4): 0.1, ("sssp", 4): 0.5})
    server.policy._last_key = ("sssp", ())
    server.submit("sssp", 2, deadline=20.0)
    server.submit("bfs", 1, deadline=10.0)
    assert tables._hold_ends(server, 0.0) == pytest.approx(10.0 - 2 * 0.1)
    assert server.policy._last_key == ("sssp", ())
    assert server.step() == []  # held until then


def test_latency_table_jumps_to_the_end_of_each_hold(monkeypatch):
    """With PPR's budget below the global estimate, a held PPR group's hold
    outlives the global trigger; the event loop jumps to its end instead of
    creeping there by 1e-9 s steps."""
    steps = []

    class CountingServer(GraphQueryServer):
        def step(self, force=False):
            steps.append(force)
            if len(steps) > 2000:
                raise AssertionError("the event loop creeps")
            return super().step(force)

    fake = FixedStepTime(0.0)
    monkeypatch.setattr(serve, "time", fake)
    monkeypatch.setattr(tables, "GraphQueryServer", CountingServer)
    eng = ProgramTimedEngine(
        Engine(TG.partition(TG.load_dataset("soc-lj1-mini", scale_log2=6),
                            1), device="cpu"),
        fake, {"bfs": 0.125, "personalized_pagerank": 0.0625})
    lt = tables.latency_table(B=4, engine=eng)
    assert lt["budget_s"]["personalized_pagerank"] < lt["dispatch_s"]
    assert lt["budget_s"] == pytest.approx(
        {"bfs": 0.125, "personalized_pagerank": 0.0625})
    assert sum(r["dispatches"] for r in lt["curve"]) < len(steps) < 2000
    assert tables.curve_checks(lt["curve"]) == {"monotone_in_load": True,
                                                "p99_rises_1.2x": True}
