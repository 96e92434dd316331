"""The serving and host-model tables of ``benchmarks/tables.py``, on the port.

The twins of the reference's ``throughput_table``, ``latency_table``,
``wire_table``, ``wire_batch_table`` and ``imbalance_table`` (the rest of
that module waits for its ROADMAP items; ``benchmarks/run.py`` here says
which).  The measured tables run on CUDA unless ``device`` names another;
``throughput_table`` and ``latency_table`` also take a built ``engine``,
so a caller that already holds one on the graph pays no second build.
The host-model tables (``wire*``, ``imbalance``) are pure numpy over the
port's ``wire_model`` and ``partition_stats``.

Timing: a warm ``run_batch`` ends in one blocking copy of its result into
host memory (``Engine._to_host``), so a host clock around it covers the
device's work; ``cost._time`` also synchronizes the device around each
repeat.
"""

from __future__ import annotations

import copy
import math
from collections import deque

import numpy as np

from repro_torch.configs.graphs import GRAPHS
from repro_torch.core import (Engine, get_spec, load_dataset, partition,
                              partition_stats, partitioner_names,
                              policy_label, wire_model)
from repro_torch.core.cost import _time
from repro_torch.launch.serve import (DeadlinePolicy, GraphQueryServer,
                                      VirtualClock)


def wire_table(scale_log2: int = 13, pe_counts=(16, 64, 128, 256),
               partitioners=("contiguous", "edge_balanced")):
    """Analytic per-superstep wire bytes per chare per variant (DESIGN.md
    #2) -> list of (graph, variant label, pes, bytes).  Labels carry a
    ``+<partitioner>`` suffix for non-default policies."""
    rows = []
    for paper_name, (dskey, *_rest) in GRAPHS.items():
        g = load_dataset(dskey, scale_log2=scale_log2)
        for pes in pe_counts:
            for pname in partitioners:
                for variant, bytes_ in wire_model(
                        g, pes, partitioner=pname).items():
                    rows.append((paper_name, policy_label(variant, pname),
                                 pes, bytes_))
    return rows


def throughput_table(scale_log2: int = 13, algo: str = "bfs", B: int = 16,
                     budget: int = 8, repeats: int = 3,
                     dskey: str = "soc-lj1-mini", device=None,
                     engine=None) -> dict:
    """Measured multi-query throughput: one batched ``[*, B]`` sweep vs a
    sequential per-query loop (``run_batch`` at B=1), at a fixed superstep
    budget (DESIGN.md section 11).  ``engine`` (optional) is an engine on
    the program's graph; without one the graph is built as the reference
    builds it.  -> dict with queries/sec both ways and the measured
    amortization ratio, and each query's supersteps."""
    spec = get_spec(algo)
    if engine is None:
        g = load_dataset(dskey, scale_log2=scale_log2, weighted=spec.weighted)
        g = spec.prepare_graph(g)
        engine = Engine(partition(g, 1), device=device)
    rng = np.random.default_rng(0)
    sources = [int(s) for s in
               rng.integers(0, engine.pg.graph.num_vertices, B)]

    # convergence programs take a superstep budget via max_iters; fixed-iter
    # programs (the pagerank family) spell the same knob "iters"
    cap = {"iters" if "iters" in spec.defaults else "max_iters": budget}
    run_batched = lambda: engine.run_batch(algo, sources=sources, batch=B,
                                           **cap)
    # untimed: builds the kernels and learns the tile plan on the card
    _, q_it = run_batched()
    t_batched = _time(run_batched, engine.device, repeats)
    run_seq = lambda: [engine.run_batch(algo, sources=[s], batch=1, **cap)
                       for s in sources]
    run_seq()
    t_seq = _time(run_seq, engine.device, repeats)
    return {
        "graph": dskey, "algo": algo, "B": B, "superstep_budget": budget,
        "batched_s": t_batched, "seq_s": t_seq,
        "qps_batched": B / t_batched, "qps_seq": B / t_seq,
        "measured_speedup": t_seq / t_batched,
        # the plane runs until its slowest column converges; a B=1 run
        # stops at its own
        "query_supersteps": [int(i) for i in q_it],
    }


def latency_table(scale_log2: int = 11, B: int = 8,
                  loads=(0.25, 1.0, 4.0), queries_per_load: int | None = None,
                  ppr_iters: int = 8, slo_factor: float = 1.5,
                  dskey: str = "soc-lj1-mini", seed: int = 0, device=None,
                  engine=None) -> dict:
    """Measured queries/sec-vs-latency curve for the deadline-aware server
    (DESIGN.md section 14): mixed bfs + personalized_pagerank traffic (3:1)
    through ``GraphQueryServer`` under ``DeadlinePolicy``, at several
    offered loads.

    Arrivals are open-loop at fixed spacing ``1/rate`` on the server's
    ``VirtualClock``: the schedule is deterministic while every service
    time is the measured time of its real ``run_batch`` dispatch.
    ``loads`` are multiples of the measured full-plane capacity
    ``B / dispatch_time``.  Each query's SLO is ``slo_factor`` x its OWN
    program's warm dispatch budget (the server's per-``(program, B)``
    EWMA after a warm drain).  ``engine`` (optional) is an engine on the
    graph; without one the graph is built as the reference builds it.

    -> dict with the measured capacity/SLO and one row per load:
    offered/achieved qps, p50/p99 latency, deadline-miss fraction, the mean
    plane fill, the miss fraction of each program, the supersteps and the
    measured seconds of each dispatch, and the most result bytes the
    server held (it never reads a result, so every dispatch's host block
    stays allocated until the load ends).
    """
    if engine is None:
        g = load_dataset(dskey, scale_log2=scale_log2)
        engine = Engine(partition(g, 1), device=device)
    num_vertices = engine.pg.graph.num_vertices
    rng = np.random.default_rng(seed)
    # 8B queries per load: the overloaded points then queue ~(N/B)(1-1/L)
    # dispatches of tail wait (~7 t_d at 4x) vs ~1 t_d at light load, so
    # the curve's rise dwarfs per-dispatch timing noise
    N = (8 * B) if queries_per_load is None else int(queries_per_load)

    def traffic(n):
        out = []
        for q in range(n):
            src = int(rng.integers(num_vertices))
            if q % 4 == 3:
                out.append(("personalized_pagerank", src,
                            dict(iters=ppr_iters)))
            else:
                out.append(("bfs", src, {}))
        return out

    # warm both planes (on the card the first dispatch builds the kernels
    # and learns the tile plan), then measure the dispatch-time EWMA the
    # policy's slack rule and the capacity run on over a second, fully
    # warm drain: the first pass would mis-scale every offered load
    warm = GraphQueryServer(engine, batch=B, policy=DeadlinePolicy(),
                            clock=VirtualClock())
    for prog, src, kw in traffic(2 * B):
        warm.submit(prog, src, **kw)
    warm.drain()
    warm.dispatch_time = None
    warm.dispatch_times.clear()
    for prog, src, kw in traffic(2 * B):
        warm.submit(prog, src, **kw)
    warm.drain()
    t_d = warm.dispatch_time
    capacity = B / t_d
    budgets = {prog: warm.est_dispatch(prog)
               for prog in ("bfs", "personalized_pagerank")}
    slo = {prog: slo_factor * t for prog, t in budgets.items()}
    warm_times = dict(warm.dispatch_times)
    del warm  # frees the warm drains' unread result blocks

    rows = []
    for load in loads:
        rate = load * capacity
        clock = VirtualClock()
        server = GraphQueryServer(engine, batch=B, policy=DeadlinePolicy(),
                                  clock=clock)
        server.dispatch_time = t_d  # seed the EWMA with the warm estimate
        server.dispatch_times.update(warm_times)
        arrivals = deque((i / rate, prog, src, kw)
                         for i, (prog, src, kw) in enumerate(traffic(N)))
        supersteps, seconds, held = [], [], 0
        while arrivals or server.pending():
            while arrivals and arrivals[0][0] <= clock.now + 1e-12:
                _, prog, src, kw = arrivals.popleft()
                server.submit(prog, src, deadline=slo[prog], **kw)
            done = server.step()
            if done:
                # the plane runs until its slowest column has converged
                supersteps.append(max(server.stats[i].iters for i in done))
                seconds.append(server.last_dispatch_s)
                held = max(held, server.held_result_bytes())
                continue  # dispatched; the clock advanced by the measured dt
            # held (or idle): jump to the next event -- the next arrival or
            # the moment the queue head's slack triggers early dispatch
            nxt = arrivals[0][0] if arrivals else math.inf
            trig = math.inf
            if server.pending():
                dls = [r.deadline for r in server.queued()
                       if r.deadline is not None]
                if dls:
                    trig = min(dls) - server.dispatch_time
                if trig <= clock.now:
                    trig = _hold_ends(server, clock.now)
            target = min(nxt, trig)
            clock.advance(max(target - clock.now, 1e-9))
        lat = sorted(s.latency for s in server.stats.values())
        makespan = max(clock.now, 1e-9)
        rows.append({
            "load": load, "offered_qps": rate,
            "achieved_qps": N / makespan,
            "p50_s": lat[len(lat) // 2],
            "p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
            "missed_frac": sum(s.deadline_missed
                               for s in server.stats.values()) / len(lat),
            "missed_frac_by_program": {
                p: float(np.mean([s.deadline_missed for s in
                                  server.stats.values() if s.program == p]))
                for p in budgets},
            "dispatches": server.dispatches,
            "mean_fill": N / max(server.dispatches, 1),
            "dispatch_supersteps": supersteps,
            "dispatch_seconds": seconds,
            "max_held_result_bytes": held,
        })
        del server
    return {"graph": dskey, "B": B, "queries_per_load": N,
            "capacity_qps": capacity, "dispatch_s": t_d,
            "budget_s": budgets, "slo_s": slo,
            "curve": rows}


def _hold_ends(server, now) -> float:
    """When the group the server's ``DeadlinePolicy`` holds at ``now`` must
    dispatch: its head's deadline less ``slack_factor`` x its program's own
    budget.  The reference's event loop prices the jump with the global
    estimate only; where that moment has passed and the group is still
    held (its program's budget is below the global one), it advances the
    clock by 1e-9 s a step until the hold ends -- millions of steps.  This
    jumps to the same moment (within those 1e-9 s).  The policy is copied,
    so asking it which group it holds moves none of its state."""
    policy = server.policy
    head = copy.copy(policy).select(server.queued(), server.batch, now,
                                    server.est_dispatch, True)
    return (min(r.deadline for r in head)
            - policy.slack_factor * server.est_dispatch(head[0].program))


def curve_checks(curve) -> dict:
    """The reference's two assertions on a latency curve
    (``benchmarks/run.py:223-232``), as booleans: latency is monotone in
    offered load within 15% (the flat head of the curve, where under-full
    early dispatch makes light loads pay about the SLO slack either way),
    and the heaviest load's p99 is at least 1.2x the lightest's."""
    monotone = all(row["p50_s"] >= 0.85 * prev["p50_s"]
                   and row["p99_s"] >= 0.85 * prev["p99_s"]
                   for prev, row in zip(curve, curve[1:]))
    rises = curve[-1]["p99_s"] >= 1.2 * curve[0]["p99_s"]
    return {"monotone_in_load": monotone, "p99_rises_1.2x": rises}


def wire_batch_table(scale_log2: int = 13, pes: int = 64,
                     batches=(1, 4, 16), partitioner: str = "contiguous"):
    """B-sweep of the analytic wire model: how per-query wire bytes shrink
    as value payloads amortize the fixed edge-layout side (only ``basic``
    has a per-edge index term).  -> list of (graph, variant, B,
    bytes/chare/superstep, bytes/query)."""
    rows = []
    for paper_name, (dskey, *_rest) in GRAPHS.items():
        g = load_dataset(dskey, scale_log2=scale_log2)
        for B in batches:
            for variant, bytes_ in wire_model(
                    g, pes, partitioner=partitioner, batch=B).items():
                rows.append((paper_name, variant, B, bytes_, bytes_ / B))
    return rows


def imbalance_table(scale_log2: int = 13, pe_counts=(8,), partitioners=None):
    """Per-chare load skew per placement policy -- the paper's imbalance
    observation as a table.  -> list of (graph, partitioner, pes,
    ``partition_stats`` dict).  Host-side prep only."""
    rows = []
    for paper_name, (dskey, *_rest) in GRAPHS.items():
        g = load_dataset(dskey, scale_log2=scale_log2)
        for pes in pe_counts:
            for pname in partitioners or partitioner_names():
                pg = partition(g, pes, partitioner=pname)
                rows.append((paper_name, pname, pes, partition_stats(pg)))
    return rows
