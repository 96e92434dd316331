"""The paper's tables and the serving and host-model tables of
``benchmarks/tables.py``, on the port.

The twins of the reference's ``run_table`` (paper Tables 2 & 3 and their
analogues for every registered program, with the serial baseline and the
dataflow stand-in), ``grid_table``, ``throughput_table``,
``latency_table``, ``wire_table``, ``wire_batch_table`` and
``imbalance_table``, the barrier-relaxation tables ``async_table``,
``gating_model`` and ``async_grid_metrics``, and the out-of-core
``streaming_table`` (the rest of that module waits for its ROADMAP items;
``benchmarks/run.py`` here says which).  The measured tables run on CUDA
unless ``device`` names another; ``throughput_table`` and
``latency_table`` also take a built ``engine``, so a caller that already
holds one on the graph pays no second build.  The host-model tables
(``grid``, ``wire*``, ``imbalance``) are pure numpy over the port's
``wire_model`` and ``partition_stats``.

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
import torch

from repro_torch.benchmarks.graphx_analogue import (bench, labelprop_dataflow,
                                                    pagerank_dataflow)
from repro_torch.configs.graphs import GRAPHS, VARIANTS
from repro_torch.core import (Engine, get_spec, grid_collective_bytes,
                              load_dataset, partition, partition_stats,
                              partitioner_names, policy_label, wire_model)
from repro_torch.core.cost import _time
from repro_torch.launch.serve import (DeadlinePolicy, GraphQueryServer,
                                      VirtualClock)


# Dataflow ("GraphX") stand-ins exist only for the paper's own two
# algorithms; programs without one emit no dataflow row.
DATAFLOW = {
    "pagerank": lambda g, p, device: pagerank_dataflow(
        g, p["alpha"], p["iters"], device=device),
    "labelprop": lambda g, p, device: labelprop_dataflow(
        g, p["max_iters"], device=device),
}


def run_table(algorithm: str, scale_log2: int = 13, repeats: int = 3,
              pe_counts=(1,), partitioners=("contiguous",), device=None,
              graphs=None):
    """-> list of (graph, impl, pes, seconds, correct), the reference's
    rows: per paper graph the serial baseline, the dataflow stand-in where
    the program has one, then every strategy of ``VARIANTS`` per
    (partitioner, chare count).

    ``impl`` is the strategy name, suffixed ``+<partitioner>`` for
    non-default placement policies.  Each (partitioner, chare count) cell
    partitions once, shared across all strategies.  All chares live on
    ``device`` (CUDA unless another is named), so every chare count runs.
    ``graphs`` (optional) names the paper graphs to run, of ``GRAPHS``.
    """
    spec = get_spec(algorithm)
    params = dict(spec.defaults)
    rows = []
    for paper_name, (dskey, *_rest) in GRAPHS.items():
        if graphs is not None and paper_name not in graphs:
            continue
        g = load_dataset(dskey, scale_log2=scale_log2, weighted=spec.weighted)
        g = spec.prepare_graph(g)
        ref = spec.run_serial(g)

        t_serial = bench(lambda: spec.serial(g, **params), repeats, device)
        rows.append((paper_name, "serial", 1, t_serial, True))
        flow = DATAFLOW.get(algorithm)
        if flow is not None:
            t_flow = bench(lambda: flow(g, params, device), repeats, device)
            rows.append((paper_name, "dataflow", 1, t_flow, True))

        for pname in partitioners:
            for pes in pe_counts:
                pg = partition(g, pes, partitioner=pname)
                for variant in VARIANTS:
                    eng = Engine(pg, strategy=variant, device=device)
                    run = lambda: eng.run(algorithm, **params)
                    out, _ = run()
                    ok = spec.matches(out, ref)
                    rows.append((paper_name, policy_label(variant, pname),
                                 pes, bench(run, repeats, device), ok))
    return rows


def grid_table(scale_log2: int = 13, shapes=((2, 4), (4, 2))):
    """2-D grid placement: per-rectangle load skew plus the two-phase-reduce
    wire model, against the cheapest 1-D variant at the same chare count.

    -> list of (graph, grid-name, pes, metrics-dict) with keys ``stats``
    (``partition_stats`` on the rectangle decomposition), ``wire`` (grid2d
    bytes per rectangle per superstep), ``wire_basic_1d`` (best 1-D
    *basic*-variant bytes -- the other edge-traffic strategy) and
    ``wire_best_1d`` (best bytes over every 1-D strategy x partitioner).
    Host-side prep only: nothing here runs on a device.
    """
    rows = []
    for paper_name, (dskey, *_rest) in GRAPHS.items():
        g = load_dataset(dskey, scale_log2=scale_log2)
        one_d_cache = {}

        def one_d(pes):
            if pes not in one_d_cache:
                one_d_cache[pes] = [wire_model(g, pes, partitioner=p)
                                    for p in partitioner_names()]
            return one_d_cache[pes]

        for rr, cc in shapes:
            pes = rr * cc
            pname = f"grid({rr},{cc})"
            rows.append((paper_name, pname, pes, {
                "stats": partition_stats(
                    partition(g, pes, partitioner=pname)),
                "wire": wire_model(g, pes, partitioner=pname)["grid2d"],
                "wire_basic_1d": min(m["basic"] for m in one_d(pes)),
                "wire_best_1d": min(b for m in one_d(pes)
                                    for b in m.values()),
            }))
    return rows


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
    _warm_pinned_results(engine, B, N)

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


def _warm_pinned_results(engine, B, N):
    """Fill torch's pinned host cache with the result blocks one load can
    hold, before the loads run.  A load's server keeps every dispatch's
    ``[b, V]`` 4-byte result (b <= B queries) until the load ends, and a
    block the cache cannot serve is a fresh ``cudaHostAlloc`` inside that
    dispatch: 15-129 ms for 128 MiB on an H100's host, the stalls of a
    process's first curve (``scripts/torch_serve_first_curve.py``).  torch
    rounds a pinned block up to a power of two and serves a request from
    its own size class only, so each class that a result of 1..B rows
    falls in gets as many blocks as N queries can fill there, all held at
    once and then freed into the cache.  A no-op off CUDA."""
    device = getattr(engine, "device", None)
    if device is None or torch.device(device).type != "cuda":
        return
    row = engine.pg.graph.num_vertices * 4
    fewest = {}  # size class -> the fewest rows that fall in it
    for b in range(B, 0, -1):
        fewest[1 << (b * row - 1).bit_length()] = b
    held = [torch.empty(b * row, dtype=torch.uint8, pin_memory=True)
            for b in fewest.values() for _ in range(-(-N // b))]
    del held


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


# ---------------------------------------------------------------------------
# Barrier relaxation: overlap and the frontier gate (DESIGN.md section 12)
# ---------------------------------------------------------------------------


def async_table(scale_log2: int = 13, repeats: int = 3,
                dskey: str = "soc-lj1-mini", device=None, engine=None
                ) -> dict:
    """Measured barrier against overlap plus the frontier gate at one
    chare: whole-run and per-superstep seconds of SSSP (source 0) under
    ``sync='barrier'`` and under ``sync='overlap', gate='frontier'``, with
    the engine's launch accounting.  On one device phase 2 is a reduction
    on the same card, so the per-superstep delta is what the relaxed
    schedule itself costs or saves, not a hidden collective.  ``engine``
    (optional) is a built C=1 engine on the SSSP graph to reuse.
    """
    if engine is None:
        spec = get_spec("sssp")
        g = spec.prepare_graph(load_dataset(dskey, scale_log2=scale_log2,
                                            weighted=spec.weighted))
        engine = Engine(partition(g, 1), device=device)
    eng = engine
    run_b = lambda: eng.run("sssp", source=0)
    out_b, it_b = run_b()
    t_b = bench(run_b, repeats, eng.device)
    run_o = lambda: eng.run("sssp", source=0, sync="overlap",
                            gate="frontier")
    out_o, it_o = run_o()
    gate = dict(eng.dispatch["gate"])
    t_o = bench(run_o, repeats, eng.device)
    return {
        "barrier_s": t_b, "overlap_s": t_o,
        "it_barrier": it_b, "it_overlap": it_o,
        "superstep_barrier_s": t_b / max(it_b, 1),
        "superstep_overlap_s": t_o / max(it_o, 1),
        "bit_exact": bool(np.array_equal(out_b, out_o)),
        "gate": gate,
    }


def gating_model(scale_log2: int = 13, shape=(2, 4),
                 dskey: str = "soc-lj1-mini", graph=None) -> dict:
    """Host-side frontier-gating model on the lockstep schedule: serial
    Jacobi SSSP sweeps give the per-superstep frontier; each sweep's live
    BLOCK_V blocks (in the grid's row-relabelled vertex order) meet each
    rectangle's band source mask, and a rectangle with no intersection is
    a skipped launch.  Pure numpy, no device.  ``graph`` (optional) is the
    weighted SSSP graph to model.
    """
    from repro_torch.core.partitioners import row_plan_of
    from repro_torch.kernels import blocks

    spec = get_spec("sssp")
    g = graph if graph is not None else spec.prepare_graph(
        load_dataset(dskey, scale_log2=scale_log2, weighted=spec.weighted))
    R, C = shape
    pg = partition(g, R * C, partitioner=f"grid({R},{C})")
    K = pg.chunk_size
    nsb = max(-(-K // blocks.BLOCK_V), 1)
    gmask = blocks.band_source_mask(np.asarray(pg.gr_band), nsb) != 0
    g2l, _ = row_plan_of(pg.plan).relabel()
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    w = np.asarray(g.edge_weights, np.float64)
    dist = np.full(g.num_vertices, np.inf)
    dist[0] = 0.0
    frontier = np.zeros(g.num_vertices, bool)
    frontier[0] = True
    launched = slots = sweeps = 0
    while frontier.any():
        f_pad = np.zeros(R * K, np.int32)
        f_pad[g2l[np.nonzero(frontier)[0]]] = 1
        for k in range(R * C):
            r = k // C
            fb = blocks.frontier_block_mask(f_pad[r * K:(r + 1) * K], nsb)
            launched += int((fb.astype(bool) & gmask[k]).any())
        slots += R * C
        new = dist.copy()
        on = frontier[src]
        np.minimum.at(new, dst[on], dist[src[on]] + w[on])
        frontier = new != dist
        dist = new
        sweeps += 1
    return {
        "shape": list(shape), "supersteps": sweeps,
        "launch_slots": slots, "launched": launched,
        "skipped_launches": slots - launched,
        "skipped_fraction": (slots - launched) / slots if slots else 0.0,
    }


def async_grid_metrics(scale_log2: int = 13, dskey: str = "soc-lj1-mini",
                       device=None, graph=None, pg=None) -> dict:
    """The twin of the reference's ``async_multidevice_metrics``: SSSP from
    source 0 under ``sync='overlap', gate='frontier'`` on a grid(2,4)
    partition -- 8 rectangles as the chare axis of one device, where the
    reference runs 8 devices -- against the serial result, with its gate
    accounting; and both phase-2 lowerings' wire bytes per rectangle per
    superstep as the engine counts them (``dispatch["collectives"]``),
    where the reference reads them from the compiled HLO.  ``graph`` and
    ``pg`` (optional) reuse a built weighted graph and its grid(2,4)
    partition.
    """
    spec = get_spec("sssp")
    g = graph if graph is not None else spec.prepare_graph(
        load_dataset(dskey, scale_log2=scale_log2, weighted=spec.weighted))
    if pg is None:
        pg = partition(g, 8, partitioner="grid(2,4)")
    ref = spec.run_serial(g, source=0)
    eng = Engine(pg, device=device)
    out, it = eng.run("sssp", source=0, sync="overlap", gate="frontier")
    bytes_by = {}
    for coll in ("grouped", "full"):
        e = Engine(pg, device=device, collectives=coll)
        e.run("sssp", source=0)
        bytes_by[coll] = e.dispatch["collectives"]["bytes_per_superstep"]
    return {
        "bit_exact": bool(np.array_equal(out, np.asarray(ref))),
        "iters": it,
        "gate": dict(eng.dispatch["gate"]),
        "collective_bytes_counted": bytes_by,
        "counted_ratio": bytes_by["grouped"] / bytes_by["full"],
        "collective_bytes_model": grid_collective_bytes(g, 8, "grid(2,4)"),
    }


# ---------------------------------------------------------------------------
# Out-of-core streaming (residency="stream")
# ---------------------------------------------------------------------------


def streaming_table(scale_log2: int = 13, repeats: int = 3, windows: int = 8,
                    dskey: str = "soc-lj1-mini", device=None) -> dict:
    """Measured out-of-core streaming against the resident engine at
    grid(1,1): whole-run and per-superstep seconds, the prefetcher's overlap
    efficiency and effective edge bandwidth, the frontier gate's fetch-skip
    fraction, the batched plane's edge bytes and queries/s per query at B=1
    and B=16, and the layout cache's cold and warm prep.  SSSP (source 0) is
    the probe program: the streamed run must be bit-exact with equal
    superstep counts.  The engines share one partition (the streamed ones
    never upload its edge planes); the cache rows build their own.
    """
    import shutil
    import tempfile
    import time

    from repro_torch.core import StreamConfig

    spec = get_spec("sssp")
    g = spec.prepare_graph(load_dataset(dskey, scale_log2=scale_log2,
                                        weighted=spec.weighted))
    pg = partition(g, 1, "grid(1,1)")
    eng_r = Engine(pg, device=device)
    dev = eng_r.device
    out_r, it_r = eng_r.run("sssp", source=0)
    t_res = bench(lambda: eng_r.run("sssp", source=0), repeats, dev)

    eng_s = Engine(pg, device=dev, residency="stream",
                   stream=StreamConfig(windows=windows))
    out_s, it_s = eng_s.run("sssp", source=0)
    bit_exact = bool(np.array_equal(out_r, out_s))
    t_str, best_overlap, st = float("inf"), 0.0, None
    for _ in range(repeats):  # dispatch holds the LAST run: keep the best
        t_str = min(t_str, _time(lambda: eng_s.run("sssp", source=0), dev,
                                 1))
        d = eng_s.dispatch["stream"]
        if d["overlap_efficiency"] >= best_overlap:
            best_overlap, st = d["overlap_efficiency"], dict(d)

    # the serialized baseline: the same schedule, no prefetch thread
    eng_0 = Engine(pg, device=dev, residency="stream",
                   stream=StreamConfig(windows=windows, prefetch=False))
    t_ser = bench(lambda: eng_0.run("sssp", source=0), repeats, dev)

    eng_s.run("sssp", source=0, gate="frontier")
    skip = eng_s.dispatch["stream"]["fetch_skip_fraction"]

    # the batched plane over the same window schedule: each staged window
    # is swept once for all B columns, so the edge bytes PER QUERY fall
    # about B-fold while queries/s rise
    rng = np.random.default_rng(0)
    srcs = [int(x) for x in rng.choice(g.num_vertices, 16, replace=False)]
    batched = {}
    for B in (1, 16):
        eng_b = Engine(pg, device=dev, residency="stream",
                       stream=StreamConfig(windows=windows))
        t_b = bench(lambda: eng_b.run_batch("sssp", sources=srcs[:B],
                                            batch=B), repeats, dev)
        d = eng_b.dispatch["stream"]
        batched[f"B{B}"] = {
            "batch": B, "wall_s": t_b, "queries_per_sec": B / t_b,
            "edge_bytes_per_query": d["fetched_bytes_per_query"],
            "fetched_bytes": d["fetched_bytes"],
        }
    batched["bytes_per_query_ratio"] = (
        batched["B16"]["edge_bytes_per_query"]
        / batched["B1"]["edge_bytes_per_query"])

    # the layout cache: cold build + persist against warm mmap, best of
    # the repeats
    cache = tempfile.mkdtemp(prefix="layout_cache_bench_")
    try:
        t_cold = t_warm = float("inf")
        for _ in range(repeats):
            shutil.rmtree(cache, ignore_errors=True)
            t0 = time.perf_counter()
            partition(g, 1, "grid(1,1)", eager=False).shard_source(
                windows=windows, cache_dir=cache)
            t_cold = min(t_cold, time.perf_counter() - t0)
            t0 = time.perf_counter()
            sb = partition(g, 1, "grid(1,1)", eager=False).shard_source(
                windows=windows, cache_dir=cache)
            t_warm = min(t_warm, time.perf_counter() - t0)
            if sb.origin != "disk":
                raise AssertionError("the warm layout cache missed")
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    return {
        "graph": dskey, "algo": "sssp", "windows": st["windows"],
        "iters": it_s, "bit_exact": bit_exact and it_s == it_r,
        "resident_s": t_res, "streamed_s": t_str, "serialized_s": t_ser,
        "superstep_resident_s": t_res / max(it_r, 1),
        "superstep_streamed_s": t_str / max(it_s, 1),
        "overlap_efficiency": best_overlap,
        "copy_s": st["copy_s"], "stall_s": st["stall_s"],
        "edge_bandwidth_bytes_per_s": st["edge_bandwidth_bytes_per_s"],
        "edge_fraction_resident": st["edge_fraction_resident"],
        "total_edge_bytes": st["total_edge_bytes"],
        "gate_skip_fraction": skip,
        "batched": batched,
        "cache_cold_s": t_cold, "cache_warm_s": t_warm,
        "cache_speedup": t_cold / t_warm if t_warm > 0 else float("inf"),
    }
