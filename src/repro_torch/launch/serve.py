"""The persistent graph-query server over ``Engine.run_batch``.

The twin of the graph half of ``repro/launch/serve.py`` (DESIGN.md sections
11 and 14).  Submitted queries (program + source) queue up; each ``step()``
admits up to B compatible requests (same program and params: they share
one plane) and dispatches ONE fixed-width ``run_batch`` call, so every
admitted query rides the same edge sweep.  Admission is pluggable:
``GreedyPolicy`` dispatches immediately in arrival order;
``DeadlinePolicy`` serves the earliest-deadline-compatible group, holds
under-full planes until the head's slack drops below one measured
dispatch time, and round-robins across programs so a long pagerank stream
cannot starve BFS.

    PYTHONPATH=src python -m repro_torch.launch.serve --graph --scale 10 \\
        --queries 32 --batch 8 \\
        --programs bfs,personalized_pagerank --policy deadline

The server runs on CUDA unless ``--device cpu`` is given.  A dispatch is
timed on the host clock around ``run_batch``, which ends in one blocking
copy of the result into pinned host memory (``Engine._to_host``), so the
measured time covers the device's work.  LM serving (``BatchedServer``)
and ``--residency stream`` are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import deque

import numpy as np

from repro_torch.core.engine import _LATER, resolve_device


@dataclasses.dataclass(frozen=True)
class QueryRequest:
    """One queued graph query: a program name, its seed, extra params, and
    the latency bookkeeping (``submit_time`` and an optional absolute
    ``deadline``, both on the server's clock)."""

    id: int
    program: str
    source: object  # original vertex id or a seed-id tuple
    params: tuple  # sorted (name, value) pairs beyond the source
    submit_time: float = 0.0
    deadline: float | None = None  # absolute clock time; None = no SLO

    @property
    def batch_key(self):
        """Requests sharing this key may ride one batched plane."""
        return (self.program, self.params)

    def slack(self, now: float) -> float:
        """Seconds until the deadline (inf when the query has no SLO)."""
        return math.inf if self.deadline is None else self.deadline - now


@dataclasses.dataclass(frozen=True)
class QueryStats:
    """Per-query completion record -- scalars only, so retaining them for
    the server's lifetime costs O(queries) floats, not O(queries * V)."""

    id: int
    program: str
    latency: float  # completion - submit (queue wait + service)
    iters: int
    deadline: float | None
    deadline_missed: bool


class GreedyPolicy:
    """Dispatch immediately, filling the plane with queue-head-compatible
    requests in arrival order.  Never holds a query to wait for a fuller
    batch, never reorders."""

    def select(self, queue, batch, now, est_dispatch_s, force):
        head = queue[0]
        return [r for r in queue if r.batch_key == head.batch_key][:batch]


@dataclasses.dataclass
class DeadlinePolicy:
    """Earliest-deadline-first admission with slack-triggered early
    dispatch and cross-program interleaving.

    Groups the queue by ``batch_key`` and serves the group whose most
    urgent member has the earliest deadline (no-SLO groups rank last, by
    arrival).  A group smaller than the plane width is HELD -- letting
    traffic fill the batch -- until its head's slack drops below
    ``slack_factor`` x one measured dispatch time (then waiting longer
    would miss the deadline), or until ``force`` (the drain path).
    ``est_dispatch_s`` may be a plain float (one global estimate) or a
    callable ``program -> seconds``: the server passes its measured
    per-(program, B) EWMA, so the hold test prices the dispatch of the
    group actually being held.  Among equally urgent groups the one
    dispatched last ranks behind the others, so steady mixed traffic
    alternates programs instead of letting a long stream starve the rest;
    with k live groups a group waits at most k-1 dispatches for its turn
    (the starvation bound, DESIGN.md section 14).
    """

    slack_factor: float = 1.0
    interleave: bool = True
    _last_key: object = dataclasses.field(default=None, repr=False)

    def select(self, queue, batch, now, est_dispatch_s, force):
        groups: dict = {}
        for r in queue:
            groups.setdefault(r.batch_key, []).append(r)

        def rank(item):
            key, members = item
            urgency = min(m.slack(now) for m in members)
            stale = int(self.interleave and len(groups) > 1
                        and key == self._last_key)
            return (urgency, stale, members[0].id)

        key, members = min(groups.items(), key=rank)
        members = sorted(members, key=lambda m: (m.slack(now), m.id))
        take = members[:batch]
        if len(take) < batch and not force:
            est = (est_dispatch_s(key[0]) if callable(est_dispatch_s)
                   else est_dispatch_s)
            if min(m.slack(now) for m in take) > self.slack_factor * est:
                return []  # hold: the plane can still fill in time
        self._last_key = key
        return take


class VirtualClock:
    """Deterministic serving clock for benchmarks and tests: ``now`` only
    moves when the server ``advance``s it by each measured dispatch time,
    so arrival schedules are exact while service times stay measured."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class GraphQueryServer:
    """Persistent serving loop: fixed-B admission batching over one engine.

    ``submit`` enqueues; each ``step`` asks the admission ``policy`` for up
    to ``batch`` compatible requests (same program + params) and dispatches
    one ``Engine.run_batch(..., batch=B)`` call.  The width is pinned, so
    an under-full plane still runs B columns (the padding columns repeat
    query 0) and every dispatch of a program costs the same; the measured
    budgets are keyed by ``(program, B)``.  ``GreedyPolicy`` (default)
    never holds a query hostage to fill the plane; ``DeadlinePolicy`` holds
    under-full batches until deadline slack forces dispatch.

    Results are per-query and READ-ONCE: ``result(id)`` -> (state row,
    supersteps) pops the [V]-sized row, so a long-running server's memory
    is bounded by in-flight queries, not total history.  A row is a view
    into its dispatch's ``[n, V]`` host block (pinned on CUDA), which lives
    until every row of that dispatch has been read.  Scalar ``QueryStats``
    (latency, deadline hit/miss) stay in ``stats``.
    """

    def __init__(self, engine, batch: int = 8, policy=None, clock=None):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.engine = engine
        self.batch = batch
        self.policy = GreedyPolicy() if policy is None else policy
        self.clock = time.monotonic if clock is None else clock
        self._queue: deque[QueryRequest] = deque()
        self._results: dict[int, tuple] = {}
        self.stats: dict[int, QueryStats] = {}
        self._next_id = 0
        self.dispatches = 0  # run_batch calls made (admission diagnostics)
        self.dispatch_time: float | None = None  # global EWMA of measured s
        # measured per-(program, B) dispatch budgets: the admission policy
        # prices each group's hold against ITS program's EWMA, and
        # tables.latency_table derives the SLO from the same record
        self.dispatch_times: dict[tuple, float] = {}
        self.last_dispatch_s: float | None = None

    def submit(self, program: str, source, deadline: float | None = None,
               **params) -> int:
        """Enqueue one query; ``deadline`` is relative seconds from now
        (stored absolute on the server's clock).  Returns the request id."""
        if not isinstance(source, (int, np.integer)):
            source = tuple(int(v) for v in source)
            if not source:
                raise ValueError(
                    f"query needs a non-empty seed set (program "
                    f"{program!r} submitted with an empty source)")
        else:
            source = int(source)
        rid = self._next_id
        self._next_id += 1
        now = self.clock()
        self._queue.append(QueryRequest(
            rid, program, source, tuple(sorted(params.items())),
            submit_time=now,
            deadline=None if deadline is None else now + float(deadline)))
        return rid

    def est_dispatch(self, program: str) -> float:
        """Measured dispatch-time estimate for ``program`` at this server's
        width -- the per-(program, B) EWMA, falling back to the global EWMA
        for a program not yet dispatched (and 0.0 cold, so a fresh server
        never holds on a fictitious budget)."""
        est = self.dispatch_times.get((program, self.batch),
                                      self.dispatch_time)
        return 0.0 if est is None else est

    def pending(self) -> int:
        return len(self._queue)

    def queued(self) -> tuple:
        """Snapshot of the waiting requests (for schedulers/benchmarks that
        need to see deadlines without reaching into the deque)."""
        return tuple(self._queue)

    def held_result_bytes(self) -> int:
        """Host bytes pinned by unread results: each dispatch's ``[n, V]``
        block counts once while any of its rows is unread."""
        blocks = {}
        for row, _ in self._results.values():
            base = row if row.base is None else row.base
            blocks[id(base)] = base.nbytes
        return sum(blocks.values())

    def step(self, force: bool = False) -> list[int]:
        """Admit + dispatch one batch; returns the completed request ids.
        Returns [] both for an empty queue and when the policy elects to
        hold (waiting for the plane to fill); ``force`` overrides holds."""
        if not self._queue:
            return []
        now = self.clock()
        admitted = self.policy.select(tuple(self._queue), self.batch, now,
                                      self.est_dispatch, force)
        if not admitted:
            return []
        chosen = {r.id for r in admitted}
        self._queue = deque(r for r in self._queue if r.id not in chosen)
        # run_batch returns after its blocking copy to the host, so this
        # host-clock interval covers the device's work
        t0 = time.perf_counter()
        plane, iters = self.engine.run_batch(
            admitted[0].program, sources=[r.source for r in admitted],
            batch=self.batch, **dict(admitted[0].params))
        dt = time.perf_counter() - t0
        self.last_dispatch_s = dt
        self.dispatch_time = dt if self.dispatch_time is None \
            else 0.7 * self.dispatch_time + 0.3 * dt
        pkey = (admitted[0].program, self.batch)
        prev = self.dispatch_times.get(pkey)
        self.dispatch_times[pkey] = dt if prev is None \
            else 0.7 * prev + 0.3 * dt
        if hasattr(self.clock, "advance"):
            self.clock.advance(dt)
        done_t = self.clock()
        self.dispatches += 1
        for i, req in enumerate(admitted):
            self._results[req.id] = (plane[i], int(iters[i]))
            # expired queries are SERVED and flagged, never dropped
            self.stats[req.id] = QueryStats(
                id=req.id, program=req.program,
                latency=done_t - req.submit_time, iters=int(iters[i]),
                deadline=req.deadline,
                deadline_missed=(req.deadline is not None
                                 and done_t > req.deadline))
        return [r.id for r in admitted]

    def drain(self) -> int:
        """Force-run steps until the queue is empty; returns the count of
        queries completed by THIS call (holds are overridden -- a drained
        server has dispatched everything)."""
        n = 0
        while self._queue:
            n += len(self.step(force=True))
        return n

    def result(self, rid: int):
        """Pop and return ``(state row, supersteps)`` for a finished query.
        READ-ONCE: the row is removed so completed state does not pin
        [V]-sized buffers forever; a second read raises KeyError."""
        if rid not in self._results:
            raise KeyError(f"request {rid} not finished (or unknown)")
        return self._results.pop(rid)


def _graph_main(args):
    """Serve ``args.queries`` queries of ``args.programs`` on an RMAT graph
    of ``2^args.scale`` vertices; returns the metrics it prints."""
    from repro_torch.core import Engine, partition, rmat

    if getattr(args, "residency", "resident") == "stream":
        raise NotImplementedError(_LATER["stream"])
    device = resolve_device(getattr(args, "device", None))  # before any work
    g = rmat(args.scale, 8 * (2 ** args.scale), seed=0, weighted=True)
    eng = Engine(partition(g, 1), device=device)
    policy = DeadlinePolicy() if args.policy == "deadline" else GreedyPolicy()
    server = GraphQueryServer(eng, batch=args.batch, policy=policy)
    rng = np.random.default_rng(0)
    programs = [p.strip() for p in args.programs.split(",") if p.strip()]
    ids = []
    for q in range(args.queries):
        prog = programs[q % len(programs)]
        src = int(rng.integers(g.num_vertices))
        extra = dict(iters=args.ppr_iters) \
            if prog == "personalized_pagerank" else {}
        ids.append(server.submit(prog, src, deadline=args.deadline, **extra))
    # warm-up outside the timed loop (forced: the deadline policy would
    # otherwise hold an under-full first batch); on the card the first
    # dispatch also builds the kernels and learns the tile plan
    warmed = len(server.step(force=True))
    t0 = time.time()
    drained = server.drain()
    dt = time.time() - t0
    # steady-state qps counts ONLY queries completed inside the timed
    # drain: the warm-up step's completions are excluded from the
    # numerator exactly as their wall-clock is excluded from the
    # denominator
    qps = drained / max(dt, 1e-9)
    missed = sum(s.deadline_missed for s in server.stats.values())
    lat = sorted(s.latency for s in server.stats.values())
    metrics = dict(queries=len(ids), warmup=warmed, drained=drained,
                   wall_s=dt, qps=qps, dispatches=server.dispatches,
                   deadline_missed=missed,
                   p50_s=lat[len(lat) // 2] if lat else 0.0)
    print(f"[serve-graph] scale={args.scale} B={args.batch} "
          f"policy={args.policy}: {drained} queries in the timed drain "
          f"({warmed} warm-up, {server.dispatches} dispatches total), "
          f"steady-state {qps:.1f} queries/s, {missed} deadline misses")
    row, iters = server.result(ids[0])
    row = np.asarray(row)
    reach = int((row < 2**31 - 1).sum()) if row.dtype.kind == "i" \
        else int((row > 0).sum())
    print(f"[serve-graph] sample result: query {ids[0]} "
          f"iters={iters} reached={reach}")
    return metrics


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--graph", action="store_true",
                    help="serve graph queries (Engine.run_batch) instead of "
                         "LM decode")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--queries", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--programs", default="bfs",
                    help="comma-separated program mix for --graph traffic")
    ap.add_argument("--policy", choices=("greedy", "deadline"),
                    default="greedy")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-query SLO in seconds (relative to submit)")
    ap.add_argument("--ppr-iters", type=int, default=10,
                    help="fixed iterations for personalized_pagerank traffic")
    ap.add_argument("--residency", choices=("resident", "stream"),
                    default="resident",
                    help="graph residency for --graph serving ('stream' is "
                         "not ported yet)")
    ap.add_argument("--windows", type=int, default=4,
                    help="edge-window count for --residency=stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if not args.graph:
        raise NotImplementedError(
            "LM serving (BatchedServer, --arch) is not ported yet (ROADMAP "
            "queue 1, item 12); pass --graph to serve graph queries")
    return _graph_main(args)


if __name__ == "__main__":
    main()
