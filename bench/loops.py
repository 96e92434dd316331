"""The two ways a cell drives the system: a closed loop and an open loop.

* ``closed_loop`` -- one analytics client: ``Engine.run`` after
  ``Engine.run``, each started as soon as the last returned, from the
  window's opening until it closes.  A run's result is on the host when
  ``run`` returns (its blocking copy into pinned memory).
* ``open_loop`` -- independent users: queries are submitted to the
  ``GraphQueryServer`` when due, whatever the server is doing, and each
  one's latency runs from its due time to the moment its result row is on
  the host.  After the window closes no query is added; the ones due in it
  are served to the end (holds overridden), a minute at the most.

Both keep a sample of the answers, drawn from the seed, for the check
against the references, and drop every other result at once, so no host
memory piles up.  ``Tracer`` spans mark each call into the program.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np

from bench.traffic import generator

SAMPLE_STREAM = 3
DRAIN_LIMIT_S = 60.0


@dataclasses.dataclass
class Answer:
    """One run or query of the window, as the check sees it."""

    program: str
    params: dict
    source: int | None
    supersteps: int | None = None
    value: np.ndarray | None = None  # kept only for the sampled ones
    traced: bool = False


class Reservoir:
    """``k`` items drawn uniformly from a stream of unknown length, from a
    seeded stream (Algorithm R): the same seed and count keep the same."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.n = k, rng, 0
        self.items: list = []

    def offer(self) -> int | None:
        """The slot the next item goes to, or None to drop it."""
        n, self.n = self.n, self.n + 1
        if n < self.k:
            self.items.append(None)
            return n
        j = int(self.rng.integers(n + 1))
        return j if j < self.k else None


def _run_kwargs(params: dict, source):
    kw = dict(params)
    if source is not None:
        kw["source"] = source
    return kw


def warm_closed(engine, mix: dict, starts: np.ndarray, rounds: int = 2):
    """Every program of the mix, ``rounds`` times: builds and loads the
    kernels, learns the tile plans and fills the pinned-memory cache."""
    src = int(starts[len(starts) // 2])
    for _ in range(rounds):
        for p in mix["programs"]:
            engine.run(p["program"], **_run_kwargs(
                p.get("params", {}), src if p.get("source") else None))


def closed_loop(engine, mix: dict, seed: int, starts: np.ndarray,
                seconds: float, sample_per_program: int, tracer,
                trace_runs: int, clock=time.perf_counter) -> dict:
    """Runs from the window's opening to its close; a traced run profiles
    ``trace_runs`` runs from 0.6 of the window on.  Returns the runs'
    (start, end, supersteps, traced), the sampled answers and the traced
    runs."""
    runs_iter = generator.closed_runs(mix, seed, starts)
    rng = generator.rng_for(seed, SAMPLE_STREAM)
    pools: dict[str, Reservoir] = {}
    times, answers_traced = [], []
    t_open = clock()
    close = t_open + seconds
    trace_from = t_open + seconds * 0.6
    while True:
        t = clock()
        if t >= close:
            break
        if tracer.enabled and not (tracer.active or tracer.done) \
                and t >= trace_from:
            tracer.start()
        program, params, source = next(runs_iter)
        with tracer.span(f"run.{program}"):
            out, iters = engine.run(program, **_run_kwargs(params, source))
        t2 = clock()
        times.append((t, t2, int(iters), tracer.active))
        if tracer.active:
            answers_traced.append(Answer(program, params, source, int(iters),
                                         traced=True))
            if len(answers_traced) >= trace_runs:
                tracer.stop()
        pool = pools.setdefault(program,
                                Reservoir(sample_per_program, rng))
        slot = pool.offer()
        if slot is not None:
            pool.items[slot] = Answer(program, params, source, int(iters),
                                      np.array(out))
        del out
    if tracer.active:
        tracer.stop()
    sampled = [a for p in pools.values() for a in p.items]
    return {"runs": times, "answers": sampled + answers_traced}


def warm_server(server, mix: dict, starts: np.ndarray, rounds: int = 2):
    """Full planes of every program of the mix, ``rounds`` times, forced
    through: the kernels, the tile plans, the per-program dispatch budgets
    of the admission policy and the pinned-memory cache, all warm."""
    src = [int(s) for s in starts[:server.batch]]
    for _ in range(rounds):
        for m in mix["mix"]:
            ids = [server.submit(m["program"], s, **m.get("params", {}))
                   for s in src]
            while server.pending():
                server.step(force=True)
            for rid in ids:
                server.result(rid)


def open_loop(server, arrivals: list, seconds: float, sample: set,
              tracer, trace_seconds: float, clock=time.perf_counter) -> dict:
    """Serve ``arrivals`` (``generator.Arrival``, due times relative to the
    window's opening); a traced run profiles the window's last
    ``trace_seconds``.  Returns each query's due and done times (None when
    never served), the sampled answers and the record of the dispatches
    made in the window outside the traced stretch."""
    N = len(arrivals)
    done_at: list = [None] * N
    answers: dict[int, Answer] = {}
    by_rid: dict[int, int] = {}
    disp = {"count": 0, "seconds": 0.0, "queries": 0,
            "batch": server.batch}
    slack = getattr(server.policy, "slack_factor", None)
    nxt = 0
    t_open = clock()
    close = t_open + seconds
    trace_from = close - trace_seconds
    lateness = 0.0
    while True:
        now = clock()
        if tracer.enabled and not (tracer.active or tracer.done) \
                and now >= trace_from:
            tracer.start()
        if tracer.active and now >= trace_from + trace_seconds:
            tracer.stop()
        while nxt < N and t_open + arrivals[nxt].due_s <= now:
            a = arrivals[nxt]
            late = now - (t_open + a.due_s)
            lateness = max(lateness, late)
            rid = server.submit(a.program, a.source,
                                deadline=a.deadline_s - late, **a.params)
            by_rid[rid] = nxt
            nxt += 1
        if nxt == N and not server.pending():
            break
        if now > close + DRAIN_LIMIT_S:
            break
        with tracer.span("dispatch"):
            done = server.step(force=now >= close)
        if done:
            t = clock()
            if now < close and not tracer.active:
                disp["count"] += 1
                disp["seconds"] += server.last_dispatch_s
                disp["queries"] += len(done)
            for rid in done:
                row, iters = server.result(rid)
                i = by_rid[rid]
                done_at[i] = t
                if i in sample:
                    a = arrivals[i]
                    answers[i] = Answer(a.program, a.params, a.source,
                                        int(iters), np.array(row))
                del row
            continue
        # idle or held: sleep to the next arrival or the moment the most
        # urgent held query's slack runs out
        wake = t_open + arrivals[nxt].due_s if nxt < N else math.inf
        if slack is not None:
            for r in server.queued():
                if r.deadline is not None:
                    wake = min(wake, r.deadline
                               - slack * server.est_dispatch(r.program))
        with tracer.span("wait"):
            time.sleep(min(max(wake - clock(), 5e-5), 5e-3))
    if tracer.active:
        tracer.stop()
    for i in sample:
        if i not in answers:  # never served: judged as missing
            a = arrivals[i]
            answers[i] = Answer(a.program, a.params, a.source)
    due = [t_open + a.due_s for a in arrivals]
    return {"due": due, "done": done_at, "close": close, "t_open": t_open,
            "answers": [answers[i] for i in sorted(answers)],
            "dispatch": disp, "lateness_s": lateness}


def sample_queries(arrivals: list, per_program: int, seed: int) -> set:
    """``per_program`` query indices of each program, drawn from the seed."""
    rng = generator.rng_for(seed, SAMPLE_STREAM)
    out = set()
    for prog in sorted({a.program for a in arrivals}):
        idx = [i for i, a in enumerate(arrivals) if a.program == prog]
        take = min(per_program, len(idx))
        out.update(int(i) for i in rng.choice(idx, size=take, replace=False))
    return out


def percentile(values, q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]
