"""Serving: the LM batched-decode server, and the persistent
graph-query server over ``Engine.run_batch``.

The twin of ``repro/launch/serve.py`` (DESIGN.md sections 11 and 14).

LM mode -- ``BatchedServer``: requests arrive with prompts, get packed
into a static batch of slots, prefilled (one decode step per prompt token)
and decoded together, greedily:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --requests 8 --prompt-len 16 --gen 16

Graph mode -- submitted queries (program + source) queue up; each ``step()``
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
measured time covers the device's work.  ``--residency stream`` serves
out of core: the engine keeps the edge planes on the host and sweeps each
prefetched edge window once for all B admitted queries (``--windows``
windows a superstep).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models import model as M
from repro_torch.models import serve as SV


class BatchedServer:
    """Slot-based batching: a static batch of ``batch_slots`` requests,
    prefilled through decode steps, then decoded together, greedily.

    The cache and the current tokens stay on ``device`` (CUDA unless the
    caller names another); ``decode`` copies its tokens to the host once,
    at its end.  ``logits`` holds the last step's logits [B,1,V] f32.
    """

    def __init__(self, cfg, params, batch_slots: int, max_len: int,
                 device=None):
        self.cfg, self.params = cfg, params
        self.B, self.max_len = batch_slots, max_len
        self.device = resolve_device(device)
        self.cache = M.init_cache(cfg, batch_slots, max_len, self.device)
        self.pos = 0
        self.tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.logits = None

    def _step(self, tokens):
        self.logits, self.cache = M.decode_step(self.params, tokens, self.pos,
                                                self.cache, self.cfg)
        self.pos += 1

    def prefill(self, prompts: np.ndarray):
        """prompts: [B, S0] i32 -- runs the prompt through decode steps;
        returns the first generated tokens [B, 1] (on the device)."""
        B, S0 = prompts.shape
        assert B == self.B
        prompts = torch.as_tensor(np.asarray(prompts, np.int32),
                                  device=self.device)
        self.pos = 0
        for i in range(S0):
            self._step(prompts[:, i:i + 1])
        self.tokens = SV.sample_greedy(self.logits)
        return self.tokens

    def decode(self, steps: int) -> np.ndarray:
        """``steps`` greedy decode steps -> the new tokens [B, steps]."""
        out = []
        for _ in range(steps):
            self._step(self.tokens)
            self.tokens = SV.sample_greedy(self.logits)
            out.append(self.tokens[:, 0])
        return torch.stack(out, dim=1).cpu().numpy()  # [B, steps]


def _lm_main(args):
    """Serve ``args.requests`` random prompts of ``args.prompt_len`` tokens
    and decode ``args.gen`` tokens each on ``args.arch`` (random parameters
    from seed 0); returns the metrics it prints."""
    from repro_torch import configs

    cfg = (configs.smoke_config if args.smoke else configs.get_config)(
        args.arch)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    device = resolve_device(getattr(args, "device", None))
    params = M.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device)
    max_len = args.prompt_len + args.gen + 1
    server = BatchedServer(cfg, params, args.requests, max_len, device=device)

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len),
                           dtype=np.int32)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.time()
    server.prefill(prompts)
    sync()
    t_prefill = time.time() - t0
    t0 = time.time()
    toks = server.decode(args.gen)  # ends in its copy to the host
    t_decode = time.time() - t0
    tps = args.requests * args.gen / t_decode
    print(f"[serve] {args.requests} reqs: prefill {t_prefill:.2f}s, "
          f"decode {args.gen} steps in {t_decode:.2f}s ({tps:.1f} tok/s)")
    print("[serve] sample output tokens:", toks[0, :10])
    return dict(arch=cfg.name, requests=args.requests,
                prompt_len=args.prompt_len, gen=args.gen,
                prefill_s=t_prefill, decode_s=t_decode, tok_per_s=tps,
                tokens=toks)


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

    Over a mesh engine (``Engine(pg, mesh=...)``) every rank builds the
    same server and submits the same requests in the same order, as an
    SPMD program does.  Only rank 0 asks the policy, with its clock and
    budgets, and broadcasts the admitted ids (or a hold); every rank then
    dispatches the same group, so the ranks meet in the same collectives.
    Rank 0's measured dispatch times are the budgets and its ``stats`` the
    record; every rank holds the same result rows.
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
        mesh = getattr(self.engine, "mesh", None)
        if mesh is None or mesh.rank == 0:
            admitted = self.policy.select(tuple(self._queue), self.batch,
                                          now, self.est_dispatch, force)
        if mesh is not None:  # rank 0's admission, on every rank
            ids = mesh.broadcast(tuple(r.id for r in admitted)
                                 if mesh.rank == 0 else None)
            by_id = {r.id: r for r in self._queue}
            admitted = [by_id[i] for i in ids]
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
    from repro_torch.core.engine import StreamConfig

    device = resolve_device(getattr(args, "device", None))  # before any work
    g = rmat(args.scale, 8 * (2 ** args.scale), seed=0, weighted=True)
    if getattr(args, "residency", "resident") == "stream":
        # out-of-core serving: the edge planes never become device-resident;
        # every dispatched batch sweeps each prefetched edge window once for
        # all B admitted queries
        eng = Engine(partition(g, 1, partitioner="grid(1,1)"), device=device,
                     residency="stream",
                     stream=StreamConfig(windows=getattr(args, "windows", 4)))
    else:
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
                    help="graph residency for --graph serving: 'stream' "
                         "serves out-of-core, sweeping each prefetched edge "
                         "window once for all B admitted queries")
    ap.add_argument("--windows", type=int, default=4,
                    help="edge-window count for --residency=stream")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.graph:
        return _graph_main(args)
    if args.arch is None:
        ap.error("--arch is required unless --graph is given")
    return _lm_main(args)


if __name__ == "__main__":
    main()
