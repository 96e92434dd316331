"""Rank bodies and cells of the adaptive-mode mesh tests
(``tests/test_torch_mesh_modes.py``).

The cells are ``tests/test_multidevice.py``'s own, at its sizes: cell 1d's
replans (and their ``REPRO_SYNC=overlap`` leg), ``GRID_SCRIPT``'s 1-D <->
2-D replans, ``ASYNC_SCRIPT``'s overlap-plus-gate cells, lowerings, gate
record and batched overlap plane, and ``STREAM_SCRIPT``'s streamed cells;
then a cold start of W ranks on one empty layout cache and the graph
server over a mesh engine.  ``world_cells`` runs every cell of one world
size on the ranks of one spawn; ``run_cell(cell, W, mesh)`` runs one, on
a mesh, on the port's one-device engine at the same chare count
(``mesh=None``), or through the JAX reference (``lib="repro"``, whose
chares ``shard_map`` shards over W devices: ``reference_main``).
"""

from __future__ import annotations

import importlib
import pickle
import tempfile
import time

import numpy as np
import torch

from torch_mesh_cases import BATCH_SRCS, _same_on_every_rank, graphs

ONE_D_PAIRS = (("contiguous", "reduction"), ("edge_balanced", "sortdest"),
               ("striped", "basic"), ("degree_sorted", "pairs"))
GRID_REPLANS = (("contiguous", "grid(2,4)"), ("edge_balanced", "grid(4,2)"),
                ("grid(2,4)", "degree_sorted"), ("grid(4,2)", "grid(2,4)"))
LOWERINGS = {4: ("grid(2,2)",), 8: ("grid(2,4)", "grid(4,2)")}
STREAM_SHAPES = {2: "grid(1,2)", 8: "grid(2,4)"}
STREAM_SRCS = (7, 100, 3, 250, 9)  # 5 sources into B=8: padding columns
ASYNC_SRCS = (3, 0, 17, 41)
OVERLAP = {"sync": "overlap", "gate": "frontier"}
# the streamed record's fields every rank holds alike (the times and rates
# are each rank's own)
STREAM_KEYS = ("windows", "supersteps", "fetches", "fetched_bytes",
               "fetch_slots", "fetch_skipped", "batch",
               "fetched_bytes_per_query")


def cells(W: int) -> list[tuple]:
    """Every cell of world size ``W``, as a static tuple (its test id)."""
    out = []
    if W in (2, 8):
        for sync in ("barrier", "overlap"):
            out += [("replan_sssp", t, sync)
                    for t in ("edge_balanced", "striped", "degree_sorted")]
            out.append(("replan_bfs", sync))
        out.append(("replan_pagerank",))
        out += [("async", p, s, prog) for p, s in ONE_D_PAIRS
                for prog in ("sssp", "bfs")]
        shape = STREAM_SHAPES[W]
        out += [("stream", shape, prog, gate) for prog in ("sssp", "bfs")
                for gate in ("none", "frontier")]
        out += [("stream_batch", shape, prog) for prog in ("sssp", "bfs")]
    if W == 2:
        out += [("replan_batch",), ("replan_skew",), ("stream_warm",)]
    if W == 4:
        out += [("async", "grid(2,2)", "grid2d", prog)
                for prog in ("sssp", "bfs")]
        out.append(("cache_cold",))
    if W == 8:
        out += [("replan_grid", s, t) for s, t in GRID_REPLANS]
        out.append(("replan_grid_pagerank",))
        out += [("async", "grid(2,4)", "grid2d", prog)
                for prog in ("sssp", "bfs")]
        out += [("gate_record",), ("async_batch",)]
    for shape in LOWERINGS.get(W, ()):
        out += [("lowering", shape, coll) for coll in ("grouped", "full")]
    if W in (2, 4):
        out += [("serve", policy) for policy in ("greedy", "deadline")]
    return out


def _policy(lib, target, every, mode="always", **kw):
    engine = importlib.import_module(lib + ".core.engine")
    return engine.ReplanPolicy(target, every=every, mode=mode, **kw)


def _sync(cell):
    return OVERLAP if cell[-1] == "overlap" else {}


def stream_graph(lib="repro_torch"):
    """``STREAM_SCRIPT``'s graph."""
    core = importlib.import_module(lib + ".core")
    return core.random_weights(core.rmat(10, 6000, seed=3), seed=5)


def run_cell(cell, W, mesh=None, lib="repro_torch", cache=None):
    """One cell at W chares, on ``mesh`` or (None) on the one-device engine
    on the CPU; ``lib="repro"``: on the JAX reference's W-device mesh.
    ``cache`` is the layout cache directory the streamed cells share.  ->
    a tuple of numpy arrays, ints and records (dicts)."""
    core = importlib.import_module(lib + ".core")
    Engine, partition, run_parallel = (core.Engine, core.partition,
                                       core.run_parallel)
    gr = graphs(lib)
    dev = ({} if lib == "repro" else {"device": "cpu"} if mesh is None
           else {"mesh": mesh})
    kind = cell[0]
    if kind == "replan_sssp":
        return run_parallel(gr["gw"], "sssp", W, strategy="sortdest",
                            partitioner="contiguous", source=7,
                            replan=_policy(lib, cell[1], 2), **_sync(cell),
                            **dev)
    if kind == "replan_bfs":
        return run_parallel(gr["g"], "bfs", W, strategy="reduction",
                            partitioner="striped", source=7,
                            replan=_policy(lib, "degree_sorted", 3),
                            **_sync(cell), **dev)
    if kind == "replan_pagerank":
        return run_parallel(gr["g"], "pagerank", W, strategy="sortdest",
                            partitioner="contiguous",
                            replan=_policy(lib, "edge_balanced", 5), **dev)
    if kind == "replan_skew":
        eng = Engine(partition(gr["gw"], W), **dev)
        got = eng.run("sssp", source=7, replan=_policy(
            lib, "edge_balanced", 2, mode="skew", threshold=1.0))
        return got + (eng.pg.partitioner,)
    if kind == "replan_batch":
        eng = Engine(partition(gr["gw"], W), **dev)
        return eng.run_batch("sssp", sources=list(BATCH_SRCS), batch=8,
                             replan=_policy(lib, "degree_sorted", 2))
    if kind == "replan_grid":
        return run_parallel(gr["grid_gw"], "sssp", W, strategy="sortdest",
                            partitioner=cell[1], source=3,
                            replan=_policy(lib, cell[2], 2), **dev)
    if kind == "replan_grid_pagerank":
        return run_parallel(gr["grid_g"], "pagerank", W,
                            partitioner="contiguous",
                            replan=_policy(lib, "grid(2,4)", 5), **dev)
    if kind == "async":
        _, pname, strat, prog = cell
        graph = gr["grid_gw"] if prog == "sssp" else gr["grid_g"]
        eng = Engine(partition(graph, W, partitioner=pname), strategy=strat,
                     **dev)
        return (eng.run(prog, source=3)
                + eng.run(prog, source=3, **OVERLAP))
    if kind == "lowering":
        _, pname, coll = cell
        eng = Engine(partition(gr["grid_gw"], W, partitioner=pname),
                     collectives=coll, **dev)
        if mesh is not None:
            mesh.reset_calls()
        out = eng.run("sssp", source=3)
        wire = {} if mesh is None else dict(mesh.bytes)
        return out + eng.run("sssp", source=3, **OVERLAP) + (wire,)
    if kind == "gate_record":
        eng = Engine(partition(gr["grid_gw"], W, partitioner="grid(2,4)"),
                     **dev)
        got = eng.run("sssp", source=3, **OVERLAP)
        return got + (dict(eng.dispatch["gate"]),)
    if kind == "async_batch":
        eng = Engine(partition(gr["grid_gw"], W,
                               partitioner="edge_balanced"),
                     strategy="reduction", **dev)
        return eng.run_batch("sssp", sources=list(ASYNC_SRCS), batch=4,
                             **OVERLAP)
    if kind in ("stream", "stream_batch"):
        return _stream(core, cell, W, dev, cache, lib)
    if kind == "stream_warm":
        return _stream_warm(core, W, dev, cache, lib)
    if kind == "cache_cold":
        return _cache_cold(core, W, dev, mesh)
    if kind == "serve":
        eng = Engine(partition(gr["gw"], W), **dev)
        return serve_load(lib, eng, cell[1])
    raise ValueError(f"unknown cell {cell!r}")


def _host(x):
    """A cell's result as numpy arrays, Python scalars and records."""
    if isinstance(x, (tuple, list)):
        return tuple(_host(y) for y in x)
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return np.asarray(x)


def _record(st):
    return {k: st[k] for k in STREAM_KEYS if k in st}


def _stream(core, cell, W, dev, cache, lib):
    """A streamed cell and the resident engine's run of it, on the same
    placement: -> (streamed result, supersteps, the stream record, the
    resident result, its supersteps)."""
    g = stream_graph(lib)
    shape, prog = cell[1], cell[2]
    eng = core.Engine(core.partition(g, W, shape, eager=False),
                      residency="stream",
                      stream=core.StreamConfig(windows=4, cache_dir=cache),
                      **dev)
    res = core.Engine(core.partition(g, W, shape), **dev)
    if cell[0] == "stream":
        gate = None if cell[3] == "none" else cell[3]
        got = eng.run(prog, source=7, gate=gate)
        want = res.run(prog, source=7)
    else:
        got = eng.run_batch(prog, sources=list(STREAM_SRCS), batch=8)
        want = res.run_batch(prog, sources=list(STREAM_SRCS), batch=8)
    return got + (_record(eng.dispatch["stream"]),) + want


def _stream_warm(core, W, dev, cache, lib):
    """``STREAM_SCRIPT``'s warm restart: a new streamed engine opens the
    entry the W ranks' first streamed engine cold-wrote."""
    g = stream_graph(lib)
    eng = core.Engine(core.partition(g, W, "grid(1,2)", eager=False),
                      residency="stream",
                      stream=core.StreamConfig(windows=4, cache_dir=cache),
                      **dev)
    got = eng.run("sssp", source=7)
    want = core.Engine(core.partition(g, W, "grid(1,2)"), **dev).run(
        "sssp", source=7)
    return got + (eng.dispatch["stream"]["origin"],) + want


def _cache_cold(core, W, dev, mesh):
    """W ranks cold-start one streamed engine each on ONE empty layout
    cache, run it against the resident engine, then restart warm: ->
    (the cold engines' origins by rank, streamed result, supersteps,
    resident result, supersteps, the warm engine's origin, its result,
    supersteps).  On one device the same with a private cache."""
    import torch.distributed as dist

    g = stream_graph()
    with tempfile.TemporaryDirectory(prefix="cold_cache_") as own:
        cache = own
        if mesh is not None:  # rank 0's empty directory, on every rank
            cache = mesh.broadcast(own)

        def streamed():
            return core.Engine(core.partition(g, W, "grid(2,2)",
                                              eager=False),
                               residency="stream",
                               stream=core.StreamConfig(windows=3,
                                                        cache_dir=cache),
                               **dev)

        cold = streamed()
        origins = [cold.dispatch["stream"]["origin"]]
        if mesh is not None:
            origins = [None] * mesh.size
            dist.all_gather_object(origins, cold.dispatch["stream"]["origin"])
        got = cold.run("sssp", source=7)
        want = core.Engine(core.partition(g, W, "grid(2,2)"), **dev).run(
            "sssp", source=7)
        warm = streamed()
        again = warm.run("sssp", source=7)
        out = (tuple(origins),) + got + want + (
            warm.dispatch["stream"]["origin"],) + again
        if mesh is not None:  # rank 0 leaves (and removes) it last
            mesh.vote(torch.ones(1, device=mesh.device))
    return out


class FixedStepTime:
    """Stands in for the server module's ``time``: ``perf_counter``
    advances by each of ``steps`` in turn, so every dispatch measures a
    known time (``tests/test_torch_serve.py``'s stand-in)."""

    def __init__(self, steps=(0.25,)):
        self.t, self.steps, self.calls = 0.0, steps, 0
        self.monotonic, self.time = time.monotonic, time.time

    def perf_counter(self):
        self.t += self.steps[self.calls % len(self.steps)]
        self.calls += 1
        return self.t


def serve_load(lib, eng, policy):
    """A served load of bfs and personalized PageRank at B=8 over ``eng``,
    on a virtual clock with fixed dispatch steps: arrivals every 0.1 s, a
    step after every third, deadlines on two of three, then a drain.  ->
    (each step's dispatched ids, the drained count, dispatches, each
    query's row and supersteps, each query's (program, latency, supersteps,
    deadline missed))."""
    serve = importlib.import_module(lib + ".launch.serve")
    saved = serve.time
    serve.time = FixedStepTime((0.2, 0.35, 0.3))
    try:
        clock = serve.VirtualClock()
        server = serve.GraphQueryServer(
            eng, batch=8, clock=clock,
            policy=(serve.DeadlinePolicy() if policy == "deadline"
                    else serve.GreedyPolicy()))
        V = eng.pg.graph.num_vertices
        rng = np.random.default_rng(23)
        ids, steps = [], []
        for i in range(24):
            if i % 3 == 2:
                prog, src, kw = ("personalized_pagerank",
                                 tuple(int(v) for v in rng.integers(V, size=2)),
                                 {"iters": 4})
            else:
                prog, src, kw = "bfs", int(rng.integers(V)), {}
            ids.append(server.submit(prog, src,
                                     deadline=(None, 0.6, 2.0)[i % 3], **kw))
            clock.advance(0.1)
            if i % 3 == 2:
                steps.append(tuple(server.step()))
        drained = server.drain()
        rows = tuple(_host(server.result(i)) for i in ids)
        stats = tuple((s.program, s.latency, s.iters, s.deadline_missed)
                      for s in (server.stats[i] for i in ids))
        return tuple(steps), drained, server.dispatches, rows, stats
    finally:
        serve.time = saved


def reference_main(out_path, world_cells):
    """Run each ``(W, cell)`` of ``world_cells`` through the JAX reference,
    on a W-device mesh, and pickle ``{(W, cell): result}`` to ``out_path``
    (the streamed cells share one layout cache, as the ranks' do)."""
    with tempfile.TemporaryDirectory(prefix="ref_cache_") as cache:
        out = {(W, cell): _host(run_cell(cell, W, lib="repro", cache=cache))
               for W, cell in world_cells}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def world_cells(mesh, cache):
    """Every cell of this world size on this rank, the streamed ones on the
    shared layout cache ``cache``, with the collectives each issued on this
    rank: -> {"cells": {cell: result}, "calls": {cell: {kind: count}}}."""
    out, calls = {}, {}
    for cell in cells(mesh.size):
        mesh.reset_calls()
        out[cell] = run_cell(cell, mesh.size, mesh, cache=cache)
        calls[cell] = dict(mesh.calls)
    _same_on_every_rank(mesh, out)
    return {"cells": out, "calls": calls}


def cache_dir_for(W):
    """A fresh layout-cache directory for one spawn (the caller removes
    it)."""
    return tempfile.mkdtemp(prefix=f"mesh_modes_{W}_")
