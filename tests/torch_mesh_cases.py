"""Rank bodies and cells of the PE-mesh tests (``tests/test_torch_mesh*.py``).

``repro_torch.core.mesh.spawn`` starts fresh processes that import the
function they run by name, so the bodies live in this importable module.
One spawn runs every cell of one world size (``world_cells``) or every
collective case (``collective_cases``); each returns, from rank 0, what
every rank computed alike (an ``all_gather`` of each rank's digest checks
that every rank holds the same results).

``run_cell(cell, W, mesh)`` runs one cell: on a mesh of W ranks, or with
``mesh=None`` on the port's one-device engine at the same chare count --
the comparison the tests make in the parent process.  With
``lib="repro"`` it runs the cell through the JAX reference's engine, whose
chares are ``shard_map`` shards over W devices: ``reference_main`` runs
cells so in a process with forced host devices.  The cells are
``tests/test_multidevice.py``'s graph cells (1, 1b, 1c, 1e, 1f) and
``GRID_SCRIPT``'s 25 grid cells and grid PPR plane, at W = 2, 4 (1-D) and
the grid shapes of W = 2, 4, 8.
"""

from __future__ import annotations

import functools
import hashlib
import importlib
import pickle
import time

import numpy as np
import torch

STRATS = ("reduction", "sortdest", "basic", "pairs")
PARTITIONERS = ("contiguous", "edge_balanced", "striped", "degree_sorted")
HOOK_STRATS = ("reduction", "sortdest", "pairs")
BATCH_SRCS = (7, 0, 91, 200, 133)
PPR_SEEDS = ((0,), (7, 91), (3, 5, 200))
GRID_SHAPES = {2: ((1, 2), (2, 1)), 4: ((2, 2),), 8: ((4, 2), (2, 4))}
GRID_PROGRAMS = ("pagerank", "pagerank_weighted", "sssp", "bfs", "labelprop")
GRID_PPR_SEEDS = ((0,), (3, 7))
ONE_D_WORLDS = (2, 4)


@functools.lru_cache(maxsize=None)
def graphs(lib="repro_torch"):
    """The graphs of ``test_multidevice.py``'s cell 1 (``g``, ``gw``,
    ``gu``) and of its grid cells (``grid_*``), built from their seeds by
    ``lib``'s generators (the two packages' are equal)."""
    core = importlib.import_module(lib + ".core")
    random_weights, rmat, two_cliques = (core.random_weights, core.rmat,
                                         core.two_cliques)

    g = rmat(8, 2000, seed=3)
    gg = rmat(6, 300, seed=2)
    return {"g": g, "gw": random_weights(g, seed=5),
            "gu": two_cliques(40).to_undirected(),
            "grid_g": gg, "grid_gw": random_weights(gg, seed=5),
            "grid_gu": two_cliques(10).to_undirected()}


GRID_GRAPH = {"pagerank": "grid_g", "pagerank_weighted": "grid_gw",
              "sssp": "grid_gw", "bfs": "grid_g", "labelprop": "grid_gu"}


def cells(W: int) -> list[tuple]:
    """Every cell of world size ``W``, as a static tuple (its test id)."""
    out = []
    if W in ONE_D_WORLDS:
        out += [("pagerank", s) for s in STRATS]
        out += [("labelprop", s) for s in STRATS]
        out += [(kind, p) for p in PARTITIONERS
                for kind in ("sssp_part", "bfs_part", "labelprop_part")]
        out += [("hook", s, prog) for s in HOOK_STRATS
                for prog in ("pagerank", "sssp", "bfs")]
        out += [("batch_sssp", s) for s in ("reduction", "basic")]
        out += [("ppr", s) for s in STRATS]
        out += [("betweenness", s) for s in ("sortdest", "basic")]
    for R, C in GRID_SHAPES.get(W, ()):
        out += [("grid", R, C, prog, coll) for prog in GRID_PROGRAMS
                for coll in ("grouped", "full")]
    if W == 8:
        out.append(("grid_ppr", 2, 4))
    return out


def run_cell(cell, W, mesh=None, lib="repro_torch"):
    """One cell at W chares, on ``mesh`` or (None) on the one-device engine
    on the CPU; ``lib="repro"``: on the JAX reference's W-device mesh.
    -> ``(result, iters)``; a plane cell ``(plane, q_it)``; a PPR cell
    ``(plane, q_it, [(row, iters) of each query run alone])``."""
    core = importlib.import_module(lib + ".core")
    ops = importlib.import_module(lib + ".kernels.ops")
    Engine, partition, run_parallel = (core.Engine, core.partition,
                                       core.run_parallel)

    gr = graphs(lib)
    dev = ({} if lib == "repro" else {"device": "cpu"} if mesh is None
           else {"mesh": mesh})
    kind = cell[0]
    if kind == "pagerank":
        return run_parallel(gr["g"], "pagerank", W, strategy=cell[1], **dev)
    if kind == "labelprop":
        return run_parallel(gr["gu"], "labelprop", W, strategy=cell[1], **dev)
    if kind == "sssp_part":
        return run_parallel(gr["gw"], "sssp", W, strategy="sortdest",
                            partitioner=cell[1], source=7, **dev)
    if kind == "bfs_part":
        return run_parallel(gr["g"], "bfs", W, strategy="basic",
                            partitioner=cell[1], source=7, **dev)
    if kind == "labelprop_part":
        return run_parallel(gr["gu"], "labelprop", W, strategy="pairs",
                            partitioner=cell[1], **dev)
    if kind == "hook":
        _, strat, prog = cell
        graph = gr["gw"] if prog == "sssp" else gr["g"]
        params = {} if prog == "pagerank" else {"source": 7}
        return run_parallel(graph, prog, W, strategy=strat,
                            push_fn=ops.make_push_fn(), **params, **dev)
    if kind == "batch_sssp":
        eng = Engine(partition(gr["gw"], W, partitioner="edge_balanced"),
                     strategy=cell[1], **dev)
        return eng.run_batch("sssp", sources=list(BATCH_SRCS), batch=8)
    if kind == "ppr":
        eng = Engine(partition(gr["g"], W, partitioner="edge_balanced"),
                     strategy=cell[1], **dev)
        return _ppr(eng, PPR_SEEDS, batch=4)
    if kind == "betweenness":
        eng = Engine(partition(gr["g"], W), strategy=cell[1], **dev)
        return eng.run("betweenness", pivots=(0, 7, 91, 200))
    if kind == "grid":
        _, R, C, prog, coll = cell
        eng = Engine(partition(gr[GRID_GRAPH[prog]], W,
                               partitioner=f"grid({R},{C})"),
                     collectives=coll, **dev)
        return eng.run(prog, **({"source": 3} if prog in ("sssp", "bfs")
                                else {}))
    if kind == "grid_ppr":
        _, R, C = cell
        eng = Engine(partition(gr["grid_g"], W, partitioner=f"grid({R},{C})"),
                     **dev)
        return _ppr(eng, GRID_PPR_SEEDS, batch=None)
    raise ValueError(f"unknown cell {cell!r}")


def _host(x):
    """A cell's result as numpy arrays and ints."""
    if isinstance(x, (tuple, list)):
        return type(x)(_host(y) for y in x)
    return x if isinstance(x, int) else np.asarray(x)


def reference_main(out_path, world_cells):
    """Run each ``(W, cell)`` of ``world_cells`` through the JAX reference,
    on a W-device mesh, and pickle ``{(W, cell): result}`` to
    ``out_path``.  The process must have been started with
    ``XLA_FLAGS=--xla_force_host_platform_device_count`` of the largest W."""
    out = {(W, cell): _host(run_cell(cell, W, lib="repro"))
           for W, cell in world_cells}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _ppr(eng, seeds, batch):
    plane, q_it = eng.run_batch("personalized_pagerank", sources=list(seeds),
                                batch=batch, iters=6)
    alone = [eng.run("personalized_pagerank", seeds=s, iters=6)
             for s in seeds]
    return plane, q_it, alone


def _same_on_every_rank(mesh, results):
    """Raise unless every rank computed the same results."""
    import torch.distributed as dist

    digest = hashlib.sha256(pickle.dumps(results)).hexdigest()
    every = [None] * mesh.size
    dist.all_gather_object(every, digest)
    if len(set(every)) != 1:
        raise AssertionError(f"ranks disagree: {every}")


def world_cells(mesh):
    """Every cell of this world size, with the collectives each issued on
    this rank (``PeMesh.calls``), and the mesh refusals."""
    out, calls = {}, {}
    for cell in cells(mesh.size):
        mesh.reset_calls()
        out[cell] = run_cell(cell, mesh.size, mesh)
        calls[cell] = dict(mesh.calls)
    _same_on_every_rank(mesh, out)
    return {"cells": out, "calls": calls, "refusals": refusals(mesh)}


def refusals(mesh):
    """Each refusal of a mesh engine: -> {case: (exception type name,
    message, device uploads made, collectives issued)}; each must raise
    before any upload or collective."""
    from repro_torch.core import Engine, partition

    g = graphs()["g"]
    out = {}

    def attempt(name, make, pg):
        before = set(pg._dev)
        mesh.reset_calls()
        try:
            make()
        except ValueError as exc:
            out[name] = (type(exc).__name__, str(exc),
                         len(set(pg._dev) - before), sum(mesh.calls.values()))
        else:
            out[name] = ("no error", "", len(set(pg._dev) - before),
                         sum(mesh.calls.values()))

    wrong = partition(g, mesh.size + 1)
    attempt("chares_not_world", lambda: Engine(wrong, mesh=mesh), wrong)
    pg = partition(g, mesh.size)
    eng = Engine(pg, mesh=mesh)
    attempt("stream_run", lambda: eng.run("bfs", residency="stream"), pg)
    return out


# -- the collectives against the axis-0 ops they replace ---------------------


def collective_inputs(W: int, seed: int = 0) -> dict:
    """Seeded ``[W, W*K(, B)]`` planes, every chare's row, the same on every
    rank: f32 and i32, one column and a trailing ``[B=3]``, a tenth of the
    entries the min's identity (inf, the int32 sentinel) -- zero in the
    planes the sums take -- and ``[W, 4]`` bool flags."""
    rng = np.random.default_rng(seed)
    K = 5
    out = {}
    for tail in ((), (3,)):
        shape = (W, W * K) + tail
        special = rng.random(shape) < 0.1
        f = rng.standard_normal(shape).astype(np.float32)
        i = rng.integers(-1000, 1000, shape).astype(np.int32)
        for name, plane, ident in (("f32", f, np.inf),
                                   ("i32", i, 2**31 - 1)):
            out[(name, "min") + tail] = np.where(special, ident, plane)
            out[(name, "add") + tail] = np.where(special, 0, plane)
    out["flags"] = rng.random((W, 4)) < 0.3
    return out


def grid_shapes_of(W):
    return [(R, W // R) for R in range(1, W + 1) if W % R == 0]


def collective_results(W, x, coll):
    """Every collective of the interface, through ``coll``, on this
    process's rows of each plane of ``x`` (``collective_inputs``), the
    results gathered: -> {case: tensor}, every chare's result."""
    out = {}
    for name, plane in x.items():
        if name == "flags":
            continue
        t = coll.own(torch.from_numpy(plane))
        K = plane.shape[1] // W
        tail = tuple(plane.shape[2:])
        combine = name[1]
        out[(name, "preduce")] = coll.preduce(t.clone(), combine)
        blocks = t.reshape((t.shape[0], W, K) + tail)
        out[(name, "reduce_scatter")] = coll.gather_rows(
            coll.reduce_scatter(blocks.clone(), combine))
        for R, C in grid_shapes_of(W):
            for axis in (0, 1):
                red, slot = coll.grid_reduce(t.clone(), R, C, axis, combine)
                out[(name, "grid", R, C, axis)] = coll.gather_rows(
                    red.index_select(0, slot))
        out[(name, "all_to_all")] = coll.gather_rows(
            coll.all_to_all(blocks.clone()).contiguous())
        out[(name, "ring")] = coll.gather_rows(coll.ppermute_ring(t.clone()))
    out["ids"] = coll.gather_rows(coll.chare_ids(W, "cpu"))
    flags = coll.own(torch.from_numpy(x["flags"]))
    out["vote"] = coll.vote(flags.any(dim=0))
    out["any_changed"] = torch.tensor(
        [coll.any_changed(flags[:, c]) for c in range(flags.shape[1])])
    # this process's chares' counts, summed over every chare
    out["sum_counts"] = torch.tensor(coll.sum_counts(
        flags.sum(dim=0).tolist()))
    first = int(coll.chare_ids(W, "cpu")[0])  # chare 0 where rank 0 is
    out["broadcast"] = torch.tensor(coll.broadcast([first, W]))
    return out


def collective_cases(mesh):
    """``collective_results`` through the mesh's real collectives."""
    out = {k: v.numpy() for k, v in collective_results(
        mesh.size, collective_inputs(mesh.size), mesh).items()}
    out["groups"] = sorted(mesh.groups)
    _same_on_every_rank(mesh, out)
    return out


def fail_on_rank_one(mesh):
    """Rank 1 raises; rank 0 returns."""
    if mesh.rank == 1:
        raise ValueError("rank 1 refuses")
    return mesh.rank


def sleep(mesh, seconds):
    """Every rank outlives a short join limit."""
    time.sleep(seconds)
