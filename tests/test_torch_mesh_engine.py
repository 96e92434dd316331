"""The graph engine across processes: ``Engine(pg, mesh=m)`` on gloo ranks.

``tests/test_multidevice.py``'s graph cells 1, 1b, 1c, 1e and 1f at W = 2
and 4 ranks, and ``GRID_SCRIPT``'s 25 grid cells and its grid PPR plane at
the W (2, 4, 8) each grid shape needs, run by the port with one chare per
rank: one spawn per world size runs all of that size's cells
(``torch_mesh_cases.world_cells``).  Each cell is held

  * to the serial references with the reference's own bars: min programs
    bit for bit with the serial superstep counts, label propagation's
    components, PageRank < 1e-3 (grid PageRank < 1e-6), PPR planes within
    1e-6 of each query run alone;
  * to the port's one-device engine at the same chare count: min programs
    and pairs' add bit for bit with equal supersteps, the other adds (the
    collectives sum in their own order) within 1e-6;
  * a subset of the cells (``REFERENCE_CELLS``) to the JAX reference's
    engine at the same chare count, its chares ``shard_map`` shards over W
    forced host devices (one subprocess, started beside the first spawn):
    min programs bit for bit with equal supersteps, every float within
    1e-6;

and the collectives each rank issued are counted against what each phase 2
and the quiescence vote must issue per superstep.  The refusals (C != W, a
streamed run on a resident engine) raise before any upload or collective;
the adaptive modes and streaming run on a mesh in
``tests/test_torch_mesh_modes.py``.  A
one-rank gloo mesh in this process must equal ``mesh=None`` bit for bit in
every program, adds included, as one NCCL rank must on the card.
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import torch_mesh_cases as cases
from repro_torch.core import Engine, mesh as M, partition
from repro_torch.core import programs as P
from repro_torch.core.labelprop import components_oracle

WORLDS = (2, 4, 8)
CELLS = [(W, cell) for W in WORLDS for cell in cases.cells(W)]
MIN_PROGRAMS = ("labelprop", "sssp", "bfs", "betweenness")


def _for_reference(cell):
    """The cells held to the JAX reference: every 1-D strategy's add and
    min collectives (pagerank, labelprop), the un-permute of rank rows
    under permuting partitioners, the batched planes (sssp, PPR on a
    scatter and on the ring, betweenness), the fused-push hook once, and
    every grid shape under both lowerings with an add and a min program
    and the grid PPR plane -- about half the cells, at half the time."""
    kind = cell[0]
    if kind == "sssp_part":
        return cell[1] in ("striped", "degree_sorted")
    if kind in ("bfs_part", "labelprop_part"):
        return cell[1] == "edge_balanced"
    if kind == "ppr":
        return cell[1] in ("sortdest", "pairs")
    if kind == "hook":
        return cell[1:] == ("pairs", "sssp")
    if kind == "grid":
        return cell[3] in ("pagerank", "sssp")
    return True


REFERENCE_CELLS = [(W, c) for W, c in CELLS if _for_reference(c)]


def _id(param):
    return "-".join(str(p) for p in param) if isinstance(param, tuple) \
        else str(param)


@functools.lru_cache(maxsize=None)
def _world(W):
    _reference_process()  # the reference runs beside the spawns
    return M.spawn(cases.world_cells, W, device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_process():
    """Start the JAX reference on ``REFERENCE_CELLS`` in one subprocess
    with max(WORLDS) forced host devices (``XLA_FLAGS`` stays out of this
    process).  -> (process, its temporary directory)."""
    tmp = tempfile.TemporaryDirectory(prefix="mesh_ref_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={max(WORLDS)}"))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here])
    script = (f"import torch_mesh_cases as c; c.reference_main("
              f"{os.path.join(tmp.name, 'ref.pkl')!r}, {REFERENCE_CELLS!r})")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return proc, tmp


@functools.lru_cache(maxsize=None)
def _reference():
    """{(W, cell): result} of the JAX reference."""
    proc, tmp = _reference_process()
    try:
        _, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err.decode()[-3000:]
    with open(os.path.join(tmp.name, "ref.pkl"), "rb") as f:
        return pickle.load(f)


@functools.lru_cache(maxsize=None)
def _one_device(W, cell):
    return cases.run_cell(cell, W)


def _program(cell):
    kind = cell[0]
    if kind in ("pagerank", "labelprop", "betweenness"):
        return kind
    if kind in ("sssp_part", "bfs_part", "labelprop_part"):
        return kind[:-5]
    if kind == "hook":
        return cell[2]
    if kind == "batch_sssp":
        return "sssp"
    if kind == "grid":
        return cell[3]
    return "personalized_pagerank"


def _strategy(cell):
    kind = cell[0]
    if kind in ("pagerank", "labelprop", "batch_sssp", "ppr", "betweenness",
                "hook"):
        return cell[1]
    return {"sssp_part": "sortdest", "bfs_part": "basic",
            "labelprop_part": "pairs"}.get(kind, "grid2d")


def _arrays(x):
    """Every array and count of a cell's result, flat."""
    if isinstance(x, (tuple, list)):
        return [a for y in x for a in _arrays(y)]
    return [np.asarray(x)]


@pytest.mark.parametrize("W,cell", CELLS, ids=[_id(c) for c in CELLS])
def test_cell_against_one_device(W, cell):
    got = _world(W)["cells"][cell]
    want = _one_device(W, cell)
    exact = (_program(cell) in MIN_PROGRAMS
             or _strategy(cell) == "pairs" or cell[0] == "betweenness")
    for g, w in zip(_arrays(got), _arrays(want), strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, cell
        if exact or g.dtype.kind != "f":
            assert np.array_equal(g, w), cell
        else:
            assert float(np.max(np.abs(g.astype(np.float64) - w))) <= 1e-6


@pytest.mark.parametrize("W,cell", REFERENCE_CELLS,
                         ids=[_id(c) for c in REFERENCE_CELLS])
def test_cell_against_reference(W, cell):
    """The mesh across ranks against the reference's ``shard_map`` engine
    at the same chare count: the new parts are the collectives' add order
    and the gather and un-permute of the rank rows."""
    got = _world(W)["cells"][cell]
    want = _reference()[(W, cell)]
    exact = _program(cell) in MIN_PROGRAMS
    for g, w in zip(_arrays(got), _arrays(want), strict=True):
        assert g.shape == w.shape, cell
        if exact or g.dtype.kind != "f":
            assert g.dtype == w.dtype and np.array_equal(g, w), cell
        else:
            assert float(np.max(np.abs(g.astype(np.float64) - w))) <= 1e-6


@functools.lru_cache(maxsize=None)
def _serial(graph_key, program, source=None):
    graph = cases.graphs()[graph_key]
    if program == "labelprop":
        return components_oracle(graph), None
    spec = P.get_spec(program)
    params = {} if source is None else {"source": source}
    out = spec.serial(graph, **params)
    return out if spec.returns_iters else (out, None)


def _hold_to_serial(got, graph_key, program, source=None, pagerank_bar=1e-3):
    result, iters = got
    ref, ref_iters = _serial(graph_key, program, source)
    if program in ("pagerank", "pagerank_weighted"):
        assert float(np.max(np.abs(result - ref))) < pagerank_bar
    else:
        assert np.array_equal(result, ref)
        if ref_iters is not None:
            assert iters == ref_iters


def _hold_ppr(got, seeds):
    plane, q_it, alone = got
    assert np.all(q_it == 6)
    for i, (row, it) in enumerate(alone):
        assert it == 6
        assert float(np.max(np.abs(plane[i] - row))) <= 1e-6


SERIAL_CELLS = [(W, c) for W, c in CELLS if c[0] != "betweenness"]


@pytest.mark.parametrize("W,cell", SERIAL_CELLS,
                         ids=[_id(c) for c in SERIAL_CELLS])
def test_cell_against_serial(W, cell):
    got = _world(W)["cells"][cell]
    kind = cell[0]
    if kind == "pagerank":
        _hold_to_serial(got, "g", "pagerank")
    elif kind in ("labelprop", "labelprop_part"):
        _hold_to_serial(got, "gu", "labelprop")
    elif kind == "sssp_part":
        _hold_to_serial(got, "gw", "sssp", 7)
    elif kind == "bfs_part":
        _hold_to_serial(got, "g", "bfs", 7)
    elif kind == "hook":
        prog = cell[2]
        _hold_to_serial(got, "gw" if prog == "sssp" else "g", prog,
                        None if prog == "pagerank" else 7)
    elif kind == "batch_sssp":
        plane, q_it = got
        for i, s in enumerate(cases.BATCH_SRCS):
            _hold_to_serial((plane[i], q_it[i]), "gw", "sssp", s)
    elif kind == "ppr":
        _hold_ppr(got, cases.PPR_SEEDS)
    elif kind == "grid":
        prog = cell[3]
        _hold_to_serial(got, cases.GRID_GRAPH[prog], prog,
                        3 if prog in ("sssp", "bfs") else None,
                        pagerank_bar=1e-6)
    else:
        _hold_ppr(got, cases.GRID_PPR_SEEDS)


def _per_superstep(W, cell, combine):
    """The phase-2 collectives one superstep of the cell's strategy issues
    on a rank: {kind: count}."""
    strategy = _strategy(cell)
    if strategy == "reduction":
        return {"all_reduce": 1}
    if strategy == "sortdest":
        return {"reduce_scatter" if combine == "add" else "all_to_all": 1}
    if strategy == "basic":
        return {"all_to_all": 1}
    if strategy == "pairs":
        return {"ring_hop": W - 1}
    R, C = cell[1], cell[2]
    if cell[4] == "full":
        return {"all_reduce": 1}
    return {"group_reduce": (R > 1) + (C > 1)}


COUNTED = [(W, c) for W, c in CELLS
           if c[0] not in ("ppr", "grid_ppr", "betweenness")]


@pytest.mark.parametrize("W,cell", COUNTED, ids=[_id(c) for c in COUNTED])
def test_collectives_per_superstep(W, cell):
    """Every superstep issues its strategy's phase-2 collectives and, for a
    convergence program, one vote (a plane's also one before its first
    superstep); the result is gathered once."""
    world = _world(W)
    got, calls = world["cells"][cell], world["calls"][cell]
    program = P.make_program(_program(cell))
    batched = cell[0] == "batch_sssp"
    steps = int(np.max(got[1]))
    want = {k: n * steps for k, n in _per_superstep(
        W, cell, program.combiner.name).items()}
    if program.fixed_iters is None:
        want["vote"] = steps + batched
    want["all_gather"] = 1
    assert calls == want


REFUSALS = ("chares_not_world", "stream_run")


@pytest.mark.parametrize("name", REFUSALS)
def test_refusal_before_any_work(name):
    kind, message, uploads, calls = _world(2)["refusals"][name]
    if name == "chares_not_world":
        assert kind == "ValueError" and "mesh size" in message
    else:  # a resident engine refuses a streamed run
        assert kind == "ValueError" and "bound resident" in message
    assert uploads == 0 and calls == 0


# -- one rank in this process: bit for bit with mesh=None --------------------


@pytest.fixture(scope="module")
def one_rank():
    with tempfile.TemporaryDirectory() as d, M.pe_group(0, 1, d, "cpu"):
        yield M.make_pe_mesh(1, device="cpu")


ONE_RANK = [(s, "auto", "auto") for s in cases.STRATS] + [
    ("sortdest", None, "auto"), ("grid", "auto", "grouped"),
    ("grid", "auto", "full")]
RUNS = ("pagerank", "pagerank_weighted", "sssp", "bfs", "labelprop",
        "bfs_batch", "ppr_batch")


def _one_rank_run(strategy, push_fn, collectives, run, mesh):
    gr = cases.graphs()
    graph = gr["gu"] if run == "labelprop" else gr["gw"]
    pg = partition(graph, 1, partitioner="grid(1,1)" if strategy == "grid"
                   else "contiguous")
    dev = {"device": "cpu"} if mesh is None else {"mesh": mesh}
    eng = Engine(pg, strategy="sortdest" if strategy == "grid" else strategy,
                 push_fn=push_fn, collectives=collectives, **dev)
    if run == "bfs_batch":
        return eng.run_batch("bfs", sources=list(cases.BATCH_SRCS), batch=8)
    if run == "ppr_batch":
        return eng.run_batch("personalized_pagerank",
                             sources=list(cases.PPR_SEEDS), iters=6)
    return eng.run(run)


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("strategy,push_fn,collectives", ONE_RANK,
                         ids=["-".join(map(str, c)) for c in ONE_RANK])
def test_one_rank_mesh_is_bit_equal(one_rank, strategy, push_fn,
                                    collectives, run):
    one_rank.reset_calls()
    got = _one_rank_run(strategy, push_fn, collectives, run, one_rank)
    assert one_rank.calls["all_gather"] == 1
    want = _one_rank_run(strategy, push_fn, collectives, run, None)
    for g, w in zip(_arrays(got), _arrays(want), strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
