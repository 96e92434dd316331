"""The adaptive modes and the graph server across processes, on gloo ranks.

``Engine(pg, mesh=m)`` under ``replan=``, ``sync="overlap"``,
``gate="frontier"`` and ``residency="stream"``, and ``GraphQueryServer``
over a mesh engine: ``tests/test_multidevice.py``'s cell 1d (with its
``REPRO_SYNC=overlap`` leg), ``GRID_SCRIPT``'s 1-D <-> 2-D replans,
``ASYNC_SCRIPT``'s 20 overlap-plus-gate cells, lowerings, gate record and
batched overlap plane, and ``STREAM_SCRIPT``'s streamed cells, at the
reference's sizes and world sizes; a cold start of four ranks on one empty
layout cache; and a served load of bfs and personalized PageRank.  One
spawn per world size runs all of that size's cells
(``torch_mesh_mode_cases.world_cells``).  Each cell is held

  * to the serial references with the reference's bars: min programs bit
    for bit (barrier supersteps equal to serial's, overlap's within the
    double-check bound ``[it, 2 it + 2]``), PageRank under a replan
    < 1e-3 (< 1e-6 across a grid replan);
  * to the port's one-device engine at the same chare count: min programs
    bit for bit with equal supersteps (overlap's double-check counts
    included), the gate record and the streamed record equal (``fetches``
    aside: a rank fetches on its own schedule), adds within 1e-6, the
    server's dispatch groups, holds, deadline flags and rows equal;
  * a subset (the replans, cell 1d's at W=8, the 20 async cells, the
    grid(2,4) streamed cells and the server's admissions) to the JAX
    reference's engine at the same chare count, its chares ``shard_map``
    shards over W forced host devices, in one subprocess beside the
    spawns;

and the reference's bars on the mesh: the grouped/full wire-byte ratio
``PeMesh.bytes`` measures at grid(2,4)@8 is <= 0.6, the gate record adds
up and skips >= 40% of launches, the streamed slot accounting, and a warm
restart reads the layout cache off disk.
"""

import functools
import os
import pickle
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

import torch_mesh_mode_cases as cases
from repro_torch.core import Engine, partition
from repro_torch.core import mesh as M
from repro_torch.core import programs as P
from repro_torch.core.pagerank import pagerank_serial
from torch_mesh_cases import BATCH_SRCS, graphs

WORLDS = (2, 4, 8)
CELLS = [(W, cell) for W in WORLDS for cell in cases.cells(W)]
MIN_KINDS = ("replan_sssp", "replan_bfs", "replan_skew", "replan_batch",
             "replan_grid", "async", "lowering", "gate_record",
             "async_batch", "stream", "stream_batch", "stream_warm",
             "cache_cold")


def _for_reference(W, cell):
    """The replans (cell 1d's at W=8: its W=2 cells run the same code on
    fewer ranks), the 20 async cells, the grid(2,4) streamed cells and
    the server's admissions."""
    kind = cell[0]
    if kind in ("replan_sssp", "replan_bfs"):
        return W == 8
    return (kind.startswith("replan") or kind in ("async", "serve")
            or (W == 8 and kind in ("stream", "stream_batch")))


REFERENCE_CELLS = [(W, c) for W, c in CELLS if _for_reference(W, c)]


def _id(cell):
    return "-".join(str(p) for p in cell)


@functools.lru_cache(maxsize=None)
def _world(W):
    _reference_process()  # the reference runs beside the spawns
    cache = cases.cache_dir_for(W)
    try:
        return M.spawn(cases.world_cells, W, cache, device="cpu")
    finally:
        shutil.rmtree(cache, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _reference_process():
    """Start the JAX reference on ``REFERENCE_CELLS`` in one subprocess
    with max(WORLDS) forced host devices.  -> (process, temp dir)."""
    tmp = tempfile.TemporaryDirectory(prefix="mesh_modes_ref_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={max(WORLDS)}"))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here])
    script = (f"import torch_mesh_mode_cases as c; c.reference_main("
              f"{os.path.join(tmp.name, 'ref.pkl')!r}, {REFERENCE_CELLS!r})")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return proc, tmp


@functools.lru_cache(maxsize=None)
def _reference():
    proc, tmp = _reference_process()
    try:
        _, err = proc.communicate(timeout=600)
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


def _assert_same(got, want, exact, where):
    """Equal structure; arrays bit for bit where ``exact`` or not float,
    else within 1e-6; records and strings equal."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for g, w in zip(got, want):
            _assert_same(g, w, exact, where)
    elif isinstance(want, (dict, str)) or want is None:
        assert got == want, where
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, where
        if exact or w.dtype.kind != "f":
            assert g.dtype == w.dtype and np.array_equal(g, w), where
        else:
            assert float(np.max(np.abs(g.astype(np.float64) - w),
                                initial=0.0)) <= 1e-6, where


def _without_fetches(x):
    """A streamed cell's result with its record's ``fetches`` dropped."""
    return tuple({k: v for k, v in y.items() if k != "fetches"}
                 if isinstance(y, dict) else y for y in x)


@pytest.mark.parametrize("W,cell", CELLS, ids=[_id(c) for c in CELLS])
def test_cell_against_one_device(W, cell):
    got = _world(W)["cells"][cell]
    want = _one_device(W, cell)
    kind = cell[0]
    exact = kind in MIN_KINDS
    if kind in ("stream", "stream_batch"):
        got, want = _without_fetches(got), _without_fetches(want)
    if kind == "lowering":  # the wire bytes are the mesh's alone
        got, want = got[:-1], want[:-1]
    if kind == "stream_warm":  # the one-device run had no cache
        got, want = got[:2] + got[3:], want[:2] + want[3:]
    if kind == "cache_cold":  # origins are the mesh's alone
        got, want = got[1:5] + got[6:], want[1:5] + want[6:]
    if kind == "serve":
        steps, drained, dispatches, rows, stats = got
        assert (steps, drained, dispatches, stats) == want[:3] + want[4:]
        for (row, it), (wrow, wit), st in zip(rows, want[3], stats):
            assert it == wit
            _assert_same(row, wrow, st[0] == "bfs", cell)
        return
    _assert_same(got, want, exact, cell)


@functools.lru_cache(maxsize=None)
def _serial(key, program, source=None):
    graph = (cases.stream_graph() if key == "stream" else graphs()[key])
    if program == "pagerank":
        return pagerank_serial(graph), None
    return P.get_spec(program).serial(graph, source=source)


def _exact(result, iters, key, program, source, sync="barrier"):
    ref, ref_it = _serial(key, program, source)
    assert np.array_equal(result, ref)
    if sync == "barrier":
        assert iters == ref_it
    else:
        assert ref_it <= iters <= 2 * ref_it + 2


SERIAL_CELLS = [(W, c) for W, c in CELLS if c[0] != "serve"]


@pytest.mark.parametrize("W,cell", SERIAL_CELLS,
                         ids=[_id(c) for c in SERIAL_CELLS])
def test_cell_against_serial(W, cell):
    got = _world(W)["cells"][cell]
    kind = cell[0]
    if kind == "replan_sssp":
        _exact(*got, "gw", "sssp", 7, cell[2])
    elif kind == "replan_bfs":
        _exact(*got, "g", "bfs", 7, cell[1])
    elif kind == "replan_pagerank":
        assert float(np.max(np.abs(got[0] - _serial("g", "pagerank")[0]))) \
            < 1e-3
    elif kind == "replan_skew":
        _exact(got[0], got[1], "gw", "sssp", 7)
        assert got[2] == "edge_balanced"  # the trigger fired and switched
    elif kind == "replan_batch":
        plane, q_it = got
        for i, s in enumerate(BATCH_SRCS):
            _exact(plane[i], q_it[i], "gw", "sssp", s)
    elif kind == "replan_grid":
        _exact(*got, "grid_gw", "sssp", 3)
    elif kind == "replan_grid_pagerank":
        assert float(np.max(np.abs(
            got[0] - _serial("grid_g", "pagerank")[0]))) < 1e-6
    elif kind == "async":
        key = "grid_gw" if cell[3] == "sssp" else "grid_g"
        _exact(got[0], got[1], key, cell[3], 3)
        _exact(got[2], got[3], key, cell[3], 3, "overlap")
    elif kind == "lowering":
        _exact(got[0], got[1], "grid_gw", "sssp", 3)
        _exact(got[2], got[3], "grid_gw", "sssp", 3, "overlap")
    elif kind == "gate_record":
        _exact(got[0], got[1], "grid_gw", "sssp", 3, "overlap")
    elif kind == "async_batch":
        plane, q_it = got
        for i, s in enumerate(cases.ASYNC_SRCS):
            _exact(plane[i], q_it[i], "grid_gw", "sssp", s, "overlap")
    elif kind == "stream":
        _exact(got[0], got[1], "stream", cell[2], 7)
        _assert_same(got[3:], got[:2], True, cell)  # == the resident run
    elif kind == "stream_batch":
        plane, q_it = got[:2]
        for i, s in enumerate(cases.STREAM_SRCS):
            _exact(plane[i], q_it[i], "stream", cell[2], s)
        _assert_same(got[3:], got[:2], True, cell)
    elif kind == "stream_warm":
        _exact(got[0], got[1], "stream", "sssp", 7)
        _assert_same(got[3:], got[:2], True, cell)
    else:  # cache_cold
        for i in (1, 3, 6):
            _exact(got[i], got[i + 1], "stream", "sssp", 7)


@pytest.mark.parametrize("W,cell", REFERENCE_CELLS,
                         ids=[_id(c) for c in REFERENCE_CELLS])
def test_cell_against_reference(W, cell):
    """The mesh against the reference's ``shard_map`` engine at the same
    chare count: min programs bit for bit with equal supersteps, PageRank
    within 1e-6; a streamed cell's results and its record's slot and byte
    counts; the server's dispatch groups, holds and deadline flags."""
    got = _world(W)["cells"][cell]
    want = _reference()[(W, cell)]
    kind = cell[0]
    if kind == "serve":
        assert got[:3] == tuple(want[:3])
        assert [s[3] for s in got[4]] == [s[3] for s in want[4]]
        for (row, it), (wrow, wit), st in zip(got[3], want[3], got[4]):
            assert it == wit
            _assert_same(row, wrow, st[0] == "bfs", cell)
        return
    if kind in ("stream", "stream_batch"):
        rec, wrec = got[2], want[2]
        for k in ("windows", "supersteps", "fetch_slots", "fetch_skipped"):
            assert rec[k] == wrec[k], k
        got, want = got[:2] + got[3:], want[:2] + want[3:]
    _assert_same(got, want, kind in MIN_KINDS, cell)


# -- the reference's bars on the mesh ----------------------------------------


def test_grouped_wire_bytes_at_most_six_tenths_of_full():
    """``ASYNC_SCRIPT``'s measured collective bytes, from the calls the
    ranks made (``PeMesh.bytes``) over one barrier sssp run of each
    lowering at grid(2,4)@8: equal supersteps, and phase 2's grouped
    reduces move at most 0.6 of the full-axis reduce's bytes."""
    cells = _world(8)["cells"]
    grouped = cells[("lowering", "grid(2,4)", "grouped")]
    full = cells[("lowering", "grid(2,4)", "full")]
    assert grouped[1] == full[1]
    ratio = grouped[-1]["group_reduce"] / full[-1]["all_reduce"]
    assert ratio <= 0.6


def test_gate_record_at_grid_2x4():
    got = _world(8)["cells"][("gate_record",)]
    gate = got[2]
    assert gate["enabled"] and gate["sync"] == "overlap"
    assert gate["launched"] + gate["skipped_launches"] == \
        gate["launch_slots"]
    assert gate["skipped_fraction"] >= 0.4
    assert gate == _one_device(8, ("gate_record",))[2]
    assert _world(8)["calls"][("gate_record",)]["sum_counts"] == 1


STREAM_CELLS = [(W, c) for W, c in CELLS if c[0] in ("stream",
                                                      "stream_batch")]


@pytest.mark.parametrize("W,cell", STREAM_CELLS,
                         ids=[_id(c) for c in STREAM_CELLS])
def test_stream_accounting(W, cell):
    """``STREAM_SCRIPT``'s bars: rectangle-granular slots, window-granular
    fetches, B-fold bytes per query; and one ``sum_counts`` per run."""
    result, it, st = _world(W)["cells"][cell][:3]
    pes = W
    assert st["fetch_slots"] == pes * st["windows"] * st["supersteps"]
    assert st["fetches"] <= st["windows"] * st["supersteps"]
    assert st["fetch_skipped"] <= st["fetch_slots"]
    assert st["supersteps"] == int(np.max(it))
    if cell[0] == "stream_batch":
        assert st["batch"] == 8
        assert st["fetched_bytes_per_query"] == st["fetched_bytes"] / 8
    elif cell[3] == "frontier" and W == 8:
        assert st["fetch_skipped"] > 0  # a multi-rect grid gates fetches
    assert st["fetches"] <= _one_device(W, cell)[2]["fetches"]
    assert _world(W)["calls"][cell]["sum_counts"] == 1


def test_warm_restart_reads_the_cache_the_ranks_wrote():
    assert _world(2)["cells"][("stream_warm",)][2] == "disk"


def test_cold_start_of_four_ranks_on_one_cache():
    """Four ranks cold-start on one empty ``cache_dir``: rank 0 builds and
    persists the entry, the others open it off disk; all run bit-equal to
    the resident engine, and a restart reads the entry off disk."""
    got = _world(4)["cells"][("cache_cold",)]
    assert got[0] == ("memory", "disk", "disk", "disk")
    assert got[5] == "disk"
    _assert_same(got[1:3], got[3:5], True, "cold")
    _assert_same(got[6:], got[3:5], True, "warm")


def test_layout_cache_second_writer_keeps_the_published_entry(tmp_path):
    """A writer that finds the entry published meanwhile keeps it and
    leaves no staging behind; an entry of another fingerprint (a torn or
    stale one at the same path) is replaced."""
    from repro_torch.checkpoint import store

    d = str(tmp_path)
    fp = "a" * 64
    first = {"x": np.arange(4, dtype=np.int32)}
    path = store.save_layout_cache(d, fp, first)
    mtime = os.stat(os.path.join(path, "x.npy")).st_mtime_ns
    assert store.save_layout_cache(d, fp, {"x": np.zeros(4, np.int32)}) \
        == path
    assert os.stat(os.path.join(path, "x.npy")).st_mtime_ns == mtime
    assert os.listdir(d) == [os.path.basename(path)]
    np.testing.assert_array_equal(store.open_layout_cache(d, fp)["x"],
                                  first["x"])
    other = "a" * 16 + "b" * 48  # the same entry path, another fingerprint
    store.save_layout_cache(d, other, {"x": np.ones(4, np.int32)})
    assert os.listdir(d) == [os.path.basename(path)]
    np.testing.assert_array_equal(store.open_layout_cache(d, other)["x"],
                                  np.ones(4, np.int32))


# -- one rank in this process: bit for bit with mesh=None --------------------


@pytest.fixture(scope="module")
def one_rank():
    with tempfile.TemporaryDirectory() as d, M.pe_group(0, 1, d, "cpu"):
        yield M.make_pe_mesh(1, device="cpu")


ONE_RANK = (("sssp", "contiguous", {}, cases.OVERLAP),
            ("bfs", "contiguous", {"strategy": "basic"}, cases.OVERLAP),
            ("sssp", "grid(1,1)", {}, cases.OVERLAP),
            ("sssp", "contiguous", {}, {"replan": "degree_sorted"}),
            ("pagerank", "contiguous", {}, {"replan": "grid(1,1)"}),
            ("bfs", "contiguous", {},
             {"replan": "edge_balanced", **cases.OVERLAP}),
            ("sssp", "grid(1,1)", {"residency": "stream"}, {}),
            ("pagerank", "grid(1,1)", {"residency": "stream"}, {}),
            ("bfs", "grid(1,1)", {"residency": "stream"},
             {"gate": "frontier"}),
            ("sssp", "grid(1,1)", {"residency": "stream"}, {"batch": 8}),
            ("bfs", "contiguous", {}, {"batch": 8, **cases.OVERLAP}))


@pytest.mark.parametrize("case", ONE_RANK, ids=[
    "-".join([c[0], c[1]] + sorted(c[2]) + sorted(c[3])) for c in ONE_RANK])
def test_one_rank_mesh_modes_are_bit_equal(one_rank, case):
    """One gloo rank in this process runs each mode bit for bit as the
    engine with ``mesh=None`` does, adds included, with equal supersteps
    and equal gate and stream records."""
    from repro_torch.core import ReplanPolicy, StreamConfig

    name, partitioner, ekw, rkw = case
    rkw = dict(rkw)
    if "replan" in rkw:
        rkw["replan"] = ReplanPolicy(rkw["replan"], every=2, mode="always")
    batch = rkw.pop("batch", None)
    if ekw.get("residency") == "stream":
        ekw = dict(ekw, stream=StreamConfig(windows=3))
    graph = graphs()["gw"]

    def run(dev):
        eng = Engine(partition(graph, 1, partitioner=partitioner), **ekw,
                     **dev)
        out = (eng.run_batch(name, sources=list(BATCH_SRCS), batch=batch,
                             **rkw) if batch else eng.run(name, **rkw))
        st = eng.dispatch.get("stream", {})
        return out + (eng.dispatch["gate"],
                      {k: st[k] for k in cases.STREAM_KEYS if k in st})

    _assert_same(run({"mesh": one_rank}), run({"device": "cpu"}), True,
                 case)
