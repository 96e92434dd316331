"""The PE mesh's collectives and its construction (``repro_torch.core.mesh``).

Each process-group collective runs at W = 2 and 4 gloo ranks (one spawn
per world size, ``torch_mesh_cases.collective_cases``) on seeded numpy
planes, against the axis-0 op it replaces on one device (``AXIS0``):
min, int sums, ``all_to_all``, the ring, the ids, the votes, the count
sums and the broadcast bit for bit; float sums within f32 rounding,
``(W-1) * eps * sum |x|``.  Then the refusals of ``make_pe_mesh`` and
``spawn``, which never fall back to gloo or to the CPU, and ``spawn``'s
error and timeout paths.  Nothing of the JAX reference runs here.
"""

import functools
import tempfile
import time

import numpy as np
import pytest
import torch

import torch_mesh_cases as cases
from repro_torch.core import mesh as M

WORLDS = (2, 4)
KINDS = ("preduce", "reduce_scatter", "grid", "all_to_all", "ring", "ids",
         "vote", "any_changed", "sum_counts", "broadcast")


@functools.lru_cache(maxsize=None)
def _spawned(W):
    return M.spawn(cases.collective_cases, W, device="cpu")


def _kind(key):
    if isinstance(key, str):
        return key
    return key[1]


def _one_device(W, planes):
    return {k: v.numpy() for k, v in cases.collective_results(
        W, planes, M.AXIS0).items()}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("W", WORLDS)
def test_collective_matches_axis_zero(W, kind):
    got = _spawned(W)
    planes = cases.collective_inputs(W)
    want = _one_device(W, planes)
    # |x| through the same sums: the f32 rounding bound of each output
    scale = _one_device(W, {k: np.abs(v) if k != "flags" else v
                            for k, v in planes.items()})
    keys = [k for k in want if _kind(k) == kind]
    assert keys
    for key in keys:
        g, w = got[key], want[key]
        assert g.shape == w.shape and g.dtype == w.dtype, key
        if w.dtype == np.float32 and key[0][1] == "add" and kind in (
                "preduce", "reduce_scatter", "grid"):
            bound = (W - 1) * np.finfo(np.float32).eps * scale[key]
            assert np.all(np.abs(g.astype(np.float64) - w) <= bound), key
        else:
            assert np.array_equal(g, w), key


@pytest.mark.parametrize("W", WORLDS)
def test_every_grid_subgroup_is_made_once(W):
    """Every rank creates the subgroups of every grid(R, C) of W, the
    world-sized and one-rank groups aside."""
    want = set()
    for R, C in cases.grid_shapes_of(W):
        for axis in M.grid_groups(R, C):
            want |= {tuple(g) for g in axis if 1 < len(g) < W}
    assert set(_spawned(W)["groups"]) == want


def test_grid_groups_partition_the_chares():
    cols, rows = M.grid_groups(2, 4)
    assert cols == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert rows == [[0, 1, 2, 3], [4, 5, 6, 7]]


@pytest.fixture
def one_rank_group():
    """This process as the one rank of a gloo group, left on exit."""
    with tempfile.TemporaryDirectory() as d, M.pe_group(0, 1, d, "cpu"):
        yield


def test_one_rank_mesh(one_rank_group):
    mesh = M.make_pe_mesh(1, device="cpu")
    assert (mesh.size, mesh.rank, mesh.rows) == (1, 0, (0, 1))
    assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    assert mesh.groups == {}


def test_mesh_spans_the_whole_group(one_rank_group):
    with pytest.raises(ValueError, match="spans the whole group"):
        M.make_pe_mesh(2, device="cpu")


def test_make_pe_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="needs a process group"):
        M.make_pe_mesh(1, device="cpu")


def test_no_card_is_never_the_cpu():
    """Without CUDA the default device raises; nothing runs on the CPU in
    its place."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal needs none")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_pe_mesh(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.spawn(cases.collective_cases, 1)


@pytest.fixture
def one_card(monkeypatch):
    """A stubbed host with one visible card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_cuda_mesh_wider_than_the_cards(one_card, monkeypatch):
    """A CUDA mesh of more ranks than cards raises before it touches a
    process group or starts a process."""
    import torch.multiprocessing as mp

    def no_start(*args, **kw):
        raise AssertionError("a rank was started")

    monkeypatch.setattr(mp, "start_processes", no_start)
    with pytest.raises(ValueError, match="one rank per card"):
        M.make_pe_mesh(2)
    with pytest.raises(ValueError, match="one rank per card"):
        M.spawn(cases.collective_cases, 2)


def test_cuda_mesh_never_runs_gloo(one_rank_group, one_card):
    with pytest.raises(ValueError, match="runs nccl"):
        M.make_pe_mesh(1, device="cuda")


def test_spawn_reraises_a_rank_exception():
    with pytest.raises(ValueError, match="rank 1 refuses") as info:
        M.spawn(cases.fail_on_rank_one, 2, device="cpu")
    assert any("spawned rank 1" in note
               for note in getattr(info.value, "__notes__", []))


def test_spawn_kills_ranks_past_the_join_limit():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        M.spawn(cases.sleep, 2, 600.0, device="cpu", join_timeout=2.0)
    assert time.monotonic() - t0 < 60

