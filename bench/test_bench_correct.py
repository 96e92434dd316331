"""``correct`` on the CPU at a tiny size, through the whole of a run but
the look for a card: a sound run passes, and the control and each fault a
cell can have fail.

Faults, planted in the program underneath the timed path:
* a superstep loop that hands back the state it was given;
* half of a server's plane left out, its queries answered with rows of the
  other half;
* an answer altered where it is produced (the copy to the host).
A cell on one card has no exchange between cards to leave out.
"""

import numpy as np
import pytest

from bench import harness

CELLS = harness.list_workloads()
SERVING = [c for c in CELLS if harness.load(
    harness.BENCH, "traffic",
    harness.load(harness.BENCH, "workloads", c)["traffic"])["loop"] == "open"]
SEED = 2**31 + 101


def _run(cell, root, benchmark, control=False, seconds=0.4):
    return harness.run_cell(cell, SEED, seconds, False, root=root,
                            benchmark=benchmark, device="cpu",
                            control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny_root, benchmark_json):
    r, _ = _run(cell, tiny_root, benchmark_json)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    e2e, _ = harness.cell_metrics(benchmark_json, cell)
    assert set(r["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny_root, benchmark_json):
    result, other = _run(cell, tiny_root, benchmark_json, control=True)
    limits = result["checks"]
    assert any(v is None or v > limits[k]["limit"]
               for k, v in other["control_checks"].items())


@pytest.mark.parametrize("cell", CELLS)
def test_state_left_unchanged_is_not_correct(cell, tiny_root, benchmark_json,
                                             monkeypatch):
    from repro_torch.core.engine import Engine

    loop, segment = Engine._loop, Engine._batch_segment

    def still_loop(self, program, state, *a, **k):
        _, frontier, it = loop(self, program, state, *a, **k)
        return state, frontier, it

    def still_segment(self, program, state, *a, **k):
        _, frontier, q_it, it = segment(self, program, state, *a, **k)
        return state, frontier, q_it, it

    monkeypatch.setattr(Engine, "_loop", still_loop)
    monkeypatch.setattr(Engine, "_batch_segment", still_segment)
    assert not _run(cell, tiny_root, benchmark_json)[0]["correct"]


@pytest.mark.parametrize("cell", SERVING)
def test_half_the_plane_left_out_is_not_correct(cell, tiny_root,
                                                benchmark_json, monkeypatch):
    from repro_torch.core.engine import Engine

    run_batch = Engine.run_batch

    def half(self, program, sources=None, batch=None, **k):
        sources = list(sources)
        h = max(1, len(sources) // 2)
        plane, iters = run_batch(self, program, sources=sources[:h],
                                 batch=batch, **k)
        idx = np.arange(len(sources)) % h
        return plane[idx], iters[idx]

    monkeypatch.setattr(Engine, "run_batch", half)
    assert not _run(cell, tiny_root, benchmark_json)[0]["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced_is_not_correct(cell, tiny_root,
                                                      benchmark_json,
                                                      monkeypatch):
    from repro_torch.core.engine import Engine

    to_host = Engine._to_host

    def altered(t):
        out = np.array(to_host(t))
        flat = out.reshape(-1)
        if out.dtype.kind == "f":
            i = int(np.argmax(np.abs(flat)))
            flat[i] = flat[i] * 1.01
        else:
            i = int(np.argmin(flat))
            flat[i] += 1
        return out

    monkeypatch.setattr(Engine, "_to_host", staticmethod(altered))
    assert not _run(cell, tiny_root, benchmark_json)[0]["correct"]
