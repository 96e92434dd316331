"""The device trace's reduction (``profiling.summarize``) and the readers
that take metrics from it, on a hand-made chrome trace."""

import pytest

from bench import profiling
from bench.metrics import common


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


EVENTS = [
    _x(profiling.MARK, "user_annotation", 0.0, 100.0),
    _x("run.bfs", "user_annotation", 0.0, 100.0),
    _x("tiled_min_kernel", "kernel", 10.0, 20.0, tid=7),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 25.0, 25.0, tid=7),
    _x("tiled_min_kernel", "kernel", 60.0, 10.0, tid=7),
    _x("Memset (Device)", "gpu_memset", 95.0, 10.0, tid=7),  # cut at 100
    _x("aten::item", "cpu_op", 52.0, 6.0),
]


def test_summarize_busy_kernel_and_gaps():
    s = profiling.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    # [10, 50] and [60, 70] and [95, 100]: kernels, the copy and the set
    assert s["busy_s"] == pytest.approx(55e-6)
    # the kernels alone: [10, 30] and [60, 70]
    assert s["kernel_s"] == pytest.approx(30e-6)
    ops = dict(s["device_ops"])
    assert ops["tiled_min_kernel"] == pytest.approx(30e-6)
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(25e-6)
    assert ops["Memset (Device)"] == pytest.approx(5e-6)
    gaps = dict(s["idle_gaps"])
    # [0, 10], [70, 95] under the run's span alone; [50, 60] under aten::item
    assert gaps["run.bfs/python"] == pytest.approx(35e-6)
    assert gaps["run.bfs/aten::item"] == pytest.approx(10e-6)


def test_summarize_without_the_mark_is_none():
    assert profiling.summarize(EVENTS[1:]) is None


def test_kernel_roofline_divides_by_kernel_time():
    trace = profiling.summarize(EVENTS)
    assert common.kernel_roofline({"trace": trace, "least_s": 3e-6}) \
        == pytest.approx(10.0)
    assert common.idle_pct({"trace": trace}) == pytest.approx(45.0)


@pytest.mark.parametrize("record", [{}, {"trace": None, "least_s": 1.0},
                                    {"least_s": None}])
def test_readers_with_nothing_to_read_return_none(record):
    assert common.kernel_roofline(record) is None
    assert common.idle_pct(record) is None
    assert common.superstep_ms(record) is None
    assert common.dispatch_ms(record) is None
    assert common.plane_fill(record) is None
