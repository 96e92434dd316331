"""Readers shared by the per-layer metrics of several cells.

Each ``<metric>.py`` beside this file binds ``read(record) -> float |
None`` to one of these.  ``record`` is the run's: ``runs`` ((start, end,
supersteps, traced) of each closed-loop run, host clock; the host-clock
readers skip the profiled runs), ``dispatch`` (the server's dispatches in
the window outside the profiled stretch, their summed
``last_dispatch_s``, the queries they carried and the plane width), ``trace`` (``profiling.summarize`` of the
traced stretch) and ``least_s`` (the traced runs' least time at the
card's peaks, ``roofline``).  A reader with nothing to read returns None.
"""


def _untraced(record):
    return [r for r in record.get("runs") or () if not r[3]]


def superstep_ms(record):
    runs = _untraced(record)
    steps = sum(r[2] for r in runs)
    return sum(r[1] - r[0] for r in runs) / steps * 1e3 if steps else None


def supersteps_per_run(record):
    runs = _untraced(record)
    return sum(r[2] for r in runs) / len(runs) if runs else None


def _busy(record):
    t = record.get("trace")
    return t if t and t["busy_s"] > 0 and t["window_s"] > 0 else None


def idle_pct(record):
    t = _busy(record)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline(record):
    t = _busy(record)
    least = record.get("least_s")
    if t is None or not least or not t["kernel_s"]:
        return None
    return 100.0 * least / t["kernel_s"]


def dispatch_ms(record):
    d = record.get("dispatch")
    return d["seconds"] / d["count"] * 1e3 if d and d["count"] else None


def plane_fill(record):
    d = record.get("dispatch")
    if not d or not d["count"]:
        return None
    return 100.0 * d["queries"] / (d["count"] * d["batch"])
