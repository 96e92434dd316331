"""The device trace of a traced run: busy time, idle gaps, top operations.

``Tracer`` wraps ``torch.profiler`` around one stretch of the measured
window (whole runs or whole loop turns), marks the stretch with a
``bench.traced`` span and each call into the program with a span of its
own (``run.<program>``, ``dispatch``, ``wait``).  ``summary`` reads the
exported trace:

* ``busy_s``: the union of the device's kernels, copies and sets inside
  the stretch;
* ``kernel_s``: the union of its kernels alone (no copy or set), the time
  the kernels' work took;
* ``window_s``: the stretch's length;
* ``device_ops``: the ten device operations that took most time;
* ``idle_gaps``: the time the device sat idle, by what the host was doing
  then (the innermost host operation open at the gap's middle, under the
  benchmark's span), ten largest.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
MARK = "bench.traced"


class Tracer:
    """Profiles from ``start`` to ``stop``; a disabled tracer does nothing."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled, self.cuda = enabled, cuda
        self.active = self.done = False
        self._prof = self._mark = None

    def warm(self):
        """Start and stop the profiler once around a trivial operation, in
        set-up: its first start (CUPTI's) takes seconds, which would
        otherwise fall inside the window."""
        if not self.enabled:
            return
        self.start()
        x = torch.ones(1, device="cuda" if self.cuda else "cpu")
        x.add_(1)
        self.stop()
        self.done = False
        self._prof = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()
        self.active = True

    def stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.active, self.done = False, True

    def span(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def summary(self) -> dict | None:
        if self._prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self._prof = None
        return summarize(events)


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict | None:
    """Busy time, window, top device operations and idle gaps (seconds) of
    a chrome trace holding one ``bench.traced`` span."""
    spans = [e for e in events if e.get("ph") == "X"]
    marks = [e for e in spans if e.get("name") == MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    tid = marks[0].get("tid")
    dev, kernels, by_name = [], [], defaultdict(float)
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), hi)
            if b > a:
                dev.append((a, b))
                if e["cat"] == "kernel":
                    kernels.append((a, b))
                by_name[e["name"]] += (b - a) / 1e6
    busy = _union(dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    host = sorted([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                    e["name"]) for e in spans
                   if e.get("cat") in HOST_CATS and e.get("tid") == tid
                   and e["name"] != MARK], key=lambda h: (h[0], -h[1]))
    idle = defaultdict(float)
    stack, k = [], 0
    for g0, g1 in gaps:  # gaps and host spans both in time order
        mid = (g0 + g1) / 2
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        idle[_host_label(stack)] += (g1 - g0) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e6,
            "kernel_s": sum(b - a for a, b in _union(kernels)) / 1e6,
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in
                          sorted(idle.items(), key=lambda kv: -kv[1])[:10]]}


def _host_label(stack) -> str:
    """The benchmark's span and the innermost host operation open."""
    outer = next((name for _, _, name in stack
                  if name.startswith(("run.", "dispatch", "wait"))), "host")
    inner = stack[-1][2] if stack and stack[-1][2] != outer else "python"
    return f"{outer}/{inner}"
