#!/usr/bin/env python3
"""Where a process's first serving latency curve loses its time, on one GPU
(the PyTorch/CUDA port, ``src/repro_torch``).

    python3 scripts/torch_serve_first_curve.py [--scale 22] \
        [--order parent,warm,warm,parent]

Each entry of ``--order`` is one fresh process that builds the main path's
graph (``load_dataset("soc-lj1-mini", scale_log2=scale, seed=1)`` with
``random_weights(seed=5)``, C=1 sortdest, as ``chip_smoke.py`` builds it),
warms bfs and personalized PageRank at B=8, and runs
``tables.latency_table`` twice (B=8, loads 0.25/1/4, 64 queries a load,
ppr_iters=8, slo_factor=1.5: phase ``serve``'s curve).  Each result is
copied into a ``torch.empty(pin_memory=True)`` block (``Engine._to_host``;
torch's caching host allocator).  ``parent`` skips ``latency_table``'s
warm of that cache (``tables._warm_pinned_results``); ``warm`` runs it as
it is.

Per dispatch it stamps ``run_batch`` (host clock), the result copy
``_to_host``, the pinned blocks torch created inside it and their
seconds (``torch.cuda.host_memory_stats``), and the garbage collector's
pauses inside it (``gc.callbacks``); per curve it prints the
reference's two curve checks, each load's p99 and slowest dispatch, and
every dispatch over 0.05 s with its stages.  One JSON line per process.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def one(mode, scale):
    import torch

    from repro_torch.benchmarks import tables
    from repro_torch.core import engine as E
    from repro_torch.core import graph as G

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    t0 = time.perf_counter()
    g = G.random_weights(G.load_dataset("soc-lj1-mini", scale_log2=scale,
                                        seed=1), seed=5)
    eng = E.Engine(G.partition(g, 1))
    build_s = time.perf_counter() - t0

    stamps = {"gc": []}  # (start, end) host-clock pairs
    if mode == "parent":
        tables._warm_pinned_results = lambda engine, B, N: None
    gc_start = []
    gc.callbacks.append(lambda phase, info: gc_start.append(
        time.perf_counter()) if phase == "start" else stamps["gc"].append(
        (gc_start.pop(), time.perf_counter())))

    dispatches = []
    run_batch, to_host = E.Engine.run_batch, E.Engine._to_host

    def timed_to_host(self, t):
        h0 = time.perf_counter()
        out = to_host(t)
        dispatches[-1]["to_host"] = (h0, time.perf_counter())
        return out

    def allocs():
        st = torch.cuda.host_memory_stats()
        return st["num_host_alloc"], st.get("host_alloc_time.total", 0) / 1e6

    def timed_run_batch(self, *args, **kw):
        rec = {"start": time.perf_counter()}
        dispatches.append(rec)
        n0, s0 = allocs()
        out = run_batch(self, *args, **kw)
        n1, s1 = allocs()
        rec["end"] = time.perf_counter()
        rec["fresh"], rec["alloc_s"] = n1 - n0, s1 - s0
        return out

    E.Engine._to_host, E.Engine.run_batch = timed_to_host, timed_run_batch
    for prog, kw in (("bfs", {}), ("personalized_pagerank", {"iters": 8})):
        eng.run_batch(prog, sources=[0], batch=8, **kw)

    def inside(pairs, lo, hi):
        return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in pairs)

    curves = []
    for _ in range(2):
        del dispatches[:]
        n0, s0 = allocs()
        t0 = time.perf_counter()
        lt = tables.latency_table(
            engine=eng, B=8, loads=(0.25, 1.0, 4.0), queries_per_load=64,
            ppr_iters=8, slo_factor=1.5)
        wall = time.perf_counter() - t0
        rows = []
        for d in dispatches:
            lo, hi = d["start"], d["end"]
            h0, h1 = d.get("to_host", (hi, hi))
            rows.append({"s": hi - lo, "to_host_s": h1 - h0,
                         "fresh": d["fresh"], "alloc_s": d["alloc_s"],
                         "gc_s": inside(stamps["gc"], lo, hi),
                         "rest_s": (hi - lo) - (h1 - h0)})
        slow = [r for r in rows if r["s"] > 0.05]
        curves.append({
            "checks": tables.curve_checks(lt["curve"]),
            "p99_s": [c["p99_s"] for c in lt["curve"]],
            "max_dispatch_s": [max(c["dispatch_seconds"])
                               for c in lt["curve"]],
            "dispatches": len(rows), "wall_s": wall,
            "fresh_allocations": allocs()[0] - n0,
            "fresh_alloc_s": allocs()[1] - s0,
            "fresh_inside_dispatches": sum(r["fresh"] for r in rows),
            "alloc_s_inside_dispatches": sum(r["alloc_s"] for r in rows),
            "gc_s_inside_dispatches": sum(r["gc_s"] for r in rows),
            "median_dispatch_s": sorted(r["s"] for r in rows)[len(rows) // 2],
            "median_to_host_s": sorted(r["to_host_s"]
                                       for r in rows)[len(rows) // 2],
            "over_50ms": slow,
            "max_held_result_bytes": max(c["max_held_result_bytes"]
                                         for c in lt["curve"])})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return {"mode": mode, "scale": scale, "build_s": build_s,
            "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "curves": curves}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--order", default="parent,warm,warm,parent")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.scale)), flush=True)
        return 0
    rc = 0
    for mode in args.order.split(","):
        out = subprocess.run([sys.executable, __file__, "--one", mode,
                              "--scale", str(args.scale)])
        rc = rc or out.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
