"""Find a serving configuration's knee, once, in one process.

    python3 bench/sweep.py --workload tw-serve-p80 --seed 1 --seconds 10

Sets the cell's configuration up once and measures the full-plane dispatch
time of each program of the mix (the median of five warm dispatches).  For
each deadline of ``DEADLINES`` (multiples of the slowest program's
full-plane dispatch: a query may wait for the plane in flight, for one
other program's plane ahead of it, and for its own) it offers the mix's
open loop at each of ``LOADS``, multiples of the full-plane capacity
8 / (the mix's mean dispatch time), for ``--seconds`` each.  Prints one
JSON line per load: offered and served queries a second, p50/p95/p99
latency, the share over the deadline, and the queries still waiting when
the window closed; then one line per deadline naming its knee, the
highest offered rate whose p95 is within the deadline and whose backlog at
the close is no more than the queries one p95 brings (so it does not
grow).  The cells' rates and deadline are written into their traffic
files from it by hand, and never derived from the program's speed at run
time.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOADS = (0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.2)
DEADLINES = (3, 4)  # x the slowest program's full-plane dispatch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import graphgen, harness, loops, profiling, system
    from bench.traffic import generator

    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    wl = harness.load(harness.BENCH, "workloads", args.workload)
    cfg = harness.load(harness.BENCH, "configs", wl["config"])
    mix = harness.load(harness.BENCH, "traffic", wl["traffic"])
    g = cfg["graph"]
    csr = graphgen.rmat_csr(g["scale_log2"], g["edge_factor"], g["seed"],
                            dev, weighted=g["weighted"], a=g["a"], b=g["b"],
                            c=g["c"])
    starts = graphgen.vertices_with_out_edges(csr)
    server = system.build_server(system.build_engine(csr, cfg, dev),
                                 cfg["server"])
    loops.warm_server(server, mix, starts, rounds=2)
    B = server.batch
    td = {}
    for m in mix["mix"]:  # the median of five warm full-plane dispatches
        times = []
        for k in range(5):
            ids = [server.submit(m["program"], int(s), **m.get("params", {}))
                   for s in starts[k * B:(k + 1) * B]]
            server.step(force=True)
            times.append(server.last_dispatch_s)
            for rid in ids:
                server.result(rid)
        td[m["program"]] = sorted(times)[2]
    w = {m["program"]: m["weight"] for m in mix["mix"]}
    mean_td = sum(td[p] * w[p] for p in td) / sum(w.values())
    capacity = B / mean_td
    print(json.dumps({"dispatch_ms": {p: t * 1e3 for p, t in td.items()},
                      "mean_dispatch_ms": mean_td * 1e3,
                      "capacity_per_s": capacity,
                      "device": torch.cuda.get_device_name(dev)}),
          flush=True)
    off = profiling.Tracer(False, True)
    for k in DEADLINES:
        deadline_ms = k * max(td.values()) * 1e3
        knee = None
        for load in LOADS:
            m = dict(mix, rate_per_s=load * capacity, deadline_ms=deadline_ms)
            arrivals = generator.open_schedule(m, args.seed, args.seconds,
                                               starts)
            t0 = time.perf_counter()
            rec = loops.open_loop(server, arrivals, args.seconds, set(), off,
                                  0.0)
            lat = [float("inf") if d is None else d - t
                   for t, d in zip(rec["due"], rec["done"])]
            backlog = sum(d is None or d > rec["close"] for d in rec["done"])
            p95_ms = loops.percentile(lat, 95) * 1e3
            meets = (p95_ms <= deadline_ms
                     and backlog <= m["rate_per_s"] * p95_ms / 1e3)
            if meets:
                knee = m["rate_per_s"]
            print(json.dumps({
                "deadline_ms": deadline_ms, "load": load,
                "offered_per_s": m["rate_per_s"],
                "served_per_s": (len(arrivals) - backlog) / args.seconds,
                "p50_ms": loops.percentile(lat, 50) * 1e3,
                "p95_ms": p95_ms,
                "p99_ms": loops.percentile(lat, 99) * 1e3,
                "over_deadline": sum(x > deadline_ms / 1e3 for x in lat)
                / len(lat),
                "backlog_at_close": backlog, "meets": meets,
                "fill": rec["dispatch"]["queries"]
                / max(1, rec["dispatch"]["count"] * B),
                "lateness_ms": rec["lateness_s"] * 1e3,
                "wall_s": time.perf_counter() - t0}), flush=True)
        print(json.dumps({"deadline_ms": deadline_ms, "knee_per_s": knee}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
