"""One cell, once: set up, measure, check, and put the result together.

Everything a cell is sits in data files found by name:

* ``workloads/<cell>.json``: the configuration and traffic it pairs, the
  answers it samples for the check and the limit of each compared number;
* ``configs/<config>.json``: the graph (generator and scale) and the
  engine and server it is served by;
* ``traffic/<traffic>.json``: the mix, read by ``traffic/generator.py``;
* ``metrics/<metric>.py``: one reader for each per-layer metric, given
  the run's record; it returns None where it finds nothing to read;
* ``BENCHMARK.json`` (at the root of the checkout): which end-to-end and
  per-layer metrics the cell reports, with their units.

So a later cell, configuration, mix or metric is added by adding files.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import time

import torch

from bench import checks, graphgen, loops, profiling, roofline, system
from bench.traffic import generator

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: pathlib.Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def list_workloads(root: pathlib.Path = BENCH) -> list[str]:
    return sorted(p.stem for p in (root / "workloads").glob("*.json"))


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(benchmark: dict, cell: str) -> tuple[list, list]:
    """The cell's end-to-end metrics and its per-layer ones: those that
    list it, or, without a list, every cell that reports what they move."""
    e2e = [m for m in benchmark["end_to_end"]
           if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in benchmark["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_reader(root: pathlib.Path, name: str):
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _traced_least_seconds(csr, answers, traversals) -> float | None:
    """The least time, at the card's peaks, of the traced runs' supersteps
    (``roofline``), or None when no run was traced."""
    nbytes = flops = 0
    traced = False
    for i, a in enumerate(answers):
        if not a.traced:
            continue
        traced = True
        if a.program in checks.ADD_PROGRAMS:
            b, f = roofline.run_work(csr.num_vertices, csr.num_edges,
                                     a.supersteps,
                                     checks.ADD_PROGRAMS[a.program])
        else:
            t = traversals[i]
            b, f = roofline.run_work(csr.num_vertices, csr.num_edges,
                                     t.supersteps, a.program == "sssp",
                                     t.active_vertices, t.active_edges)
        nbytes += b
        flops += f
    return roofline.least_seconds(nbytes, flops) if traced else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: pathlib.Path = BENCH, benchmark: dict | None = None,
             device="cuda", t_start: float | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """Run cell ``name`` once.  -> (the result line's object, the run's
    other readings for the log).  ``t_start`` is when the process began
    (set-up is timed from it); ``control`` also judges the reference in
    bfloat16 put in the program's place, its numbers going to the log as
    ``control_checks``."""
    t0 = time.perf_counter() if t_start is None else t_start
    wl = load(root, "workloads", name)
    cfg = load(root, "configs", wl["config"])
    mix = load(root, "traffic", wl["traffic"])
    benchmark = load_benchmark() if benchmark is None else benchmark
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gcfg = cfg["graph"]
    # the graph is the configuration's (its own seed), the same for every
    # --seed: the seed draws the sources, the arrivals and the sample
    csr = graphgen.rmat_csr(gcfg["scale_log2"], gcfg["edge_factor"],
                            gcfg["seed"], dev, weighted=gcfg["weighted"],
                            a=gcfg["a"], b=gcfg["b"], c=gcfg["c"])
    starts = graphgen.vertices_with_out_edges(csr)
    engine = system.build_engine(csr, cfg, dev)
    tracer = profiling.Tracer(bool(trace), cuda)
    tracer.warm()
    vpe = csr.num_vertices + csr.num_edges
    if mix["loop"] == "closed":
        loops.warm_closed(engine, mix, starts)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        rec = loops.closed_loop(engine, mix, seed, starts, seconds,
                                wl["sample_per_program"], tracer,
                                wl["trace_runs"])
        runs = rec["runs"]
        span = runs[-1][1] - runs[0][0]
        e2e = {"analytics_mevps": vpe * len(runs) / span / 1e6}
        attempted, unserved = len(runs), 0
        other = {"runs": len(runs), "supersteps": sum(r[2] for r in runs)}
    else:
        server = system.build_server(engine, cfg["server"])
        loops.warm_server(server, mix, starts)
        arrivals = generator.open_schedule(mix, seed, seconds, starts)
        sample = loops.sample_queries(arrivals, wl["sample_per_program"],
                                      seed)
        _sync(dev)
        setup_s = time.perf_counter() - t0
        rec = loops.open_loop(server, arrivals, seconds, sample, tracer,
                              wl["trace_seconds"])
        del server
        lat = [math.inf if d is None else d - t
               for t, d in zip(rec["due"], rec["done"])]
        in_window = sum(d is not None and d <= rec["close"]
                        for d in rec["done"])
        e2e = {"query_p95_ms": loops.percentile(lat, 95) * 1e3,
               "query_per_s": in_window / seconds}
        attempted = len(arrivals)
        unserved = sum(d is None for d in rec["done"])
        other = {"queries": attempted, "served_in_window": in_window,
                 "p50_ms": loops.percentile(lat, 50) * 1e3,
                 "query_p95_ms": e2e["query_p95_ms"],
                 "generator_lateness_ms": rec["lateness_s"] * 1e3,
                 "dispatches": rec["dispatch"]["count"]}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = tracer.summary() if trace else None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    limits = wl["limits"]
    numbers, failed, traversals = checks.judge(csr, rec["answers"], limits,
                                               dev)
    other["check_s"] = time.perf_counter() - t_check
    if control:
        other["control_checks"] = checks.judge(csr, rec["answers"], limits,
                                               dev, True)[0]
    correct = unserved == 0 and all(
        numbers[k] is not None and numbers[k] <= v for k, v in limits.items())

    e2e_entries, layer_entries = cell_metrics(benchmark, name)
    metrics = {}
    if not trace:
        e2e["setup_s"] = setup_s
        for m in e2e_entries:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        record = dict(rec, workload=name, trace=summary,
                      least_s=_traced_least_seconds(csr, rec["answers"],
                                                    traversals))
        for m in layer_entries:
            v = load_reader(root, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if cuda else dev.type,
                  "kind": (torch.cuda.get_device_name(dev) if cuda
                           else dev.type),
                  "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed + unserved, "metrics": metrics,
              "device": device_rec}
    if summary is not None:
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": v}
                        for k, v in limits.items()}
    other["setup_s"] = setup_s
    return result, other
