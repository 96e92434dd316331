"""Roofline table assembly: reads the dry-run's records
(``experiments/dryrun_torch/``, written by ``repro_torch.launch.dryrun``)
and emits the roofline table.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--dir DIR]

prints the table, ``summarize``'s aggregates and, per mesh, the cells by
bottleneck and the ones whose per-device bytes pass the card's 80 GB.

The port of ``benchmarks/roofline.py``.  A record carries the trace's
seconds (``trace_s``) where the reference's carries ``compile_s``; a
production-mesh record is rank 0's partitioned step, with the
collectives' seconds on NVLink and InfiniBand in ``collective_s``.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os

HEADERS = ("mesh", "arch", "shape", "compute_s", "memory_s", "collective_s",
           "bottleneck", "useful", "mem_gb_dev", "trace_s")

MESH_ORDER = {"card": 0, "pod16x16": 1, "pod2x16x16": 2}


def load_records(dirname="experiments/dryrun_torch"):
    recs = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def row(rec):
    if rec.get("status", "run") != "run":
        return (rec["mesh"], rec["arch"], rec["shape"], "-", "-", "-",
                "skip", "-", "-", "-")
    m = rec["memory"]
    mem_gb = (m["argument_bytes"] + (m["temp_bytes"] or 0)
              + m["output_bytes"] - m["alias_bytes"]) / 1e9
    rl = rec["roofline"]
    u = rec.get("useful_flop_ratio")
    return (rec["mesh"], rec["arch"], rec["shape"],
            f"{rl['compute_s']:.4f}", f"{rl['memory_s']:.4f}",
            f"{rl['collective_s']:.4f}", rl["bottleneck"],
            f"{u:.3f}" if u else "-", f"{mem_gb:.1f}",
            f"{rec['trace_s']:.1f}")


def as_markdown(recs):
    lines = ["| " + " | ".join(HEADERS) + " |",
             "|" + "---|" * len(HEADERS)]
    for rec in sorted(recs, key=lambda r: (MESH_ORDER.get(r["mesh"], 9),
                                           r["arch"], r["shape"])):
        lines.append("| " + " | ".join(str(x) for x in row(rec)) + " |")
    return "\n".join(lines)


def summarize(recs):
    """Aggregate stats for run.py's CSV output, over the traced records.
    ``most_collective_bound``: the cell whose collective share
    of its three terms is the largest ("-" where no cell has collective
    time: one card runs none)."""
    run = [r for r in recs if r.get("status") == "run"]
    if not run:
        return {}
    worst = min(run, key=lambda r: r.get("useful_flop_ratio") or 1)
    coll = max(run, key=lambda r: r["roofline"]["collective_s"]
               / max(sum(r["roofline"][k] for k in
                         ("compute_s", "memory_s", "collective_s")), 1e-12))
    return {
        "cells_compiled": len(run),
        "worst_useful_cell": f"{worst['arch']}x{worst['shape']}",
        "worst_useful": worst.get("useful_flop_ratio"),
        "most_collective_bound": (f"{coll['arch']}x{coll['shape']}"
                                  if coll["roofline"]["collective_s"]
                                  else "-"),
    }


def by_mesh(recs):
    """Per mesh: the traced cells by bottleneck and the ones that do not
    fit (per-device bytes above the card's 80 GB)."""
    from repro_torch.launch.mesh import HBM_BYTES

    out = {}
    for rec in recs:
        if rec.get("status", "run") != "run":
            continue
        m = out.setdefault(rec["mesh"], {"bottleneck": collections.defaultdict(
            list), "over_80gb": []})
        cell = f"{rec['arch']}x{rec['shape']}"
        mem = rec["memory"]
        per_dev = (mem["argument_bytes"] + (mem["temp_bytes"] or 0)
                   + mem["output_bytes"] - mem["alias_bytes"])
        m["bottleneck"][rec["roofline"]["bottleneck"]].append(cell)
        if per_dev > HBM_BYTES:
            m["over_80gb"].append(f"{cell} ({per_dev / 1e9:.1f} GB)")
    return {k: dict(v, bottleneck=dict(v["bottleneck"]))
            for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(as_markdown(recs))
    print(json.dumps(summarize(recs)))
    print(json.dumps(by_mesh(recs), indent=1))


if __name__ == "__main__":
    main()
