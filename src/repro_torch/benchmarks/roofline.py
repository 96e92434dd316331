"""Roofline table assembly: reads the dry-run's records
(``experiments/dryrun_torch/``, written by ``repro_torch.launch.dryrun``)
and emits the roofline table.

The port of ``benchmarks/roofline.py``.  A card record carries the trace's
seconds (``trace_s``) where the reference's carries ``compile_s``; a
production-mesh record has per-device bytes and ``roofline: null``, and
gives "-" in every column the roofline would fill.
"""

from __future__ import annotations

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
    if rl is None:
        return (rec["mesh"], rec["arch"], rec["shape"], "-", "-", "-", "-",
                "-", f"{mem_gb:.1f}", "-")
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
    """Aggregate stats for run.py's CSV output, over the records with a
    roofline (the card's).  ``most_collective_bound`` is "-" while no cell
    has collective time (the port runs no collective on one card)."""
    run = [r for r in recs if r.get("status") == "run" and r.get("roofline")]
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
