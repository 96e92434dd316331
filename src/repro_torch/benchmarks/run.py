"""Benchmark entry point of the port: the sections of ``benchmarks/run.py``
whose code is ported.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--scale 13] \\
        [--quick] [--json] [--device cpu]

Runs on CUDA unless ``--device`` names another.  Prints
``name,seconds_or_value,derived`` CSV rows by the reference's names, after
a ``device`` row naming what the measured rows ran on:

  imbalance.*  per-chare load skew + padding waste per partitioner policy
  wire.*       analytic per-chare wire bytes per superstep
  wire_batch.* B-sweep of the wire model: bytes/query as value payloads
               amortize the fixed edge-layout side
  throughput.* measured queries/sec of the batched [*, B] plane against a
               per-query loop at a fixed superstep budget (bfs, B=16)
  serving.*    the same for personalized PageRank, and the measured
               queries/sec-vs-p50/p99 curve of the deadline-aware server
               (mixed bfs + personalized_pagerank traffic under
               DeadlinePolicy at 0.25x, 1x and 4x of its capacity), with
               the reference's two assertions on the curve

Sections of the reference that print nothing here, by ROADMAP queue 1 item:
  table2-table8, fig12, cost   item 3's host loop with item 4
  throughput.model, serving.model, kernel.*, dispatch.*
                               item 4: their cost models are the TPU's,
                               and wait for a model of the card
  grid.*                       item 6
  async.*                      item 8
  streaming.*                  item 9
  roofline.*                   item 12 (the dry-run roofline)

``--json`` writes the ``throughput`` and ``serving`` sections of
``BENCH_cost.json``.
"""

from __future__ import annotations

import argparse
import json


def emit(name, value, derived=""):
    print(f"{name},{value},{derived}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13,
                    help="log2 vertices for the scaled paper graphs")
    ap.add_argument("--quick", action="store_true",
                    help="smaller graphs / fewer repeats")
    ap.add_argument("--json", action="store_true",
                    help="write the throughput and serving sections of "
                         "BENCH_cost.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    scale = 11 if args.quick else args.scale
    repeats = 2 if args.quick else 3

    import torch

    from repro_torch.benchmarks import tables
    from repro_torch.core.engine import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    emit("device", name, f"type={device.type} "
         f"count={torch.cuda.device_count() if device.type == 'cuda' else 1}")
    cost_json = {"schema": 1, "scale_log2": scale, "quick": args.quick,
                 "device": name}

    # ---- partitioner imbalance (paper's load-skew observation) ------------
    for g, pname, pes, st in tables.imbalance_table(scale_log2=scale,
                                                    pe_counts=(8,)):
        emit(f"imbalance.{g}.{pname}@{pes}", f"{st['edge_imbalance']:.3f}",
             f"max_e={st['max_edges']} mean_e={st['mean_edges']:.0f} "
             f"edge_pad={st['edge_padding_waste']:.2f} "
             f"vert_pad={st['vertex_padding_waste']:.2f}")

    # ---- wire model --------------------------------------------------------
    for g, variant, pes, bytes_ in tables.wire_table(scale_log2=scale):
        emit(f"wire.{g}.{variant}@{pes}", f"{bytes_:.3e}", "bytes/device/iter")

    # ---- batched wire model (B-sweep of the value payloads) ----------------
    for g, variant, B, bytes_, per_q in tables.wire_batch_table(
            scale_log2=scale):
        emit(f"wire_batch.{g}.{variant}@B{B}", f"{bytes_:.3e}",
             f"{per_q:.3e} bytes/query")

    # ---- batched multi-query throughput (DESIGN.md section 11) -------------
    tp = tables.throughput_table(scale_log2=scale, repeats=repeats,
                                 device=device)
    emit(f"throughput.{tp['graph']}.{tp['algo']}.batched@B{tp['B']}",
         f"{tp['qps_batched']:.2f}", "queries/s")
    emit(f"throughput.{tp['graph']}.{tp['algo']}.seq_loop@B{tp['B']}",
         f"{tp['qps_seq']:.2f}", "queries/s")
    emit(f"throughput.{tp['graph']}.{tp['algo']}.measured_speedup",
         f"{tp['measured_speedup']:.2f}",
         f"budget={tp['superstep_budget']} supersteps")
    cost_json["throughput"] = tp

    # ---- deadline-aware serving (DESIGN.md section 14) ---------------------
    ppr = tables.throughput_table(scale_log2=scale, repeats=repeats,
                                  algo="personalized_pagerank", B=16,
                                  device=device)
    emit(f"serving.{ppr['graph']}.ppr.batched@B{ppr['B']}",
         f"{ppr['qps_batched']:.2f}", "queries/s")
    emit(f"serving.{ppr['graph']}.ppr.measured_speedup",
         f"{ppr['measured_speedup']:.2f}",
         f"budget={ppr['superstep_budget']} supersteps (the reference's bar: "
         ">=3x, tests/test_graph_serve.py)")
    lt = tables.latency_table(scale_log2=min(scale, 11), device=device)
    emit("serving.capacity_qps", f"{lt['capacity_qps']:.2f}",
         f"B={lt['B']} dispatch={lt['dispatch_s']:.4f}s "
         f"slo_bfs={lt['slo_s']['bfs']:.4f}s "
         f"slo_ppr={lt['slo_s']['personalized_pagerank']:.4f}s "
         "(per-program measured budgets)")
    for row in lt["curve"]:
        emit(f"serving.{lt['graph']}.load{row['load']:g}x",
             f"{row['p50_s']:.4f}",
             f"p99={row['p99_s']:.4f}s offered={row['offered_qps']:.1f}q/s "
             f"achieved={row['achieved_qps']:.1f}q/s "
             f"fill={row['mean_fill']:.1f}/{lt['B']} "
             f"missed={row['missed_frac']:.2f}")
    checks = tables.curve_checks(lt["curve"])
    if not checks["monotone_in_load"]:
        raise AssertionError(f"latency is not monotone in offered load: "
                             f"{lt['curve']}")
    if not checks["p99_rises_1.2x"]:
        raise AssertionError(f"latency curve is flat across offered loads: "
                             f"{lt['curve']}")
    cost_json["serving"] = {**lt, "ppr_throughput": ppr, "checks": checks}

    if args.json:
        with open("BENCH_cost.json", "w") as f:
            json.dump(cost_json, f, indent=2, default=float)
        emit("json.BENCH_cost.json", "written")
    return cost_json


if __name__ == "__main__":
    main()
