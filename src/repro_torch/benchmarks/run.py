"""Benchmark entry point of the port: the sections of ``benchmarks/run.py``
whose code is ported.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--scale 13] \\
        [--quick] [--json] [--device cpu]

Runs on CUDA unless ``--device`` names another.  Prints
``name,seconds_or_value,derived`` CSV rows by the reference's names, after
a ``device`` row naming what the measured rows ran on:

  table2.*     PageRank runtimes      (paper Table 2 / Figures 3-5)
  table3.*     label-prop runtimes    (paper Table 3 / Figures 6-8)
  table4.*     SSSP runtimes          (weighted min-plus)
  table5.*     BFS runtimes           (reachability depth)
  table6.*     weighted-PageRank runtimes
  table7.*     betweenness runtimes   (batched pivots + Brandes)
  table8.*     personalized-PageRank runtimes
  cost.*       the COST verdict per program and graph: 1 where the best
               actor cell beats the serial baseline, else inf(1PE)
  fig12.*      dataflow ("GraphX") stand-in vs serial (paper Figures 1-2)
  imbalance.*  per-chare load skew + padding waste per partitioner policy
  wire.*       analytic per-chare wire bytes per superstep
  wire_batch.* B-sweep of the wire model: bytes/query as value payloads
               amortize the fixed edge-layout side
  grid.*       2-D grid partitioning: per-rectangle skew + two-phase-reduce
               wire bytes vs the best 1-D variant
  throughput.* measured queries/sec of the batched [*, B] plane against a
               per-query loop at a fixed superstep budget (bfs, B=16)
  serving.*    the same for personalized PageRank, and the measured
               queries/sec-vs-p50/p99 curve of the deadline-aware server
               (mixed bfs + personalized_pagerank traffic under
               DeadlinePolicy at 0.25x, 1x and 4x of its capacity), with
               the reference's two assertions on the curve
  async.*      barrier against overlap + frontier gate (SSSP at one
               chare), the host gating model on grid(2,4), and the
               grid(2,4) overlap + gate run (8 rectangles on one device)
               with both lowerings' counted wire bytes, under the
               reference's three assertions
  streaming.*  out-of-core streaming against the resident engine at
               grid(1,1) (SSSP): seconds, per-superstep seconds, overlap
               efficiency, edge bandwidth, the gate's fetch-skip fraction,
               the layout cache's cold/warm prep, and the batched plane's
               edge bytes and queries/s per query at B=16 against B=1
               (<= 1/8 enforced, the reference's bar)

The table sections iterate the vertex-program registry; a wrong result
fails the run.  Quick mode keeps the engine sweep on the default placement;
the full run also measures the edge-balanced policy per strategy.

Sections of the reference that print nothing here, by ROADMAP queue 1 item:
  throughput.model, serving.model, streaming.model, kernel.*,
  dispatch.*                   item 4: their cost models are the TPU's,
                               and wait for a model of the card
  roofline.*                   item 12.11 (the dry-run roofline)

``--json`` writes the ``algorithms``, ``grid``, ``throughput``,
``serving``, ``async`` and ``streaming`` sections of ``BENCH_cost.json``.
"""

from __future__ import annotations

import argparse
import json


def emit(name, value, derived=""):
    print(f"{name},{value},{derived}")


def table_rows(algo, rows):
    """One program's ``tables.run_table`` rows as the reference prints them:
    -> (list of (name, value, derived) -- its table rows, its ``cost.*``
    verdict per graph, its ``fig12.*`` dataflow ratios -- and its
    ``algorithms`` entry of BENCH_cost.json).  A wrong result raises."""
    from repro_torch.core import get_spec

    table = get_spec(algo).table
    serial = {g: t for g, impl, p, t, ok in rows if impl == "serial"}
    out, best_actor, best_impl = [], {}, {}
    for g, impl, pes, t, ok in rows:
        if not ok:
            raise AssertionError(f"{algo}/{g}/{impl} produced wrong output")
        out.append((f"{table}.{g}.{impl}@{pes}", f"{t:.4f}", ""))
        if impl not in ("serial", "dataflow") \
                and t < best_actor.get(g, float("inf")):
            best_actor[g], best_impl[g] = t, f"{impl}@{pes}"
    algo_json = {}
    for g, t in best_actor.items():
        cost = 1 if t <= serial[g] else "inf(1PE)"
        out.append((f"cost.{algo}.{g}", cost,
                    f"best_actor={t:.4f}s serial={serial[g]:.4f}s"))
        algo_json[g] = {"serial_s": serial[g], "best_actor_s": t,
                        "best_impl": best_impl[g], "cost": cost}
    for g, impl, pes, t, ok in rows:
        if impl == "dataflow":
            out.append((f"fig12.{algo}.{g}.dataflow_vs_serial",
                        f"{t / serial[g]:.2f}", "x-serial-runtime"))
    return out, algo_json


def grid_rows(rows):
    """``tables.grid_table`` rows as the reference prints them: -> (list of
    (name, value, derived), the ``grid`` section of BENCH_cost.json)."""
    out, grid_json = [], {}
    for g, pname, pes, m in rows:
        st = m["stats"]
        out.append((f"grid.{g}.{pname}@{pes}.imbalance",
                    f"{st['edge_imbalance']:.3f}",
                    f"max_e={st['max_edges']} mean_e={st['mean_edges']:.0f} "
                    f"edge_pad={st['edge_padding_waste']:.2f}"))
        out.append((f"grid.{g}.{pname}@{pes}.wire", f"{m['wire']:.3e}",
                    f"basic_1d={m['wire_basic_1d']:.3e} "
                    f"best_1d={m['wire_best_1d']:.3e}"))
        grid_json.setdefault(g, {})[f"{pname}@{pes}"] = {
            "edge_imbalance": st["edge_imbalance"],
            "wire_bytes": m["wire"],
            "wire_basic_1d": m["wire_basic_1d"],
            "wire_best_1d": m["wire_best_1d"],
        }
    return out, grid_json


def async_rows(scale, repeats, device, record):
    """The ``async.*`` rows by the reference's names, under its three
    assertions (overlap bit-exact with barrier; on grid(2,4) the gate
    launches at most half the slots; the grouped lowering's wire bytes at
    most 0.6 of the full one's).  Fills ``record`` with the ``async``
    section of BENCH_cost.json.  -> list of (name, value, derived)."""
    from repro_torch.benchmarks import tables

    at = tables.async_table(scale_log2=scale, repeats=repeats, device=device)
    if not at["bit_exact"]:
        raise AssertionError("overlap SSSP diverged from barrier")
    rows = [
        ("async.sssp.barrier@1", f"{at['barrier_s']:.4f}",
         f"iters={at['it_barrier']}"),
        ("async.sssp.overlap@1", f"{at['overlap_s']:.4f}",
         f"iters={at['it_overlap']} bit_exact={at['bit_exact']}"),
        ("async.sssp.superstep_s", f"{at['superstep_overlap_s']:.2e}",
         f"barrier={at['superstep_barrier_s']:.2e} s/superstep")]
    gm = tables.gating_model(scale_log2=scale)
    rows.append(("async.gating_model.lockstep_skipped",
                 f"{gm['skipped_fraction']:.3f}",
                 f"launched={gm['launched']}/{gm['launch_slots']} "
                 f"grid{tuple(gm['shape'])} supersteps={gm['supersteps']}"))
    am = tables.async_grid_metrics(scale_log2=scale, device=device)
    if not am["bit_exact"]:
        raise AssertionError("grid(2,4) overlap+gate SSSP diverged from "
                             "serial")
    ag = am["gate"]
    if ag["launched"] > 0.5 * ag["launch_slots"]:
        raise AssertionError(f"the gate launched more than half the "
                             f"rectangle slots: {ag}")
    rows.append(("async.grid24.gate_skipped", f"{ag['skipped_fraction']:.3f}",
                 f"launched={ag['launched']}/{ag['launch_slots']} "
                 f"iters={am['iters']} (8 rectangles on one device, "
                 "overlap+gate)"))
    if am["counted_ratio"] > 0.6:
        raise AssertionError(f"grouped/full wire bytes above 0.6: {am}")
    cb = am["collective_bytes_counted"]
    rows.append(("async.grid24.collective_ratio",
                 f"{am['counted_ratio']:.3f}",
                 f"grouped={cb['grouped']:.3e} full={cb['full']:.3e} "
                 f"model={am['collective_bytes_model']['ratio']:.3f} "
                 "(counted by the lowerings)"))
    record.update({"pe1": at, "gating_model": gm, "grid24": am})
    return rows


def streaming_rows(scale, repeats, device, record):
    """The measured ``streaming.*`` rows by the reference's names, under
    its two assertions (streamed SSSP bit-exact with resident; B=16 fetches
    at most 1/8 of B=1's edge bytes per query).  Fills ``record`` with the
    ``streaming`` section of BENCH_cost.json.  -> list of (name, value,
    derived)."""
    from repro_torch.benchmarks import tables

    st = tables.streaming_table(scale_log2=scale, repeats=repeats,
                                device=device)
    if not st["bit_exact"]:
        raise AssertionError("streamed SSSP diverged from resident")
    b1, b16 = st["batched"]["B1"], st["batched"]["B16"]
    ratio = st["batched"]["bytes_per_query_ratio"]
    if ratio > 0.125:
        raise AssertionError(f"B=16 streams more than 1/8 of B=1's edge "
                             f"bytes per query: {st['batched']}")
    record.update(st)
    return [
        ("streaming.sssp.resident@1", f"{st['resident_s']:.4f}",
         f"iters={st['iters']}"),
        ("streaming.sssp.streamed@1", f"{st['streamed_s']:.4f}",
         f"windows={st['windows']} "
         f"edge_fraction_resident={st['edge_fraction_resident']:.3f}"),
        ("streaming.sssp.superstep_s", f"{st['superstep_streamed_s']:.2e}",
         f"resident={st['superstep_resident_s']:.2e} s/superstep"),
        ("streaming.overlap_efficiency", f"{st['overlap_efficiency']:.3f}",
         f"copy={st['copy_s']:.3f}s stall={st['stall_s']:.3f}s "
         f"serialized={st['serialized_s']:.4f}s"),
        ("streaming.edge_bandwidth",
         f"{st['edge_bandwidth_bytes_per_s']:.3e}",
         "effective edge bytes/s through the window pipeline"),
        ("streaming.gate_skip_fraction", f"{st['gate_skip_fraction']:.3f}",
         "window fetches skipped under gate='frontier'"),
        ("streaming.cache_prep_speedup", f"{st['cache_speedup']:.2f}",
         f"cold={st['cache_cold_s']:.3f}s warm={st['cache_warm_s']:.3f}s "
         "(mmap'd layout cache)"),
        ("streaming.batched.bytes_per_query@B16",
         f"{b16['edge_bytes_per_query']:.3e}",
         f"B1={b1['edge_bytes_per_query']:.3e} ratio={ratio:.3f} "
         "(<=0.125 enforced)"),
        ("streaming.batched.qps@B16", f"{b16['queries_per_sec']:.2f}",
         f"B1={b1['queries_per_sec']:.2f} queries/s through the streamed "
         "run_batch plane"),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13,
                    help="log2 vertices for the scaled paper graphs")
    ap.add_argument("--quick", action="store_true",
                    help="smaller graphs / fewer repeats")
    ap.add_argument("--json", action="store_true",
                    help="write the algorithms, grid, throughput, "
                         "serving, async and streaming sections of "
                         "BENCH_cost.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    scale = 11 if args.quick else args.scale
    repeats = 2 if args.quick else 3

    import torch

    from repro_torch.benchmarks import tables
    from repro_torch.core import registered_names
    from repro_torch.core.engine import resolve_device

    device = resolve_device(args.device)  # no card: raise before any work
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    emit("device", name, f"type={device.type} "
         f"count={torch.cuda.device_count() if device.type == 'cuda' else 1}")
    cost_json = {"schema": 1, "scale_log2": scale, "quick": args.quick,
                 "device": name, "algorithms": {}}
    partitioners = (("contiguous",) if args.quick
                    else ("contiguous", "edge_balanced"))

    # ---- Tables 2-8 + Figures 1/2 (one per registered program) ------------
    for algo in registered_names():
        rows = tables.run_table(algo, scale_log2=scale, repeats=repeats,
                                partitioners=partitioners, device=device)
        lines, cost_json["algorithms"][algo] = table_rows(algo, rows)
        for line in lines:
            emit(*line)

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

    # ---- 2-D grid partitioning (rectangle skew + two-phase-reduce wire) ----
    lines, cost_json["grid"] = grid_rows(tables.grid_table(scale_log2=scale))
    for line in lines:
        emit(*line)

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

    # ---- barrier-relaxed execution (DESIGN.md section 12) ------------------
    cost_json["async"] = {}
    for name, value, derived in async_rows(scale, repeats, device,
                                           cost_json["async"]):
        emit(name, value, derived)

    # ---- out-of-core streaming (residency="stream") ------------------------
    cost_json["streaming"] = {}
    for name, value, derived in streaming_rows(scale, repeats, device,
                                               cost_json["streaming"]):
        emit(name, value, derived)

    if args.json:
        with open("BENCH_cost.json", "w") as f:
            json.dump(cost_json, f, indent=2, default=float)
        emit("json.BENCH_cost.json", "written")
    return cost_json


if __name__ == "__main__":
    main()
