#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale 22] [--chare-scale 18] [--chares 8] \
        [--cost-scale 16]

Phases, each printing one JSON line with its seconds:

  device     the card's name and power limit; refuses to run without CUDA
  build      nvcc builds every kernel source under
             src/repro_torch/kernels/csrc/ (one nvcc per source, together)
  kernels    each CUDA kernel against its plain torch version on the card.
             Fused: add x {f32, i32} x {no weight, weight}; min x {i32,
             f32} x {none, weight, unit}, a third of the sources
             unreached; at one column and on [B=4], [B=8] and [B=16]
             planes, with and without an init seed;
             all-invalid, empty-edge-block, saturation and negative-weight
             cases, unreached sources over negative weights and a float
             init above 2^31 (the min's skip must keep what they send).
             Staged: gather sum x {f32, i32, bf16},
             gather min x {i32, f32 with sentinel-range values}, scatter
             sum x {f32, i32 past 2^24}, scatter min x {i32, f32 with
             negatives}, each with and without [B=4], in chare-row and 1-D
             form; all-invalid edges; then ops.push(fused=False) against
             ops.push() over the fused matrix, and its int saturation.
             Gated (the row gate, row_active): the fused add {f32 none,
             f32 weight} and min {i32 unit, f32 weight}, with and without
             init, and the four staged kernels (whole-number float sums,
             exact in any order), under row masks none, all
             and every other row, at one column and B=4, on the
             chare-axis graph's C-chare sd layout and grid(2,4) gr_band,
             against their gated plain versions: gated rows hold init or
             the identity bit for bit, active rows equal the call without
             the gate (bit for bit; the tiled add is fixed-order)
  graph      the soc-LiveJournal1 stand-in (RMAT, 2^scale vertices, 14
             edges per vertex) and its partitions; their layouts are built
             on the card from 2^21 edges (the torch layout build), on the
             host below
  main       the main path: Engine(pg, "sortdest") at C=1 runs pagerank,
             pagerank_weighted, sssp, bfs (source 0) and labelprop, checked
             against the serial references (connected components from scipy
             for labelprop); launch counts are zeroed before and read after,
             and the add and the min must have taken the tiled path
             (``fused_push_min_tiled`` once per min superstep, no atomic
             launch of either)
  reproducible  pagerank and pagerank_weighted of the main path run twice
             more: the results must be bit-identical
  batch      the batched query plane (Engine.run_batch) on the main path's
             engine: bfs and sssp with 15 sources at B=16, personalized
             PageRank with 16 seed sets (one of three seeds) at B=16, bfs
             with 32 sources at B=32, betweenness with 4 pivots (sources
             drawn from the vertices with out-edges, 0 among them).  Every
             column must equal the same query run alone through run (bit
             for bit with the same superstep count; PPR within 1e-7 after
             the row normalization, bit for bit before it against a B=1
             plane, as the betweenness depths are), launch counts zeroed
             before and read after each batched run (one fused launch per
             superstep, on the tiled path); bfs and sssp sources 0 and one
             other, and PPR source 0, against the serial references.  Times,
             in turns (batched, one by one, one by one, batched; both warm,
             the better of two): batched against the same queries one by
             one through run, their ratio (amortization), and the split of
             a B=16 run (seed plane, loop, un-permute, finalize, copy
             back).  Then at the chare scale (C chares) B=4 for bfs and PPR
             on all four strategies against the serial references, and
             betweenness against betweenness_ref
  serve      the graph query server (repro_torch.launch.serve) on the
             main path's engine at B=8: 24 queries (12 bfs, 6 sssp, 6
             personalized PageRank with iters=8, one of them a three-seed
             set) under GreedyPolicy, then under DeadlinePolicy on a
             VirtualClock.  Every served row and superstep count equals
             the same query's own run_batch at B=1 (bit for bit for bfs
             and sssp, PPR within 1e-7), two bfs rows the serial BFS, the
             greedy dispatches admit the groups GreedyPolicy's rule gives
             that queue, and every dispatch's host-clock seconds (what the
             server measures) cover the CUDA-event time of the same
             run_batch.  Then one query at B=8 against B=1 (what an
             under-full plane costs); the port's latency_table on the
             main engine (loads 0.25, 1, 4; 8B queries per load;
             ppr_iters=8; slo_factor=1.5), the process's first, with the
             reference's two curve assertions, which must hold
             (latency_table fills torch's pinned cache with the result
             blocks a load holds before the loads; no dispatch of a load
             may create a pinned block, counted by
             torch.cuda.host_memory_stats); throughput_table for bfs and
             PPR at B=16 with a budget of 8 supersteps (PPR beside the
             reference's 3x bar, a finding, not a check); and the CLI,
             python -m repro_torch.launch.serve --graph --scale 20
             --queries 64 --batch 8 --policy deadline --programs
             bfs,personalized_pagerank
  grid       the main path's graphs under grid(2,4): 8 edge rectangles as
             the chare axis of the card, grid2d's two-phase reduce.  The
             layout (edges per rectangle, padded height, padding share and
             bytes) and the path each fused kernel takes on each gr_band
             table; the five programs against the serial references of
             main (sssp and bfs bit for bit with equal superstep counts,
             labelprop's components, the PageRanks < 1e-3), launch counts
             zeroed before and read after (one fused launch per superstep
             on the table's path), the device memory peak; the grouped
             lowering against the full one (min bit for bit, PageRank
             < 1e-6) and each lowering's counted collective bytes against
             cost.grid_collective_bytes (grouped/full <= 0.6); a B=8 plane
             of bfs and of personalized PageRank, each column equal to its
             own B=1 run (PPR within 1e-7); both fused kernels on the
             gr_band rows against their plain versions, timed against the
             atomic path beside the byte bound (the tiled add with the main
             path's bit checks); program seconds under grid(2,4) against
             sortdest at C=1, in turns, and where a grid run's time goes
             (device time by kernel, busy share, the host-built initial
             state's seconds); then the chare-axis graph under grid(2,2),
             grid(4,2) and grid(1,2) against serial
  replan     mid-run replanning on the main path's graph (C=1): one
             engine runs sssp across a switch to degree_sorted (every=2,
             mode="always"), then bfs back to contiguous, then pagerank to
             degree_sorted; min results bit-equal to serial with the
             serial superstep counts, pagerank < 1e-3 against serial (and
             its deviation from the run without a replan), the engine
             bound to the target and the new sd table on the tiled path;
             launch counts zeroed before and read after; the seconds of
             each step of a switch (the plan and lazy repartition, the
             state move, the rebind's layout build -- on the card from
             2^21 edges -- and upload) and the
             device memory peak; sssp at B=16 across a replan equal to the
             main engine's plane without one; then at the chare scale (C
             chares) sssp across contiguous->grid(2,4),
             grid(2,4)->degree_sorted and grid(4,2)->grid(2,4) against
             serial, and pagerank across a replan on basic and
             push_fn=None (the staged add pair) within 1e-3
  async      barrier relaxation and the frontier gate: at C=1 on the
             main engines sssp, bfs and labelprop under barrier, overlap
             and overlap plus gate (results equal to serial, it_b <= it_o
             <= 2 it_b + 2, launched + skipped == slots == it + 1, one
             fused launch per push), their seconds per superstep in turns
             (barrier, gated, gated, barrier); async_table on the main
             sssp engine; on phase grid's grid(2,4) partition sssp with
             overlap and the gate against serial, its skipped share, a
             host recount of its gate from the frontiers the run went
             through and the layout's edge arrays (and the masks the
             kernels got), its launches (counts
             zeroed before, read after) and async_grid_metrics; a replan
             in the middle of overlap (C=1, to degree_sorted); a B=8
             overlapped gated sssp plane against the barrier plane; at
             the chare scale sssp with overlap and the gate on sortdest,
             push_fn=None and basic (the gated staged min pair) with host
             recounts; gating_model at the chare scale
  stream     out-of-core streaming on the main graphs under grid(1,1):
             the partitions built on the card (REPRO_DEVICE_BUILD=device,
             asserted) against the host build of the same grid layout and
             of the sd layout, array by array, both builds' seconds; the
             resident grid(1,1) engine's sssp, bfs, pagerank,
             pagerank_weighted, betweenness (4 pivots), B=16 planes (bfs,
             sssp, PPR), a server at B=8 (4 bfs, 2 sssp, 2 PPR) and its
             memory peak; then the same on an Engine(residency="stream")
             under StreamConfig(budget_bytes=0.20 x total edge bytes)
             (resident_edge_bytes <= budget < total, edge fraction <=
             0.25), with no resident layout on the card: min programs and
             planes bit for bit with equal superstep counts, the PageRanks
             within rtol=1e-5 (< 1e-3 from serial), two streamed pagerank
             runs bit-identical, served rows equal; launch counts zeroed
             before and read after the streamed sssp and pagerank (one
             fused launch per window fold); the single-query working set
             within 2 windows + 16 vertex planes of what the engine holds,
             every streamed peak below the resident one (reset before each
             engine's runs); resident, streamed and serialized
             (prefetch=False, equal results) seconds and per superstep,
             overlap efficiency, copy and stall seconds, the H2D copies'
             own seconds and rate; the gate on sssp/bfs and on the
             reference's block chain (>= 0.4 of the slots skipped);
             fetched edge bytes per query at B=16 <= 1/8 of B=1's and
             queries/s; labelprop on the symmetrized graph; the layout
             cache cold then warm at scale (origin "disk", bit-exact); and
             both fused kernels on one window of the table, init-seeded,
             the rectangle gated on and off, against the plain version
  cost       the paper's COST tables: run_table for every registered
             program on the three paper stand-ins (2^cost-scale vertices,
             cut from 2^20 so the whole run stays within 1,000 s; 14, 24 and 35
             edges per vertex) with the contiguous and
             edge-balanced placements and 3 repeats (the reference's full
             run), then the cost.*, fig12.* and grid.* rows by the
             reference's names, and each graph's elapsed seconds; a wrong
             result fails the phase
  staged_main  the same graphs and programs through Engine(pg, "basic")
             and Engine(pg, "sortdest", push_fn=None): one gather and one
             scatter launch per superstep, no fused launch; counts zeroed
             before and read after; the serial references of main reused
  profile    device time by kernel over one pagerank and one bfs run of
             the main path and of the staged path (torch.profiler) and the
             device's busy share
  kernel_time  each kernel at the main path's shapes against its plain
             version: CUDA-event times, the memory bound and, where one
             PyTorch call computes the same function, that call's time.
             The tiled fused add and the tiled fused min are timed against
             the atomic path they replace, and the scatters against
             index_add_ / scatter_reduce_(amin), in turns in the same call;
             the tiled add's repeated calls and the columns of a [B=4] call
             against one-column calls must be bit-identical, the two min
             paths bit-equal to each other and to the plain version.  The
             min runs each program's call at B=1 and B=4 and on a sparse
             frontier (1% of sources reached, the rest at the identity: the
             skip that the dense calls cannot show); the min pair of the
             staged path runs at B=1 and B=4.  The batched plane's calls
             at B=8 (the server's width) and B=16 (PPR's add, bfs's and
             sssp's min) are timed with their bound against the atomic
             path, the add's columns bit-identical to one-column calls.
             The fused calls' yardstick is index_add_ /
             scatter_reduce_(amin) into the identity over values gathered
             beforehand.  The gated kernels under real supersteps' row
             masks kept by phase async: the fused min and the staged min
             pair on the chare-axis sd layout under a mask that gates some
             rows but not all, and the fused min on grid(2,4)'s gr_band
             with every row gated (the overlap pipeline's empty half;
             every live push there keeps all 8 rectangles active): each
             held against its gated plain version, then timed against the
             same call without the gate in turns and the plain version,
             beside a bound that counts the active rows' reads and every
             output row's write
  kernels_main  the kernels phase's operand matrices again on the main
             path's edge layout
  chares     2^chare-scale vertices at C chares for sortdest, reduction,
             pairs and basic (add and min tiled on sortdest and pairs,
             atomic on reduction's basic layout), the tiled add and the
             tiled min on that sd layout timed against the atomic ones in
             turns, with the main path's bit checks, and a near-uniform graph
             (erdos_renyi(2^scale, 2^(scale+1)), the reference's
             staged-choice contrast at the main path's vertex count) at C
             chares, whose dispatch must choose the staged pair; all
             against the serial references
  push_choice  one fused push against one staged pair on the main layout
             and on the staged-choice layout (is choose_push's pick the
             faster one on this card?), with the fused kernel's atomic path,
             its byte bound and the path the fused hook took (add and min),
             and program
             seconds on the staged-choice graph with either hook
  quickstart  python -m repro_torch.quickstart's main() on the card; all
             its checks must hold
  lm         the LM serving path at full width: gemma3-1b (26 layers,
             d_model 1152, 4 heads, 1 KV head, head_dim 256, d_ff 6912,
             vocab 262,144, window 512; 999,811,584 parameters, 2.0 GB in
             bf16) with parameters from init_params on the card (seed 0).
             BatchedServer with 8 requests, prompts of 64 tokens
             (np.random.default_rng(0)) and 512 generated, so positions pass
             512; the greedy tokens in range.  Prefill seconds, decode ms
             a step and tokens/s (host clock; the 496 steps after the
             first 16),
             the device profile of 4 decode steps (busy share, kernel
             launches), the peak memory, and the bound of a decode step:
             the parameter bytes read once at 3.35 TB/s.  Then a seeded
             random stream of 64 + 512 tokens, teacher-forced through
             decode_step, so the 21 local layers' ring buffers wrap holding
             distinct tokens: its logits at positions 63, 300 and 575
             against the forward over the stream on the card, and its next
             16 steps after position 63 against the same parameters on the
             CPU (from the card's cache), each within 1e-2 of max |logit|
             and each row's RMS error within 1e-2 of its logits' RMS.
             Then the CLI,
             python -m repro_torch.launch.serve --arch gemma3-1b
             --requests 8 --prompt-len 16 --gen 16, which must print its two
             lines.  Then xlstm-350m at full width and depth (24 layers,
             d_model 1024, 4 heads, expand 2; 259,350,528 parameters in
             the leaves, beside the config's analytic count): the same
             serving at 8 requests, 64 + 448 tokens; a seeded stream of
             512 tokens (two MLSTM_CHUNKs) teacher-forced through
             decode_step, its logits at 63, 300 and 511 against the
             forward; the card's forward against the CPU's on two rows of
             the stream.  Then jamba-1.5-large at full width (d_model
             8192, 64/8 heads, d_ff 24,576, 16 experts top 2) cut from 72
             to 4 layers (mamba/dense, mamba/moe, mamba/dense, attn/moe;
             a full 8-layer period is about 90 GB in bf16): serving at 8
             requests, 64 + 128 tokens, at the published capacity (decode
             drops tokens there); a 320-token stream (one MAMBA_CHUNK
             crossed) at B=4 teacher-forced against the forward at
             capacity factor E/k, where neither drops a token, at 63,
             255 and 319 (rows whose routing margin at the mark exceeds
             1e-3); the first MoE layer's moe_fwd_dense against a
             per-token oracle at the published capacity, at T=8 (C=2)
             and T=2048 (C=321): keep masks bit-equal, outputs by the
             two tests; the first mamba layer alone, forward and 16
             decode steps, card against CPU.  Then llama4-scout and
             kimi-k2 at their smoke configs: served at 8 requests, 16 +
             8 tokens, the served tokens teacher-forced on the card and
             the CPU (rows with a clear routing); and the dispatch at
             kimi-k2's 384 experts, top 8, at smoke width against the
             oracle.  Each architecture's decode ms a step and tokens/s,
             prefill seconds, kernels a step and busy share (4 profiled
             steps), peak memory, and the step's bound (parameters once,
             recurrent states read and written, at 3.35 TB/s)
  train      the training path (repro_torch.models.train,
             repro_torch.optim, repro_torch.data, repro_torch.launch.train):
             gemma3-1b at full width and depth (26 layers, d_model 1152,
             vocab 262,144), random weights from seed 0, B=8, S=1024 (two
             cross-entropy chunks of 512), AdamW with f32 moments under
             WSD (peak 1e-3, warmup 2), 16 steps on SyntheticLM's batches
             drawn on the card (timed on their own; batch_at must be a
             function of the step); the loss must fall (the last 4 steps'
             mean below the first 4's); an AsyncCheckpointer save at step
             8, restored into a fresh state on the card bit for bit, then
             steps 9-12 again within 1e-3 of the straight run; one step at
             microbatches=2 against 1 from the restored state (params
             within rtol 1e-2, atol 2e-3, tests/test_train.py:41; loss
             within 1e-4); two steps under torch.profiler (kernels a step,
             busy share); the gradient's peak memory with remat "dots"
             at B=8, and "dots" and "none" on its first 4 rows (equal
             losses; "none" at B=8 does not fit beside the state); two
             steps through train_loop.  Each
             step's host-clock ms (it ends in loss.item()), tokens/s, the
             checkpoint's bytes and seconds, and the step's bound (FLOPs
             from the config over 989 TFLOP/s, the state's bytes over
             3.35 TB/s).  Then every architecture's smoke config, one
             step, card against CPU on the same parameters and batch: the
             loss within 1e-3, the gradient norm within 2e-2, every
             gradient leaf within max(3e-2, the CPU gradient's own change
             under a rounding-level perturbation) of its max

Then one JSON line with every kernel's numbers (launches from the main
path for the fused pair, from staged_main for the staged four, from
phase grid for the fused pair on gr_band, ``fused_push_add/grid`` and
``fused_push_min/grid``, and from phase async for the gated variants,
``fused_push_min/gated``, ``fused_push_min/gated/grid``, ``gather_min/gated``
and ``scatter_min/gated``, each from the gated run its timed call came
from, and from phase stream for the windowed rows, ``fused_push_min/window``
and ``fused_push_add/window``), the ``nvidia-smi`` name and power limit, and as the last line ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero and prints no ok line.  Min
programs and int32 sums must be bit-equal to the plain versions; float sums
agree with them within rtol=1e-5, atol=1e-6*max|out| (the plain version sums
in another order).  Float sums are fixed-order on seg-sorted rows (the
tiled fused add): repeated calls and runs must match bit for bit there.
The atomic paths (the fused add on other rows, scatter_sum) add floats in
no fixed order; every min path is exact in any order.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
PORT = ROOT / "src" / "repro_torch"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM data sheet, dense bf16 tensor cores
ADD_RTOL = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


class Smoke:
    def __init__(self, args):
        self.args = args
        self.kernel_rows = {}
        self.refs = {}  # (graph key, program) -> serial reference
        # gated pushes of real supersteps, kept by phase async for
        # kernel_time: the fused min's (some rows gated on the chare axis,
        # every row on grid(2,4)) and the staged pair's
        self.gated_call = self.bubble_call = self.staged_call = None

    # -- helpers -------------------------------------------------------------

    def phase(self, name, fn):
        t0 = time.perf_counter()
        out = fn() or {}
        emit({"phase": name, "seconds": round(time.perf_counter() - t0, 3),
              **out})

    @staticmethod
    def cuda_ms(fn, iters):
        import torch

        fn()
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    @staticmethod
    def compare(got, want, combine, what, operands=None):
        """Min and int sums bit-equal; float sums within the stated
        tolerance.  Returns the max abs error.  A mismatch first saves the
        operands (when given), the kernel's output and the plain output
        under ``build/mismatch/`` and prints the path and the first
        indices that differ."""
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                                 f"{tuple(want.shape)}/{want.dtype}")
        if combine == "min" or not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                bad = got != want
                Smoke._keep_mismatch(what, got, want, operands, bad)
                raise AssertionError(f"{what}: {int(bad.sum())} elements "
                                     "differ")
            return 0.0
        err = (got.double() - want.double()).abs()
        scale = float(want.double().abs().max()) if want.numel() else 0.0
        tol = 1e-6 * scale + ADD_RTOL * want.double().abs()
        if bool((err > tol).any()):
            Smoke._keep_mismatch(what, got, want, operands, err > tol)
            raise AssertionError(f"{what}: max abs err {float(err.max())} "
                                 f"beyond rtol={ADD_RTOL}, "
                                 f"atol=1e-6*{scale}")
        return float(err.max()) if err.numel() else 0.0

    @staticmethod
    def _keep_mismatch(what, got, want, operands, bad):
        """Save a failed comparison for diagnosis (``torch.save``: the
        operands, the kernel's output, the plain output) and print where
        it is and the first differing indices with both values."""
        import re

        import torch

        out_dir = ROOT / "build" / "mismatch"  # git ignores build/
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / (re.sub(r"[^A-Za-z0-9_.=-]+", "_", what) + ".pt")
        cpu = lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x
        torch.save({"what": what, "got": cpu(got), "want": cpu(want),
                    "operands": {k: cpu(v) for k, v in
                                 (operands or {}).items()}}, path)
        idx = bad.nonzero()[:10].cpu().tolist()
        first = [{"index": i, "got": float(got[tuple(i)]),
                  "want": float(want[tuple(i)])} for i in idx]
        print(f"chip_smoke: {what} mismatch kept at {path}; first "
              f"differing: {first}", file=sys.stderr, flush=True)

    # -- phases --------------------------------------------------------------

    def device(self):
        import numpy as np
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false: this "
                               "smoke run needs a CUDA device")
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        self.kind = torch.cuda.get_device_name(0)
        return {"nvidia_smi": self.smi, "torch_device": self.kind,
                "torch": torch.__version__, "cuda": torch.version.cuda,
                "numpy": np.__version__}

    def build(self):
        from repro_torch.kernels import _build

        names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
        times = {}

        def one(name):
            t0 = time.perf_counter()
            path = _build.build(name)
            times[name] = round(time.perf_counter() - t0, 3)
            return str(path)

        with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
            libs = list(ex.map(one, names))
        for name in names:
            _build.load(name)
        return {"sources": names, "libraries": libs, "build_s": times}

    def _check_kernel(self, band, src, dst, valid, w, vals, S, combine,
                      unit, init, what):
        """One kernel launch against the plain version on the same inputs."""
        import torch

        from repro_torch.kernels.push_fused import fused_push, fused_push_plain

        got = fused_push(band, src, dst, valid, w, vals, S, combine=combine,
                         unit_weight=unit, init=init)
        want = fused_push_plain(band, src, dst, valid, w, vals, S,
                                combine=combine, unit_weight=unit, init=init)
        torch.cuda.synchronize()
        return self.compare(got, want, combine, what, operands=dict(
            band=band, src=src, dst=dst, valid=valid, w=w, vals=vals, S=S,
            combine=combine, unit_weight=unit, init=init))

    def _kernel_matrix(self, band, src, dst, valid, V, S, seed, float_vals,
                       batches=(None, 4)):
        """Both kernels over every operand combination on one edge layout:
        add x {f32, i32} x {no weight, weight}, min x {i32, f32} x {none,
        weight, unit}, each at every plane width of ``batches`` (None: one
        column) with and without an init seed (and, for several chare rows,
        on one row alone), a third of the min sources unreached; then
        ``_min_edge_cases``.  ``float_vals`` draws the float values.
        Returns the number of cases."""
        import torch

        from repro_torch.kernels.push_fused import SENTINEL, fused_push_plain

        gen = torch.Generator(device="cuda").manual_seed(seed)
        C, E = src.shape
        ints = lambda lo, hi, shape: torch.randint(
            lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)
        matrix = [("add", torch.float32, m) for m in ("none", "array")] \
            + [("add", torch.int32, m) for m in ("none", "array")] \
            + [("min", dt, m) for dt in (torch.int32, torch.float32)
               for m in ("none", "array", "unit")]
        cases = 0
        for combine, dtype, mode in matrix:
            for B in batches:
                shape = (C, V) + (() if B is None else (B,))
                if dtype == torch.float32:
                    vals = float_vals(shape, gen)
                    w = torch.rand((C, E), generator=gen, device="cuda") \
                        * 3.5 + 0.5
                elif combine == "add":
                    # past float32's 2^24 integer range: ints stay ints
                    vals, w = ints(1 << 24, 1 << 26, shape), ints(0, 3, (C, E))
                else:
                    vals, w = ints(0, 10_000, shape), ints(0, 9, (C, E))
                if combine == "min":  # a third of the sources unreached
                    vals.view(-1)[::3] = (float("inf")
                                          if dtype.is_floating_point
                                          else SENTINEL)
                w = w if mode == "array" else None
                for seeded in (False, True):
                    init = (fused_push_plain(band, src, dst, valid, None, vals,
                                             S, combine=combine)
                            if seeded else None)
                    what = f"{combine}/{dtype}/{mode}/B={B}/init={seeded}"
                    self._check_kernel(band, src, dst, valid, w, vals, S,
                                       combine, mode == "unit", init, what)
                    cases += 1
                    if C > 1:  # the same call on one layout row (1-D form)
                        self._check_kernel(
                            band[1], src[1], dst[1], valid[1],
                            None if w is None else w[1], vals[1], S, combine,
                            mode == "unit", None if init is None else init[1],
                            what + "/row")
                        cases += 1
        return cases + self._min_edge_cases(band, src, dst, valid, V, S,
                                            seed)

    def _min_edge_cases(self, band, src, dst, valid, V, S, seed):
        """The fused min's skip against the plain version, bit for bit, on
        one edge layout (the tiled path on the sd layout, the atomic one on
        random edges), with and without a [B=4] plane: every source
        unreached over weights down to -300 (ints) or -2000 (floats) --
        SENTINEL + w and 2^31 + w are real values -- and a float init above
        2^31 (+inf, 3e9), which a slot no contribution lowers keeps.
        Returns the number of cases."""
        import torch

        from repro_torch.kernels.push_fused import SENTINEL

        gen = torch.Generator(device="cuda").manual_seed(seed + 100)
        C, E = src.shape
        rand = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
        cases = 0
        for B in (None, 4):
            shape = (C, V) + (() if B is None else (B,))
            oshape = (C, S) + shape[2:]
            iw = (rand(C, E) * 305 - 300).to(torch.int32)
            fw = rand(C, E) * 2005 - 2000
            ivals = torch.full(shape, SENTINEL, dtype=torch.int32,
                               device="cuda")
            fvals = torch.full(shape, float("inf"), device="cuda")
            for vals, w, what in ((ivals, iw, "int"), (fvals, fw, "float")):
                self._check_kernel(band, src, dst, valid, w, vals, S, "min",
                                   False, None,
                                   f"min/unreached over negative w/{what}/"
                                   f"B={B}")
            far = torch.where(rand(*oshape) < 0.5, float("inf"), 3e9)
            half = torch.where(rand(*shape) < 0.5, rand(*shape) * 100,
                               float("inf"))
            for w in (None, fw + 2000):
                self._check_kernel(band, src, dst, valid, w, half, S, "min",
                                   False, far,
                                   f"min/float init above 2^31/B={B}")
            cases += 4
        return cases

    STAGED_CASES = (  # (kernel, value dtype name)
        ("gather_sum", "float32"), ("gather_sum", "int32"),
        ("gather_sum", "bfloat16"), ("gather_min", "int32"),
        ("gather_min", "float32"), ("scatter_sum", "float32"),
        ("scatter_sum", "int32"), ("scatter_min", "int32"),
        ("scatter_min", "float32"))

    def _staged_matrix(self, src, dst, valid, V, S, seed):
        """The four staged kernels against their plain versions on one edge
        layout (``[C, E]`` rows): every (kernel, dtype) of STAGED_CASES,
        with and without a [B=4] plane, in chare-row form and on one row
        (1-D form).  Float sums draw from [0, 1), as PageRank's mass does;
        float min values include negatives, +inf and the sentinel range;
        int sums start past 2^24.  Returns (cases, max abs err)."""
        import torch

        from repro_torch.kernels import push_staged
        from repro_torch.kernels.push_fused import SENTINEL, SENTINEL_F32

        gen = torch.Generator(device="cuda").manual_seed(seed)
        C, E = src.shape
        cases, worst = 0, 0.0

        def draw(kernel, dtype, shape):
            if dtype == "int32":
                lo, hi = ((1 << 24, 1 << 26) if kernel.endswith("sum")
                          else (0, 1 << 30))
                x = torch.randint(lo, hi, shape, generator=gen,
                                  device="cuda", dtype=torch.int32)
                if kernel.endswith("min"):
                    x[..., ::9] = SENTINEL
                return x
            if kernel.endswith("sum"):
                x = torch.rand(shape, generator=gen, device="cuda")
                return x.to(torch.bfloat16) if dtype == "bfloat16" else x
            x = torch.randn(shape, generator=gen, device="cuda") * 100
            x[..., ::7] = SENTINEL_F32 * 1.5  # above the sentinel: unreached
            x[..., 3::11] = float("inf")
            return x

        for kernel, dtype in self.STAGED_CASES:
            gather = kernel.startswith("gather")
            fn = getattr(push_staged, kernel)
            plain = getattr(push_staged, kernel + "_plain")
            combine = "add" if kernel == "scatter_sum" else "min"
            for B in (None, 4):
                tail = () if B is None else (B,)
                x = draw(kernel, dtype, (C, V if gather else E) + tail)
                for rows in (slice(None), C - 1):  # chare rows, one row
                    idx = (src if gather else dst)[rows]
                    args = ((idx, valid[rows], x[rows]) if gather
                            else (idx, x[rows], S))
                    got, want = fn(*args), plain(*args)
                    torch.cuda.synchronize()
                    worst = max(worst, self.compare(
                        got, want, combine,
                        f"{kernel}/{dtype}/B={B}/rows={rows}"))
                    cases += 1
                del x
        return cases, worst

    def _unfused_matrix(self, src, dst, valid, V, S, seed):
        """ops.push(fused=False) -- the staged pair -- against ops.push()
        -- the fused kernel -- on the same operands: add x {f32, i32} x
        {no weight, weight}, min x {i32, f32} x {none, weight, unit}, with
        and without [B=4] and an init seed.  Returns the number of cases."""
        import torch

        from repro_torch.kernels import ops

        gen = torch.Generator(device="cuda").manual_seed(seed)
        C, E = src.shape
        ints = lambda lo, hi, shape: torch.randint(
            lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)
        matrix = [("add", torch.float32, m) for m in ("none", "array")] \
            + [("add", torch.int32, m) for m in ("none", "array")] \
            + [("min", dt, m) for dt in (torch.int32, torch.float32)
               for m in ("none", "array", "unit")]
        cases = 0
        for combine, dtype, mode in matrix:
            for B in (None, 4):
                shape = (C, V) + (() if B is None else (B,))
                if dtype == torch.float32:
                    vals = torch.rand(shape, generator=gen, device="cuda")
                    if combine == "min":
                        vals = vals * 100
                        vals[..., ::5] = float("inf")
                    w = torch.rand((C, E), generator=gen, device="cuda") \
                        * 3.5 + 0.5
                elif combine == "add":
                    vals, w = ints(1 << 24, 1 << 26, shape), ints(0, 3, (C, E))
                else:
                    vals, w = ints(0, 10_000, shape), ints(0, 9, (C, E))
                kw = dict(combine=combine,
                          weight=w if mode == "array" else None,
                          unit_weight=mode == "unit")
                for seeded in (False, True):
                    init = (ops.push(vals, src, dst, valid, S,
                                     combine=combine) if seeded else None)
                    got = ops.push(vals, src, dst, valid, S, fused=False,
                                   init=init, **kw)
                    want = ops.push(vals, src, dst, valid, S, init=init, **kw)
                    torch.cuda.synchronize()
                    self.compare(got, want, combine,
                                 f"unfused {combine}/{dtype}/{mode}/B={B}/"
                                 f"init={seeded}")
                    cases += 1
        return cases

    def kernels(self):
        import numpy as np
        import torch

        from repro_torch.kernels import ops
        from repro_torch.kernels.push_fused import SENTINEL, fused_push

        dev = torch.device("cuda")
        rng = np.random.default_rng(0)
        run = self._check_kernel
        C, E, V, S = 3, 4096, 1024, 1024
        t = lambda a: torch.from_numpy(a).to(dev)
        s = t(rng.integers(0, V, (C, E)).astype(np.int32))
        d = t(rng.integers(0, S, (C, E)).astype(np.int32))
        v = t(rng.integers(0, 2, (C, E)).astype(np.int32))
        band = ops._bands_on_device(s, d, v, E // 256)
        cases = self._kernel_matrix(
            band, s, d, v, V, S, seed=0,
            float_vals=lambda shape, gen: torch.randn(
                shape, generator=gen, device="cuda"),
            batches=(None, 4, 8, 16))
        # negative values and weights: the float min's sign-split atomics
        vals = t(rng.normal(size=(C, V)).astype(np.float32))
        w = t(rng.uniform(-5, 5, (C, E)).astype(np.float32))
        run(band, s, d, v, w, vals, S, "min", False, None, "min/negative")
        # all-invalid: the identity everywhere
        zero = torch.zeros_like(v)
        zband = ops._bands_on_device(s, d, zero, E // 256)
        for combine, vals in (("add", vals), ("min", vals),
                              ("min", vals.to(torch.int32))):
            run(zband, s, d, zero, None, vals, S, combine, False, None,
                f"{combine}/all-invalid/{vals.dtype}")
        # whole empty edge blocks (band hi == -1) between live ones
        half = v.clone()
        half[:, 1024:3072] = 0
        hband = ops._bands_on_device(s, d, half, E // 256)
        if not bool((hband[:, 1] < 0).any()):
            raise AssertionError("empty-block case has no empty block")
        run(hband, s, d, half, None, vals, S, "add", False, None,
            "add/empty-blocks")
        run(hband, s, d, half, None, vals.to(torch.int32), S, "min", True,
            None, "min/empty-blocks")
        cases += 6
        # saturation at the sentinel headroom: must clamp, never wrap
        sat = torch.tensor([SENTINEL - 1, SENTINEL, SENTINEL - 3, 7],
                           dtype=torch.int32, device=dev)
        one = torch.zeros(256, dtype=torch.int32, device=dev)
        sidx = one.clone()
        sidx[:4] = torch.arange(4, device=dev, dtype=torch.int32)
        sval = one.clone()
        sval[:4] = 1
        sw = torch.full((256,), 5, dtype=torch.int32, device=dev)
        sband = ops._bands_on_device(sidx, sidx, sval, 1)
        for w, unit in ((sw, False), (None, True)):
            run(sband, sidx, sidx, sval, w, sat, 256, "min", unit, None,
                f"min/saturation/unit={unit}")
            cases += 1
        out = fused_push(sband, sidx, sidx, sval, sw, sat, 256,
                         combine="min")
        if out[:4].tolist() != [SENTINEL, SENTINEL, SENTINEL, 12]:
            raise AssertionError(f"saturation: {out[:4].tolist()}")
        # ops.push: +inf unreached round-trips the sentinel encoding
        fv = torch.tensor([0.0, float("inf"), 2.5], device=dev)
        fs = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
        got = ops.push(fv, fs, fs.flip(0), torch.ones_like(fs), 3,
                       combine="min", weight=torch.ones(3, device=dev))
        if got.tolist() != [3.5, float("inf"), 1.0]:
            raise AssertionError(f"ops.push float min: {got.tolist()}")
        staged, _ = self._staged_matrix(s, d, v, V, S, seed=2)
        unfused = self._unfused_matrix(s, d, v, V, S, seed=3)
        gated = self._gated_matrix()
        # staged edge cases: all-invalid edges gather the identity; the
        # unfused push saturates at the sentinel headroom, never wraps
        from repro_torch.kernels import push_staged

        for fn in (push_staged.gather_sum, push_staged.gather_min):
            for x in (vals.float() + 0.5, vals):  # vals is int32 here
                got = fn(s, zero, x)
                plain = getattr(push_staged, fn.__name__ + "_plain")
                self.compare(got, plain(s, zero, x), "min",
                             f"{fn.__name__}/all-invalid/{x.dtype}")
                staged += 1
        for w, unit in ((sw, False), (None, True)):
            out = ops.push(sat, sidx, sidx, sval, 256, combine="min",
                           weight=w, unit_weight=unit, fused=False)
            want = ([SENTINEL, SENTINEL, SENTINEL - 2, 8] if unit
                    else [SENTINEL, SENTINEL, SENTINEL, 12])
            if out[:4].tolist() != want:
                raise AssertionError(f"unfused saturation: {out[:4].tolist()}")
            staged += 1
        return {"cases": cases, "staged_cases": staged,
                "unfused_cases": unfused, "gated_cases": gated}

    def kernels_main(self):
        """The kernel matrix again on the main path's sd layout (58.6M edges
        at scale 22).  Float values are uniform in [0, 1): sums of up to
        ~10^5 positive terms keep the atomic-order difference inside the
        stated tolerance, as PageRank's mass does."""
        import torch

        a = self.engines["pagerank"].arrays
        K = self.pgw.chunk_size
        cases = self._kernel_matrix(
            a["sd_band"], a["sd_src_local"], a["sd_dst_global"],
            a["sd_edge_valid"], K, K, seed=1,
            float_vals=lambda shape, gen: torch.rand(
                shape, generator=gen, device="cuda"))
        staged, err = self._staged_matrix(
            a["sd_src_local"], a["sd_dst_global"], a["sd_edge_valid"], K, K,
            seed=4)
        return {"cases": cases, "staged_cases": staged,
                "staged_max_abs_err": err,
                "edges": int(a["sd_edge_valid"].sum())}

    def graph(self):
        import numpy as np

        from repro_torch.core import graph as G

        a = self.args
        t0 = time.perf_counter()
        g = G.load_dataset("soc-lj1-mini", scale_log2=a.scale, seed=1)
        self.gw = G.random_weights(g, seed=5)
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.gu = g.to_undirected()
        t_und = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.pgw = G.partition(self.gw, 1, eager=False)
        self.pgu = G.partition(self.gu, 1, eager=False)
        t_part = time.perf_counter() - t0
        t_build = []
        for pg in (self.pgw, self.pgu):
            t0 = time.perf_counter()
            pg.sd_band  # build the sd layout (the only one C=1 sortdest reads)
            t_build.append(round(time.perf_counter() - t0, 3))
        return {"vertices": g.num_vertices, "edges": g.num_edges,
                "undirected_edges": self.gu.num_edges,
                "edges_per_vertex": round(g.num_edges / g.num_vertices, 3),
                "rmat_s": round(t_gen, 3), "to_undirected_s": round(t_und, 3),
                "partition_s": round(t_part, 3), "sd_build_s": t_build,
                "layout_builds": [self.pgw.layout_builds["sd"],
                                  self.pgu.layout_builds["sd"]],
                "sd_emax": int(self.pgw.edge_valid.shape[1]),
                "mean_degree_check": float(np.mean(g.out_degrees))}

    @staticmethod
    def _expected_launches(eng, combine, iters):
        """The launches one run of ``eng`` must make: the fused kernel of
        the monoid once per superstep, with the path its layout's band
        table gives each row (``tile_plan``; the min tiles only a table
        dense enough) -- the tiled kernel (for add with its merge pass),
        the atomic kernel, or both -- or, for ``basic``,
        ``push_fn=None`` or the staged hook, one gather and one scatter
        kernel of the monoid per superstep; no other kernel."""
        from repro_torch.kernels import push_fused

        want = dict.fromkeys(push_fused.launch_counts, 0)
        fused = (eng.strategy != "basic" and eng.push_fn is not None
                 and getattr(eng.push_fn, "fused", True))
        if fused:
            want[f"fused_push_{combine}"] = iters
            band = eng.arrays[{"reduction": "band", "grid2d": "gr_band"}
                              .get(eng.strategy, "sd_band")]
            plan = push_fused.tile_plan(band)
            tiled = (plan.num_tiled if combine == "add" or plan.min_tiled
                     else 0)
            if tiled:
                want[f"fused_push_{combine}_tiled"] = iters
                if combine == "add" and plan.merge_tiles.numel():
                    want["fused_push_add_merge"] = iters
            if tiled < band.shape[0]:
                want[f"fused_push_{combine}_atomic"] = iters
        else:
            half = "sum" if combine == "add" else "min"
            want[f"gather_{half}"] = want[f"scatter_{half}"] = iters
        return want

    def _reference(self, name, graph, key, labelprop_iters=False):
        """The serial reference of one program on one graph, computed once
        per ``key`` and cached: (result, supersteps or None, seconds).
        labelprop's is the connected components (scipy), with the serial
        labelprop's superstep count only where ``labelprop_iters`` asks."""
        from repro_torch.core import programs as P
        from repro_torch.core.labelprop import labelprop_serial

        if (key, name) not in self.refs:
            spec = P.get_spec(name)
            t0 = time.perf_counter()
            if name == "labelprop":
                ref = self._components(graph)
                it = labelprop_serial(graph)[1] if labelprop_iters else None
            else:
                out = spec.serial(graph, **spec.defaults)
                ref, it = out if spec.returns_iters else (out, None)
            self.refs[(key, name)] = (ref, it, time.perf_counter() - t0)
        return self.refs[(key, name)]

    def _check_program(self, eng, name, graph, C, key,
                       labelprop_iters=False):
        """Warm run + timed run of one program; checks against the serial
        reference and the launch counts; returns a result row."""
        import numpy as np
        import torch

        from repro_torch.core import programs as P
        from repro_torch.kernels import push_fused

        spec = P.get_spec(name)
        eng.run(name)  # warm
        before = dict(push_fused.launch_counts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, iters = eng.run(name)
        secs = time.perf_counter() - t0
        launched = {k: push_fused.launch_counts[k] - before[k]
                    for k in before}
        combine = spec.make(**spec.defaults).combiner.name
        if launched != self._expected_launches(eng, combine, iters):
            raise AssertionError(f"{name}/{eng.strategy}: {launched} "
                                 f"launches for {iters} supersteps")
        ref, ref_iters, t_ref = self._reference(name, graph, key,
                                                labelprop_iters)
        if not spec.matches(got, ref):
            raise AssertionError(f"{name}/{eng.strategy} at C={C}: does not "
                                 "match the serial reference")
        if ref_iters is not None and iters != ref_iters:
            raise AssertionError(f"{name}/{eng.strategy}: {iters} "
                                 f"supersteps, serial {ref_iters}")
        err = (0.0 if spec.exact or name == "labelprop" else
               float(np.max(np.abs(np.asarray(got, np.float64) - ref))))
        return {"program": name, "seconds": round(secs, 4),
                "supersteps": iters, "serial_supersteps": ref_iters,
                "launches": {k: n for k, n in launched.items() if n},
                "max_abs_err": err, "reference_s": round(t_ref, 3)}

    @staticmethod
    def _components(graph):
        """Connected components (scipy), canonicalized to the minimum vertex
        id of each component: what converged label propagation holds."""
        import numpy as np
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components

        n = graph.num_vertices
        adj = sp.csr_matrix((np.ones(graph.num_edges, np.int8), graph.dst,
                             graph.indptr), shape=(n, n))
        ncomp, comp = connected_components(adj, directed=False)
        first = np.full(ncomp, n, dtype=np.int64)
        np.minimum.at(first, comp, np.arange(n))
        return first[comp].astype(np.int32)

    def main(self):
        import torch

        from repro_torch.core import Engine
        from repro_torch.kernels import push_fused

        engines = {"pagerank": Engine(self.pgw), "labelprop": Engine(self.pgu)}
        for name in ("pagerank_weighted", "sssp", "bfs"):
            engines[name] = engines["pagerank"]
        for name, eng in engines.items():
            if eng.dispatch["choice"] != "fused" or \
                    eng.dispatch["kernel"] != "cuda":
                raise AssertionError(f"{name}: dispatch {eng.dispatch}")
        torch.cuda.reset_peak_memory_stats()
        rows = []
        push_fused.reset_launch_counts()
        for name in ("pagerank", "pagerank_weighted", "sssp", "bfs",
                     "labelprop"):
            graph = self.gu if name == "labelprop" else self.gw
            rows.append(self._check_program(engines[name], name, graph, 1,
                                            "main"))
        self.main_launches = dict(push_fused.launch_counts)
        for k in ("fused_push_add", "fused_push_min", "fused_push_add_tiled",
                  "fused_push_add_merge", "fused_push_min_tiled"):
            if self.main_launches[k] == 0:
                raise AssertionError(f"{k} was not launched on the main path")
        for combine in ("add", "min"):
            if self.main_launches[f"fused_push_{combine}_atomic"]:
                raise AssertionError(f"the main path's {combine} took the "
                                     "atomic path")
        self.engines = engines
        return {"programs": rows, "launches": self.main_launches,
                "dispatch": {k: v for k, v in engines["pagerank"]
                             .dispatch.items() if not isinstance(v, dict)},
                "peak_device_bytes": torch.cuda.max_memory_allocated()}

    def reproducible(self):
        """The main path's float sums are fixed-order: pagerank and
        pagerank_weighted run twice more give the same bits."""
        import numpy as np

        out = {}
        for name in ("pagerank", "pagerank_weighted"):
            eng = self.engines[name]
            a, _ = eng.run(name)
            b, _ = eng.run(name)
            a, b = np.asarray(a), np.asarray(b)
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                raise AssertionError(f"{name}: two runs differ in "
                                     f"{int((a != b).sum())} elements")
            out[name] = {"bit_identical": True, "vertices": int(a.size)}
        return out

    # -- the batched query plane --------------------------------------------

    @staticmethod
    def _timed(fn):
        """Host seconds of ``fn`` from an idle device; ``fn`` ends in a copy
        back to the host, so the device has finished when it returns."""
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    @staticmethod
    def _raw_plane(eng, prog, sets):
        """The plane of ``sets`` (one column each) before ``finalize_batch``,
        on the device in original vertex order: ``[B, V]``."""
        state, qp = eng._batch_init(prog, sets)
        state, _ = eng._batch_loop(prog, state, qp)
        return eng._unpermute(state)

    def _batch_case(self, eng, name, sources, B):
        """One batched run of ``sources`` at width B against the same
        queries run one by one through ``run``: launches, column equality,
        superstep counts, and the two timed in turns."""
        import numpy as np
        import torch

        from repro_torch.core import programs as P
        from repro_torch.kernels import push_fused

        prog = P.make_program(name)
        combine = prog.combiner.name
        ppr = name == "personalized_pagerank"
        key = "seeds" if ppr else "source"
        push_fused.reset_launch_counts()
        plane, q_it = eng.run_batch(name, sources=sources, batch=B)
        launched = dict(push_fused.launch_counts)
        steps = eng.dispatch["supersteps"]
        if launched != self._expected_launches(eng, combine, steps) or \
                launched[f"fused_push_{combine}_tiled"] != steps:
            raise AssertionError(f"{name}/B={B}: {launched} launches for "
                                 f"{steps} supersteps")
        if steps != int(q_it.max()):
            raise AssertionError(f"{name}/B={B}: {steps} supersteps, "
                                 f"queries {q_it.tolist()}")
        alone = [eng.run(name, **{key: s}) for s in sources]
        err = 0.0
        for i, (row, it) in enumerate(alone):
            if it != int(q_it[i]):
                raise AssertionError(f"{name}/B={B} query {i}: {q_it[i]} "
                                     f"supersteps, alone {it}")
            if ppr:
                err = max(err, float(np.abs(row - plane[i]).max()))
            elif not np.array_equal(row, plane[i]):
                raise AssertionError(f"{name}/B={B} query {i} differs from "
                                     "its own run")
        if err > 1e-7:
            raise AssertionError(f"{name}/B={B}: normalized columns {err} "
                                 "from their own runs")
        if ppr:  # before the normalization: bit for bit against B=1
            sets = P.seed_sets(sources)
            raw = self._raw_plane(eng, prog, sets + (sets[0],) *
                                  (B - len(sets)))
            for i, s in enumerate(sets):
                one = self._raw_plane(eng, prog, (s,))[0].contiguous()
                if not torch.equal(raw[i].contiguous().view(torch.int32),
                                   one.view(torch.int32)):
                    raise AssertionError(f"{name}/B={B} query {i}: raw "
                                         "column differs from its B=1 plane")
            del raw, one
        batched = lambda: eng.run_batch(name, sources=sources, batch=B)
        one_by_one = lambda: [eng.run(name, **{key: s}) for s in sources]
        b1, s1 = self._timed(batched), self._timed(one_by_one)
        s2, b2 = self._timed(one_by_one), self._timed(batched)
        return {"program": name, "B": B, "queries": len(sources),
                "batched_s": min(b1, b2), "sequential_s": min(s1, s2),
                "amortization": min(s1, s2) / min(b1, b2),
                "turns_s": {"batched": [b1, b2], "sequential": [s1, s2]},
                "supersteps": steps, "query_supersteps": q_it.tolist(),
                "launches": {k: n for k, n in launched.items() if n},
                "columns_equal_alone": True,
                "ppr_normalized_max_abs_err": err if ppr else None}, plane

    def _batch_split(self, eng, name, sources, B):
        """Where one warm batched run's time goes: seed plane, loop,
        un-permute, finalize, copy back (the device idle between stages;
        the second of two passes)."""
        import torch

        from repro_torch.core import programs as P

        prog = P.make_program(name)
        sets = P.seed_sets(sources)
        padded = sets + (sets[0],) * (B - len(sets))
        for _ in range(2):
            t = [time.perf_counter()]
            stamp = lambda: (torch.cuda.synchronize(),
                             t.append(time.perf_counter()))
            state, qp = eng._batch_init(prog, padded)
            stamp()
            state, _ = eng._batch_loop(prog, state, qp)
            stamp()
            plane = eng._unpermute(state)[:len(sets)]
            stamp()
            if prog.finalize_batch is not None:
                plane = prog.finalize_batch(self.gw, sets, plane)
            stamp()
            host = eng._to_host(plane)
            t.append(time.perf_counter())
            del state, qp, plane
        steps = [b - a for a, b in zip(t, t[1:])]
        return {"program": name, "B": B, "seed_plane_s": steps[0],
                "loop_s": steps[1], "unpermute_s": steps[2],
                "finalize_s": steps[3], "copy_back_s": steps[4],
                "unpermute_plus_copy_back_s": steps[2] + steps[4],
                "result_bytes": host.nbytes}

    def batch(self):
        """The batched query plane on the main path's engine (sortdest,
        C=1, scale 22); see the module docstring."""
        import numpy as np
        import torch

        from repro_torch.core import programs as P

        eng = self.engines["pagerank"]
        rng = np.random.default_rng(11)
        live = np.flatnonzero(self.gw.out_degrees > 0)
        pick = lambda k: [int(v) for v in rng.choice(live, k, replace=False)]
        src15, src32 = [0] + pick(14), pick(32)
        ppr_sets = [(0,)] + [(v,) for v in pick(14)] + [tuple(pick(3))]
        pivots = tuple([0] + pick(3))
        torch.cuda.reset_peak_memory_stats()
        runs, planes = [], {}
        for name, sources, B in (("bfs", src15, 16), ("sssp", src15, 16),
                                 ("personalized_pagerank", ppr_sets, 16),
                                 ("bfs", src32, 32)):
            row, planes[(name, B)] = self._batch_case(eng, name, sources, B)
            runs.append(row)
        # the serial references: sources 0 (main's) and one other
        serial = {}
        for name in ("bfs", "sssp"):
            plane = planes[(name, 16)]
            for i in (0, 1):
                if i == 0:
                    ref, it, _ = self._reference(name, self.gw, "main")
                else:
                    ref, it = P.get_spec(name).serial(self.gw,
                                                      source=src15[1])
                row = runs[("bfs", "sssp").index(name)]
                if not np.array_equal(plane[i], ref) or \
                        row["query_supersteps"][i] != it:
                    raise AssertionError(f"{name} source {src15[i]}: not "
                                         "the serial reference")
            serial[name] = [src15[0], src15[1]]
        t0 = time.perf_counter()
        ref = P.personalized_pagerank_serial(self.gw, seeds=(0,))
        ppr_ref_s = time.perf_counter() - t0
        ppr_err = float(np.abs(planes[("personalized_pagerank", 16)][0]
                               - ref).max())
        if ppr_err > 1e-6:
            raise AssertionError(f"PPR source 0: {ppr_err} from serial")
        del planes
        split = [self._batch_split(eng, n, s, 16)
                 for n, s in (("bfs", src15), ("personalized_pagerank",
                                               ppr_sets))]
        if split[0]["unpermute_plus_copy_back_s"] >= 0.1:
            raise AssertionError(f"un-permute + copy back {split[0]}")
        btw = self._betweenness_main(eng, pivots)
        profiles = {f"{n}/B=16": self._device_profile(
            lambda: eng.run_batch(n, sources=s, batch=16))
            for n, s in (("bfs", src15), ("personalized_pagerank",
                                           ppr_sets))}
        return {"runs": runs, "split": split, "betweenness": btw,
                "profiles": profiles,
                "serial_checked": {**serial, "personalized_pagerank": [0]},
                "ppr_serial_max_abs_err": ppr_err,
                "ppr_serial_s": ppr_ref_s,
                "chares": self._batch_chares(),
                "peak_device_bytes": torch.cuda.max_memory_allocated()}

    def _betweenness_main(self, eng, pivots):
        """Betweenness with 4 pivots on the main graph: the depth plane
        bit-equal to each pivot's B=1 plane, one fused launch per
        superstep, and the time of the whole run and of its Brandes
        accumulation."""
        import numpy as np

        from repro_torch.core import programs as P
        from repro_torch.kernels import push_fused

        prog = P.make_program("betweenness", pivots=pivots)
        push_fused.reset_launch_counts()
        depths, q_it = eng.run_batch(prog)
        steps = eng.dispatch["supersteps"]
        launched = dict(push_fused.launch_counts)
        if launched != self._expected_launches(eng, "min", steps):
            raise AssertionError(f"betweenness: {launched} for {steps}")
        for i, p in enumerate(pivots):
            one, it = eng.run_batch(prog, sources=[p], batch=1)
            if not np.array_equal(one[0], depths[i]) or it[0] != q_it[i]:
                raise AssertionError(f"betweenness pivot {p}: depths differ "
                                     "from its B=1 plane")
        scores, iters = eng.run(prog)  # warm
        secs = self._timed(lambda: eng.run(prog))
        plane, _ = eng._batch(prog, P.seed_sets(pivots))
        brandes_s = self._timed(lambda: P._betweenness_from_depths(
            self.gw, P.seed_sets(pivots), plane).cpu())
        if iters != int(q_it.max()) or not np.isfinite(scores).all():
            raise AssertionError("betweenness: bad scores or count")
        return {"pivots": list(pivots), "seconds": secs,
                "brandes_s": brandes_s, "supersteps": iters,
                "launches": {k: n for k, n in launched.items() if n},
                "max_score": float(scores.max())}

    def _batch_chares(self):
        """At the chare scale (C chares): B=4 for bfs and PPR on all four
        strategies against the serial references, and betweenness on
        sortdest against betweenness_ref (rtol 1e-12: float64 atomics add
        in no fixed order)."""
        import numpy as np

        from repro_torch.core import Engine
        from repro_torch.core import programs as P
        from repro_torch.kernels import ref as kref

        _, gw, _, pgw, _ = self._chare_graphs()
        rng = np.random.default_rng(12)
        live = np.flatnonzero(gw.out_degrees > 0)
        sources = [0] + [int(v) for v in rng.choice(live, 3, replace=False)]
        sets = [(s,) for s in sources[:3]] + [tuple(sources[1:])]
        t0 = time.perf_counter()
        bfs_ref = [P.bfs_serial(gw, source=s) for s in sources]
        ppr_ref = [P.personalized_pagerank_serial(gw, seeds=s) for s in sets]
        btw_ref, btw_it = kref.betweenness_ref(gw, tuple(sources))
        ref_s = time.perf_counter() - t0
        rows = []
        for strategy in ("sortdest", "reduction", "pairs", "basic"):
            eng = Engine(pgw, strategy)
            plane, it = eng.run_batch("bfs", sources=sources, batch=4)
            for i, (want, want_it) in enumerate(bfs_ref):
                if not np.array_equal(plane[i], want) or it[i] != want_it:
                    raise AssertionError(f"bfs/{strategy} at C="
                                         f"{pgw.num_chunks} query {i}")
            plane, _ = eng.run_batch("personalized_pagerank", sources=sets,
                                     batch=4)
            err = max(float(np.abs(plane[i] - want).max())
                      for i, want in enumerate(ppr_ref))
            if err > 1e-6:
                raise AssertionError(f"PPR/{strategy}: {err} from serial")
            rows.append({"strategy": strategy, "choice":
                         eng.dispatch["choice"], "ppr_max_abs_err": err})
        got, it = Engine(pgw).betweenness(pivots=tuple(sources))
        if it != btw_it or not np.allclose(got, btw_ref, rtol=1e-12,
                                           atol=1e-9):
            raise AssertionError("betweenness at the chare scale: "
                                 f"{float(np.abs(got - btw_ref).max())} "
                                 "from betweenness_ref")
        return {"chares": pgw.num_chunks, "vertices": gw.num_vertices,
                "runs": rows, "references_s": ref_s,
                "betweenness_max_abs_err": float(np.abs(got - btw_ref).max()),
                "betweenness_supersteps": it}

    # -- the graph query server ----------------------------------------------

    class _EventTimed:
        """An engine as the server sees it, with CUDA events recorded (not
        waited on) around each ``run_batch``: a dispatch's event time is
        what the device spent between them."""

        def __init__(self, eng):
            self.eng, self.events = eng, []

        def run_batch(self, *args, **kw):
            import torch

            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.eng.run_batch(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out

    class _PinnedCounted:
        """An engine whose ``run_batch`` counts the pinned host blocks torch
        created for it (``torch.cuda.host_memory_stats``: blocks its cache
        could not serve) and their seconds, one pair per call."""

        def __init__(self, eng):
            self.eng, self.fresh = eng, []

        def __getattr__(self, name):
            return getattr(self.eng, name)

        def run_batch(self, *args, **kw):
            import torch

            s0 = torch.cuda.host_memory_stats()
            out = self.eng.run_batch(*args, **kw)
            s1 = torch.cuda.host_memory_stats()
            self.fresh.append((
                s1["num_host_alloc"] - s0["num_host_alloc"],
                (s1.get("host_alloc_time.total", 0)
                 - s0.get("host_alloc_time.total", 0)) / 1e6))
            return out

    @staticmethod
    def _serve_queue(server, timed, traffic, deadline=None):
        """Submit ``traffic`` ((program, source, params) triples) and step
        the server until its queue is empty (forced once the policy holds
        with nothing left to arrive); per dispatch: the admitted ids, the
        host-clock seconds the server measured, the CUDA-event seconds of
        the same ``run_batch`` (which they must cover) and the plane's
        supersteps.  Returns (dispatches, the most result bytes held)."""
        for p, s, kw in traffic:  # ids 0, 1, ... in traffic order
            server.submit(p, s, deadline=deadline, **kw)
        rows = []
        while server.pending():
            done = server.step() or server.step(force=True)
            start, end = timed.events[-1]
            end.synchronize()
            event_s = start.elapsed_time(end) / 1e3
            dt = server.last_dispatch_s
            if dt < event_s:
                raise AssertionError(f"dispatch {len(rows)}: the server "
                                     f"measured {dt} s, the device {event_s}")
            rows.append({"ids": done, "dt_s": dt,
                         "event_s": event_s,
                         "supersteps": max(server.stats[i].iters
                                           for i in done)})
        return rows, server.held_result_bytes()

    def serve(self):
        """The graph query server on the main engine (sortdest, C=1, scale
        22) at B=8; see the module docstring."""
        import numpy as np

        from repro_torch.benchmarks import tables
        from repro_torch.core import programs as P
        from repro_torch.kernels import push_fused
        from repro_torch.launch import serve as S

        eng = self.engines["pagerank"]
        timed = self._EventTimed(eng)
        B = 8
        rng = np.random.default_rng(13)
        live = np.flatnonzero(self.gw.out_degrees > 0)
        srcs = [0] + [int(v) for v in rng.choice(live, 25, replace=False)]
        # 24 queries in arrival order bfs, sssp, PPR, bfs, ...: 12 bfs, 6
        # sssp, 6 PPR (iters=8), one PPR a three-seed set
        cycle = ("bfs", "sssp", "personalized_pagerank", "bfs")
        traffic = []
        for q in range(24):
            prog = cycle[q % 4]
            ppr = prog == "personalized_pagerank"
            src = tuple(srcs[24:26] + [srcs[q]]) if q == 2 else srcs[q]
            traffic.append((prog, src, {"iters": 8} if ppr else {}))
        # what GreedyPolicy must admit: the head's program and params, the
        # first B of them in arrival order
        greedy, left = [], list(range(len(traffic)))
        while left:
            key = (traffic[left[0]][0], traffic[left[0]][2])
            group = [i for i in left
                     if (traffic[i][0], traffic[i][2]) == key][:B]
            greedy.append(group)
            left = [i for i in left if i not in group]
        # each query alone: run_batch at B=1
        alone = [eng.run_batch(p, sources=[s], batch=1, **kw)
                 for p, s, kw in traffic]
        served = {}
        for label, policy, clock, deadline in (
                ("greedy", S.GreedyPolicy(), None, None),
                ("deadline", S.DeadlinePolicy(), S.VirtualClock(), 2.0)):
            server = S.GraphQueryServer(timed, batch=B, policy=policy,
                                        clock=clock)
            push_fused.reset_launch_counts()
            rows, held = self._serve_queue(server, timed, traffic, deadline)
            launched = dict(push_fused.launch_counts)
            # one plane per dispatch: its monoid's fused kernel once per
            # superstep, on the tiled path
            expected = dict.fromkeys(launched, 0)
            for r in rows:
                combine = ("add" if traffic[r["ids"][0]][0] ==
                           "personalized_pagerank" else "min")
                for k, n in self._expected_launches(
                        eng, combine, r["supersteps"]).items():
                    expected[k] += n
            if launched != expected or not all(
                    launched[k] for k in ("fused_push_add_tiled",
                                          "fused_push_min_tiled")):
                raise AssertionError(f"{label}: launches {launched}, "
                                     f"expected {expected}")
            if label == "greedy":
                self.serve_launches = launched
                if [r["ids"] for r in rows] != greedy:
                    raise AssertionError(f"greedy admitted "
                                         f"{[r['ids'] for r in rows]}, not "
                                         f"{greedy}")
            if sorted(i for r in rows for i in r["ids"]) != \
                    list(range(len(traffic))):
                raise AssertionError(f"{label}: not every query served once")
            err = 0.0
            for q, (prog, src, _) in enumerate(traffic):
                row, it = server.result(q)
                want, want_it = alone[q]
                if it != int(want_it[0]):
                    raise AssertionError(f"{label} query {q}: {it} "
                                         f"supersteps, alone {want_it[0]}")
                if prog == "personalized_pagerank":
                    err = max(err, float(np.abs(row - want[0]).max()))
                elif not np.array_equal(row, want[0]):
                    raise AssertionError(f"{label} query {q} ({prog}) "
                                         "differs from its own B=1 run")
            if err > 1e-7:
                raise AssertionError(f"{label}: PPR rows {err} from B=1")
            served[label] = {
                "dispatches": server.dispatches, "dispatch_rows": rows,
                "launches": {k: n for k, n in launched.items() if n},
                "held_result_bytes": held, "ppr_max_abs_err": err,
                "dispatch_s": dict((f"{p}/B={b}", t) for (p, b), t in
                                   server.dispatch_times.items()),
                "min_margin_s": min(r["dt_s"] - r["event_s"] for r in rows)}
        # two bfs rows against the serial BFS
        serial = []
        for q in (0, 3):
            ref, it = (self._reference("bfs", self.gw, "main")[:2] if q == 0
                       else P.bfs_serial(self.gw, source=traffic[q][1]))
            if not np.array_equal(alone[q][0][0], ref) or \
                    int(alone[q][1][0]) != it:
                raise AssertionError(f"bfs query {q}: not the serial BFS")
            serial.append(traffic[q][1])
        del alone
        under = self._under_full(eng, srcs[1], B)
        pinned = self._pinned_alloc(B, self.gw.num_vertices)
        # the process's first curve, checked: latency_table fills torch's
        # pinned cache with a load's result blocks before its loads, where
        # a fresh 128 MiB cudaHostAlloc inside a dispatch once stalled it
        # for 0.08-0.28 s (scripts/torch_serve_first_curve.py); no
        # dispatch of a load may allocate one
        counted = self._PinnedCounted(eng)
        lt = tables.latency_table(
            engine=counted, B=B, loads=(0.25, 1.0, 4.0),
            queries_per_load=8 * B, ppr_iters=8, slo_factor=1.5)
        in_loads = counted.fresh[-sum(r["dispatches"] for r in lt["curve"]):]
        pinned_fresh = {
            "load_dispatches": len(in_loads),
            "fresh_blocks": sum(n for n, _ in in_loads),
            "fresh_s": sum(t for _, t in in_loads),
            "warm_drain_fresh_blocks": sum(
                n for n, _ in counted.fresh[:-len(in_loads)])}
        if pinned_fresh["fresh_blocks"]:
            raise AssertionError(f"the loads allocated pinned blocks: "
                                 f"{pinned_fresh}")
        checks = tables.curve_checks(lt["curve"])
        if not all(checks.values()):
            raise AssertionError(f"latency curve checks {checks}: "
                                 f"{lt['curve']}")
        throughput = [tables.throughput_table(engine=eng, algo=algo, B=16,
                                              budget=8)
                      for algo in ("bfs", "personalized_pagerank")]
        throughput[1]["reference_bar"] = 3.0  # tests/test_graph_serve.py:74
        throughput[1]["meets_reference_bar"] = \
            throughput[1]["measured_speedup"] >= 3.0
        cli = S.main(["--graph", "--scale", "20", "--queries", "64",
                      "--batch", "8", "--policy", "deadline",
                      "--programs", "bfs,personalized_pagerank"])
        # sources of the curve and the throughput rows are uniform over all
        # vertices, as the reference draws them; a source without
        # out-edges converges in one superstep
        dead = float((self.gw.out_degrees == 0).mean())
        return {"B": B, "queries": len(traffic), "served": served,
                "vertices_without_out_edges_share": dead,
                "greedy_groups": greedy, "serial_checked_bfs": serial,
                "under_full": under, "pinned_alloc_s": pinned,
                "latency": lt, "curve_checks": checks,
                "latency_pinned_fresh": pinned_fresh,
                "throughput": throughput, "cli": cli}

    @staticmethod
    def _pinned_alloc(B, V):
        """Host seconds to allocate one dispatch's pinned ``[B, V]`` int32
        result block (``Engine._to_host``): three held at once, so each is
        a fresh allocation, then one more after they are freed, which the
        caching host allocator serves from its cache."""
        import torch

        held, fresh = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            held.append(torch.empty((B, V), dtype=torch.int32,
                                    pin_memory=True))
            fresh.append(time.perf_counter() - t0)
        del held
        t0 = time.perf_counter()
        block = torch.empty((B, V), dtype=torch.int32, pin_memory=True)
        cached = time.perf_counter() - t0
        del block
        return {"bytes": B * V * 4, "fresh": fresh, "cached": cached}

    def _under_full(self, eng, src, B):
        """What an under-full plane costs: one query at the server's width
        B against the same query at B=1 (the plane runs B columns whatever
        its fill), warm, in turns (B, 1, 1, B), the better of each."""
        out = {}
        for prog, kw in (("bfs", {}), ("personalized_pagerank",
                                       {"iters": 8})):
            wide = lambda: eng.run_batch(prog, sources=[src], batch=B, **kw)
            one = lambda: eng.run_batch(prog, sources=[src], batch=1, **kw)
            wide(), one()
            w1, o1 = self._timed(wide), self._timed(one)
            o2, w2 = self._timed(one), self._timed(wide)
            out[prog] = {f"one_query_at_B{B}_s": min(w1, w2),
                         "one_query_at_B1_s": min(o1, o2),
                         "ratio": min(w1, w2) / min(o1, o2),
                         "turns_s": {"wide": [w1, w2], "one": [o1, o2]}}
        return out

   # -- the 2-D grid ---------------------------------------------------------

    PROGRAMS = ("pagerank", "pagerank_weighted", "sssp", "bfs", "labelprop")

    @staticmethod
    def _grid_layout(pg):
        """A grid partition's rectangles: edges per rectangle, the padded
        height every rectangle takes (the heaviest one's), the padding
        share, the padded edge slots and their bytes on the card (four
        4-byte planes), and the row and column chunk heights."""
        from repro_torch.core.partitioners import partition_stats
        from repro_torch.kernels.blocks import BLOCK_E, num_edge_blocks

        st = partition_stats(pg)
        emax = int(pg.edge_valid.shape[1])
        slots = pg.num_chunks * num_edge_blocks(emax) * BLOCK_E
        return {"rect_counts": pg.plan.rect_counts.tolist(), "emax": emax,
                "edge_padding_waste": st["edge_padding_waste"],
                "edge_imbalance": st["edge_imbalance"],
                "padded_edge_slots": slots,
                "padded_edge_bytes": 16 * slots,
                "row_chunk_size": pg.chunk_size,
                "col_chunk_size": pg.col_chunk_size}

    @staticmethod
    def _grid_path(eng):
        """The path each monoid's fused kernel takes on a grid engine's
        ``gr_band`` table (``push_fused.tile_plan``)."""
        from repro_torch.kernels import push_fused

        band = eng.arrays["gr_band"]
        plan = push_fused.tile_plan(band)
        rows = band.shape[0]
        return {"rows": rows, "seg_sorted_rows": plan.num_tiled,
                "add": "tiled" if plan.num_tiled == rows else "mixed",
                "min": ("tiled" if plan.min_tiled and plan.num_tiled == rows
                        else "atomic"),
                "merge_tiles": int(plan.merge_tiles.numel()),
                "work_items": int(plan.work.shape[0]),
                "num_tiles": plan.num_tiles}

    def _grid_wire(self, eng, want, what):
        """The bytes the engine's phase-2 reduces counted in its last run
        against ``grid_collective_bytes``'s price of its lowering."""
        got = eng.dispatch["collectives"]
        price = want[got["lowering"]]
        if abs(got["bytes_per_superstep"] - price) > 1e-9 * price:
            raise AssertionError(f"{what}: counted {got}, priced {price}")
        return got["bytes_per_superstep"]

    def grid(self):
        """The main path's graphs under grid(2,4) -- 8 rectangles as the
        chare axis of the card -- and the chare-axis graph under three more
        shapes; see the module docstring."""
        import numpy as np
        import torch

        from repro_torch.core import Engine, cost
        from repro_torch.core import graph as G
        from repro_torch.kernels import push_fused

        R, C = 2, 4
        P, name = R * C, f"grid({R},{C})"
        t0 = time.perf_counter()
        pgw = G.partition(self.gw, P, name, eager=False)
        pgu = G.partition(self.gu, P, name, eager=False)
        layout = {}
        for label, pg in (("weighted", pgw), ("undirected", pgu)):
            pg.gr_band  # build the rectangle layout
            layout[label] = self._grid_layout(pg)
        engines = {"grouped": (Engine(pgw), Engine(pgu)),
                   "full": (Engine(pgw, collectives="full"),
                            Engine(pgu, collectives="full"))}
        setup_s = time.perf_counter() - t0
        eng, engu = engines["grouped"]
        for e in (eng, engu):
            if e.strategy != "grid2d" or e.dispatch["choice"] != "fused" \
                    or e.dispatch["kernel"] != "cuda":
                raise AssertionError(f"grid: {e.strategy} {e.dispatch}")
        paths = {"weighted": self._grid_path(eng),
                 "undirected": self._grid_path(engu)}
        price = cost.grid_collective_bytes(self.gw, P, name)
        if not price["ratio"] <= 0.6:
            raise AssertionError(f"grid: grouped/full {price}")
        # the grid path: counts zeroed just before, read just after
        torch.cuda.reset_peak_memory_stats()
        push_fused.reset_launch_counts()
        rows = []
        for prog in self.PROGRAMS:
            e, graph = (engu, self.gu) if prog == "labelprop" else (eng,
                                                                    self.gw)
            row = self._check_program(e, prog, graph, P, "main")
            row["wire_bytes_per_superstep"] = self._grid_wire(
                e, price, f"grid/{prog}")
            rows.append(row)
        self.grid_launches = dict(push_fused.launch_counts)
        peak = torch.cuda.max_memory_allocated()
        for k in ("fused_push_add", "fused_push_min"):
            if self.grid_launches[k] == 0:
                raise AssertionError(f"{k} was not launched on the grid")
        lowerings = self._grid_lowerings(engines, price)
        plane = self._grid_plane(eng, P, name)
        kernels = self._grid_kernels(eng, engu)
        turns = self._grid_turns(eng, engu)
        where = self._grid_where(eng)
        self.grid_pgw = pgw  # phase async reuses the weighted grid partition
        del engines, eng, engu, pgw, pgu
        torch.cuda.empty_cache()
        chares = self._grid_chares()
        return {"shape": [R, C], "setup_s": round(setup_s, 3),
                "layout": layout, "paths": paths, "programs": rows,
                "launches": {k: n for k, n in self.grid_launches.items()
                             if n},
                "peak_device_bytes": peak,
                "collective_bytes_model": price, "lowerings": lowerings,
                "plane_b8": plane, "kernels": kernels,
                "seconds_vs_sortdest_c1": turns, "where": where,
                "chare_axis": chares,
                "vertices_without_out_edges_share":
                    float(np.mean(self.gw.out_degrees == 0))}

    def _grid_lowerings(self, engines, price):
        """``grouped`` against ``full`` on every program: min results bit
        for bit with equal superstep counts, the PageRanks within 1e-6;
        each lowering's counted bytes against its price."""
        import numpy as np

        out = []
        for prog in self.PROGRAMS:
            i = 1 if prog == "labelprop" else 0
            got = {}
            for low, pair in engines.items():
                got[low] = pair[i].run(prog)
                self._grid_wire(pair[i], price, f"grid/{low}/{prog}")
            (a, ia), (b, ib) = got["grouped"], got["full"]
            if ia != ib:
                raise AssertionError(f"grid/{prog}: {ia} supersteps grouped, "
                                     f"{ib} full")
            if prog in ("pagerank", "pagerank_weighted"):
                err = float(np.abs(a - b).max())
                if err >= 1e-6:
                    raise AssertionError(f"grid/{prog}: grouped vs full {err}")
            elif not np.array_equal(a, b):
                raise AssertionError(f"grid/{prog}: grouped != full")
            else:
                err = 0.0
            out.append({"program": prog, "supersteps": ia,
                        "max_abs_err": err,
                        "bytes_per_superstep": {
                            low: pair[i].dispatch["collectives"]
                            ["bytes_per_superstep"]
                            for low, pair in engines.items()}})
        return out

    def _grid_plane(self, eng, P, name):
        """A B=8 plane of bfs and of personalized PageRank on the grid: each
        column equals its own B=1 run (bfs bit for bit, PPR within 1e-7,
        equal superstep counts), one fused launch per superstep on the
        table's path, and the counted bytes priced at B=8."""
        import numpy as np

        from repro_torch.core import cost
        from repro_torch.kernels import push_fused

        B = 8
        rng = np.random.default_rng(17)
        live = np.flatnonzero(self.gw.out_degrees > 0)
        srcs = [0] + [int(v) for v in rng.choice(live, B - 1, replace=False)]
        price = cost.grid_collective_bytes(self.gw, P, name, batch=B)
        out = {}
        for prog, combine, kw in (("bfs", "min", {}),
                                  ("personalized_pagerank", "add",
                                   {"iters": 20})):
            eng.run_batch(prog, sources=srcs, batch=B, **kw)  # warm
            push_fused.reset_launch_counts()
            t0 = time.perf_counter()
            plane, iters = eng.run_batch(prog, sources=srcs, batch=B, **kw)
            secs = time.perf_counter() - t0
            launched = dict(push_fused.launch_counts)
            steps = eng.dispatch["supersteps"]
            if launched != self._expected_launches(eng, combine, steps):
                raise AssertionError(f"grid plane/{prog}: {launched} for "
                                     f"{steps} supersteps")
            wire = self._grid_wire(eng, price, f"grid plane/{prog}")
            err = 0.0
            for i, s in enumerate(srcs):
                one, it = eng.run_batch(prog, sources=[s], batch=1, **kw)
                if int(it[0]) != int(iters[i]):
                    raise AssertionError(f"grid plane/{prog} column {i}: "
                                         f"{iters[i]} vs {it[0]} supersteps")
                if combine == "add":
                    err = max(err, float(np.abs(plane[i] - one[0]).max()))
                elif not np.array_equal(plane[i], one[0]):
                    raise AssertionError(f"grid plane/{prog} column {i} "
                                         "differs from its B=1 run")
            if err > 1e-7:
                raise AssertionError(f"grid plane/{prog}: {err} from B=1")
            out[prog] = {"B": B, "seconds": secs, "supersteps": steps,
                         "query_supersteps": [int(x) for x in iters],
                         "launches": {k: n for k, n in launched.items()
                                      if n},
                         "max_abs_err": err,
                         "wire_bytes_per_superstep": wire}
        return out

    def _grid_kernels(self, eng, engu):
        """Both fused kernels on the grid's ``gr_band`` rows (one call over
        all 8 rectangles, the column space as the segment count) against
        their plain versions, timed against the atomic path with the main
        path's bit checks, beside the byte bound; each kernel also goes on
        the kernels line."""
        import torch

        from repro_torch.kernels import push_fused

        a, au = eng.arrays, engu.arrays
        P, K, dev = eng._C, eng._K, eng.device
        S = eng.pg.grid_shape[1] * eng.pg.col_chunk_size
        gen = torch.Generator(device=dev).manual_seed(5)
        fvals = torch.rand((P, K), generator=gen, device=dev)
        dist = torch.where(torch.rand((P, K), generator=gen, device=dev)
                           < 0.5, fvals * 100, push_fused.SENTINEL_F32)
        ivals = (fvals * 1e6).to(torch.int32)
        labels = torch.arange(P * K, device=dev,
                              dtype=torch.int32).reshape(P, K)
        rows = []
        for prog, combine, arrs, vals, weighted, unit in (
                ("pagerank", "add", a, fvals, False, False),
                ("pagerank_weighted", "add", a, fvals, True, False),
                ("sssp", "min", a, dist, True, False),
                ("bfs", "min", a, ivals, False, True),
                ("labelprop", "min", au, labels, False, False)):
            args = (arrs["gr_band"], arrs["gr_src_local"], arrs["gr_dst_col"],
                    arrs["gr_edge_valid"], arrs["gr_edge_weight"] if weighted
                    else None, vals, S)
            kw = dict(combine=combine, unit_weight=unit)
            what = f"{prog} on gr_band"
            got = push_fused.fused_push(*args, **kw)
            want = push_fused.fused_push_plain(*args, **kw)
            torch.cuda.synchronize()
            err = self.compare(got, want, combine, what)
            del want
            extra = (self._tiled_add_checks(args, got, what)
                     if combine == "add"
                     else self._min_paths(args, kw, got, what))
            del got
            plain_ms = self.cuda_ms(
                lambda: push_fused.fused_push_plain(*args, **kw), 3)
            bound_ms, nbytes, ops = self._bound(arrs, vals, S, weighted,
                                                layout="gr")
            rows.append({"program": prog, "kernel": f"fused_push_{combine}",
                         "ms": extra.pop("tiled_ms"), "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bytes": nbytes,
                         "operations": ops, "max_abs_err": err, **extra})
        for kern, prog in (("fused_push_add", "pagerank_weighted"),
                           ("fused_push_min", "sssp")):
            r = next(r for r in rows if r["program"] == prog)
            self.kernel_rows[f"{kern}/grid"] = {
                "name": f"{kern}/grid", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_fused.cu",
                "replaces": ("src/repro/kernels/push_fused.py:54"
                             if kern.endswith("add") else
                             "src/repro/kernels/push_fused.py:104"),
                "launches": self.grid_launches[kern],
                "max_abs_err": max(x["max_abs_err"] for x in rows
                                   if x["kernel"] == kern),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "timed_call": f"{prog}/gr_band",
                "layout": "gr_band, grid(2,4), 8 rectangles",
                "atomic_ms": r["atomic_ms"],
                "path": ("tiled (tile pass + merge pass)"
                         if kern.endswith("add") else r["path"])}
        return rows

    def _grid_turns(self, eng, engu):
        """Program seconds under grid(2,4) against the main path's
        sortdest at C=1, warm, in turns (grid, sortdest, sortdest, grid),
        the better of each."""
        out = []
        for prog in self.PROGRAMS:
            g = engu if prog == "labelprop" else eng
            sd = self.engines[prog]
            run_g, run_s = (lambda: g.run(prog)), (lambda: sd.run(prog))
            g1, s1 = self._timed(run_g), self._timed(run_s)
            s2, g2 = self._timed(run_s), self._timed(run_g)
            out.append({"program": prog, "grid_s": min(g1, g2),
                        "sortdest_c1_s": min(s1, s2),
                        "ratio": min(g1, g2) / min(s1, s2),
                        "turns_s": {"grid": [g1, g2], "sortdest": [s1, s2]}})
        return out

    def _grid_where(self, eng):
        """Where a grid run's time goes, beside the main path's C=1 run:
        device time by kernel and the busy share over one pagerank and one
        bfs run (torch.profiler), and the host seconds of the initial state
        -- built on the host and uploaded, as ``Engine.run`` does, over the
        grid's replicated ``[8, K]`` plane against C=1's ``[1, V]``."""
        import torch

        from repro_torch.core import programs as P

        out = {}
        for prog in ("pagerank", "bfs"):
            init = {}
            for label, e in (("grid", eng), ("sortdest_c1",
                                              self.engines[prog])):
                program = P.make_program(prog)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                torch.from_numpy(program.init(e.pg)).to(e.device)
                torch.cuda.synchronize()
                init[label] = time.perf_counter() - t0
            out[prog] = {"profile": self._device_profile(
                lambda: eng.run(prog)), "init_upload_s": init}
        return out

    def _grid_chares(self):
        """The chare-axis graph under grid(2,2), grid(4,2) and grid(1,2):
        the five programs against the serial references."""
        from repro_torch.core import Engine
        from repro_torch.core import graph as G

        g, gw, gu, _, _ = self._chare_graphs()
        out = []
        for R, C in ((2, 2), (4, 2), (1, 2)):
            name = f"grid({R},{C})"
            eng = Engine(G.partition(gw, R * C, name))
            engu = Engine(G.partition(gu, R * C, name))
            for prog in self.PROGRAMS:
                e, graph = (engu, gu) if prog == "labelprop" else (eng, gw)
                row = self._check_program(e, prog, graph, R * C, "chares",
                                          labelprop_iters=True)
                row.update(shape=[R, C], path=self._grid_path(e))
                out.append(row)
        return out

    # -- the COST tables ------------------------------------------------------

    def cost(self):
        """The paper's COST tables: ``run_table`` for every registered
        program on the three paper stand-ins at ``--cost-scale``, with the
        contiguous and edge-balanced placements (the reference's full run),
        then the ``cost.*``, ``fig12.*`` and ``grid.*`` rows; a wrong result
        fails the phase."""
        from repro_torch.benchmarks import run as brun
        from repro_torch.benchmarks import tables
        from repro_torch.configs.graphs import GRAPHS
        from repro_torch.core import registered_names

        scale = self.args.cost_scale
        partitioners = ("contiguous", "edge_balanced")
        lines, verdicts, elapsed = [], {}, {}
        for algo in registered_names():
            rows = []
            for gname in GRAPHS:
                t0 = time.perf_counter()
                rows += tables.run_table(algo, scale_log2=scale, repeats=3,
                                         partitioners=partitioners,
                                         graphs=(gname,))
                elapsed[f"{algo}/{gname}"] = time.perf_counter() - t0
            out, verdicts[algo] = brun.table_rows(algo, rows)
            lines += out
        t0 = time.perf_counter()
        grid_lines, grid_json = brun.grid_rows(
            tables.grid_table(scale_log2=scale))
        lines += grid_lines
        per_graph = {g: sum(t for k, t in elapsed.items()
                            if k.endswith(f"/{g}")) for g in GRAPHS}
        return {"scale": scale, "partitioners": partitioners,
                "graph_elapsed_s": per_graph,
                "program_graph_elapsed_s": elapsed,
                "grid_table_s": time.perf_counter() - t0,
                "verdicts": verdicts, "grid": grid_json,
                "rows": [",".join(str(x) for x in line) for line in lines]}

    def staged_main(self):
        """The main path's graphs and programs through the staged pair:
        ``basic`` (pairwise layout, gather kernel on the send side, scatter
        kernel on the receive side) and ``sortdest`` with ``push_fn=None``
        (gather kernel, torch edge transform, scatter kernel)."""
        import torch

        from repro_torch.core import Engine
        from repro_torch.kernels import push_fused

        t0 = time.perf_counter()
        engines = {
            "basic": (Engine(self.pgw, "basic"), Engine(self.pgu, "basic")),
            "sortdest/push_fn=None": (
                Engine(self.pgw, "sortdest", push_fn=None),
                Engine(self.pgu, "sortdest", push_fn=None)),
        }
        setup_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        rows = []
        push_fused.reset_launch_counts()
        for how, (ew, eu) in engines.items():
            for name in ("pagerank", "pagerank_weighted", "sssp", "bfs",
                         "labelprop"):
                e, graph = (eu, self.gu) if name == "labelprop" \
                    else (ew, self.gw)
                row = self._check_program(e, name, graph, 1, "main")
                row.update(engine=how, choice=e.dispatch["choice"])
                rows.append(row)
        self.staged_launches = dict(push_fused.launch_counts)
        for k in ("gather_sum", "scatter_sum", "gather_min", "scatter_min"):
            if self.staged_launches[k] == 0:
                raise AssertionError(f"{k} was not launched on the staged "
                                     "main path")
        for k in ("fused_push_add", "fused_push_min"):
            if self.staged_launches[k]:
                raise AssertionError(f"{k} launched on the staged main path")
        self.staged_engines = engines
        return {"programs": rows, "launches": self.staged_launches,
                "pairwise_pair_max": int(
                    engines["basic"][0].arrays["pb_valid"].shape[-1]),
                "engine_setup_s": round(setup_s, 3),
                "peak_device_bytes": torch.cuda.max_memory_allocated()}

    def profile(self):
        """Device time by kernel over one run each of pagerank and bfs on the
        main path and on the staged path (basic pagerank, push_fn=None bfs)
        (torch.profiler, CUDA activity), and the device's busy share of the
        run's wall time.  Kernels and copies run on one stream, so their
        summed time is the time the device was busy."""
        out = {}
        runs = (("pagerank", "pagerank", self.engines["pagerank"]),
                ("bfs", "bfs", self.engines["bfs"]),
                ("pagerank/basic", "pagerank",
                 self.staged_engines["basic"][0]),
                ("bfs/push_fn=None", "bfs",
                 self.staged_engines["sortdest/push_fn=None"][0]))
        for label, name, eng in runs:
            eng.run(name)  # warm
            out[label] = self._device_profile(lambda: eng.run(name))
        return out

    # -- phase lm -----------------------------------------------------------

    def lm(self, smoke=False, R=8, P=64, G=512, mid=300):
        """The LM serving path at full width; see the module docstring.
        gemma3-1b serves ``R`` requests, prompts of ``P`` tokens, ``G``
        generated, logits also read at position ``mid``; then xlstm-350m,
        jamba-1.5-large cut to 4 layers, and llama4-scout and kimi-k2 at
        their smoke configs.  A rehearsal passes ``smoke=True`` (every
        architecture at its smoke config) and smaller sizes."""
        parts = (("gemma3-1b", lambda: self._lm_dense(smoke, R, P, G, mid)),
                 ("xlstm-350m", lambda: self._lm_xlstm(smoke)),
                 ("jamba-1.5-large-398b/4L", lambda: self._lm_jamba(smoke)),
                 ("moe_smoke", self._lm_moe_smoke))
        seconds = {}
        for name, run in parts:  # one line each, as each ends
            t0 = time.perf_counter()
            emit({"lm": name, **json.loads(json.dumps(run(), default=str))})
            seconds[name] = round(time.perf_counter() - t0, 3)
        return {"lm_seconds": seconds}

    @staticmethod
    def _agree(got, want, where):
        """The bound of tests/test_serve.py:33 (max |err| within 1e-2 of
        max |ref|), and the same 1e-2 on each row's RMS error against its
        RMS (rows along the last axis): one outlier logit (the input
        token's own, about 1,190 under gemma3's tied embeddings) sets the
        max, the RMS is the scale of the row.  A row that is zero in
        ``want`` (a token whose every slot was dropped) must be zero in
        ``got``."""
        import torch

        got, want = got.float(), want.float().to(got.device)
        err = (got - want).abs()
        rel = float(err.max() / want.abs().max())
        err_rms, want_rms = (t.square().mean(-1).sqrt() for t in (err, want))
        rms = float(torch.where(want_rms > 0, err_rms / want_rms,
                                err_rms * float("inf")).nan_to_num(0.0)
                    .max())
        if not (rel < 1e-2 and rms < 1e-2):
            raise AssertionError(f"{where}: max |err| {rel} of max |ref|, "
                                 f"RMS error {rms} of the RMS")
        return {"max_abs_err": float(err.max()),
                "max_abs": float(want.abs().max()),
                "rms_ref": float(want.square().mean(-1).sqrt().min()),
                "rel": rel, "rms_rel": rms}

    @staticmethod
    def _on_cpu(tree):
        """A copy of a tree of tensors (dicts, lists) on the CPU."""
        if isinstance(tree, dict):
            return {k: Smoke._on_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [Smoke._on_cpu(v) for v in tree]
        return tree.to("cpu", copy=True)

    @staticmethod
    def _patched(module, name, wrap):
        """A context in which ``module.name`` is ``wrap(original)``."""
        import contextlib

        @contextlib.contextmanager
        def opened():
            original = getattr(module, name)
            setattr(module, name, wrap(original))
            try:
                yield
            finally:
                setattr(module, name, original)

        return opened()

    @staticmethod
    def _route_margins(margins):
        """Record, while open, each call of the port's router: every
        token's margin between its k-th and (k+1)-th gate.  Two paths
        that reach a router by different bf16 sums may route a token
        whose margin is that small either way."""
        import torch

        from repro_torch.models import moe as MOE

        def wrap(route):
            def recording(xt, router, cfg):
                got = route(xt, router, cfg)
                g = torch.sort(got[2], dim=-1, descending=True).values
                margins.append(g[:, cfg.top_k - 1] - g[:, cfg.top_k])
                return got
            return recording

        return Smoke._patched(MOE, "_route", wrap)

    @staticmethod
    def _dropped_slots(counts):
        """Record, while open, each MoE dispatch's (slots, dropped slots)."""
        from repro_torch.models import moe as MOE

        def wrap(plan):
            def recording(e_ids, num_buckets, C):
                got = plan(e_ids, num_buckets, C)
                counts.append((e_ids.numel(), int((~got[1]).sum())))
                return got
            return recording

        return Smoke._patched(MOE, "dispatch_plan", wrap)

    @staticmethod
    def _host_syncs(fn):
        """The host syncs one call of ``fn`` makes (torch.cuda's sync debug
        mode warns once for each synchronizing op), by the line of the
        port that made each."""
        import warnings

        import torch

        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        where = [f"{pathlib.Path(w.filename).name}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]
        return {"count": len(where),
                "by_line": {k: where.count(k) for k in sorted(set(where))}}

    def _lm_model(self, cfg, dev):
        """Parameters from init_params on the card (seed 0): (params,
        seconds, count, bytes).  The count must equal that of
        abstract_params, whose leaves the CPU tests hold equal to the
        reference's leaf by leaf."""
        import torch

        from repro_torch.checkpoint.store import _leaves
        from repro_torch.models import model as M

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = [t for _, t in _leaves(params)]
        n = sum(t.numel() for t in leaves)
        want = sum(t.numel() for _, t in _leaves(M.abstract_params(cfg)))
        if n != want:
            raise AssertionError(f"{cfg.name}: {n} parameters, "
                                 f"abstract_params has {want}")
        return params, init_s, n, sum(t.numel() * t.element_size()
                                      for t in leaves)

    def _lm_serve(self, cfg, params, R, P, G, param_bytes, first_steps=16):
        """Greedy serving, timed: BatchedServer with ``R`` requests,
        prompts of ``P`` tokens (np.random.default_rng(0)) and ``G``
        generated; the prefill, then ``first_steps`` untimed decode steps
        and the rest in one call (host clock; decode ends in its copy of
        the tokens to the host); the device profile of 4 more steps, the
        host syncs of one, and (with MoE) the slots 16 more drop.  The
        step's bound: the parameters read once and the recurrent states
        read and written, at 3.35 TB/s (and the attention caches read once
        beside it).  Returns (metrics, tokens [R, P + G + 1], server)."""
        import numpy as np
        import torch

        from repro_torch.launch import serve as S

        server = S.BatchedServer(cfg, params, R, P + G + 1)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (R, P), dtype=np.int32)
        nbytes = lambda t: t.numel() * t.element_size()
        kv_bytes = sum(nbytes(c[k]) for c in server.cache.values()
                       for k in c if k in ("k", "v"))
        state_bytes = sum(nbytes(c[k]) for c in server.cache.values()
                          for k in c if k not in ("k", "v"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first = server.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        toks = [prompts, first.cpu().numpy(), server.decode(first_steps)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks.append(server.decode(G - first_steps))
        decode_s = time.perf_counter() - t0
        steps = G - first_steps
        seq = np.concatenate(toks, axis=1)  # [R, P + G + 1]
        if seq.shape != (R, P + G + 1) or server.pos != P + G or \
                seq.min() < 0 or seq.max() >= cfg.vocab_size:
            raise AssertionError(f"{cfg.name}: tokens {seq.shape}, pos "
                                 f"{server.pos}")
        profile = self._device_profile(lambda: server.decode(4))
        syncs = self._host_syncs(lambda: server.decode(1))
        drops = []
        if cfg.num_experts:  # the published capacity's drops in decode
            with self._dropped_slots(drops):
                server.decode(16)
        bound = (param_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3
        return {
            "requests": R, "prompt_len": P, "generated": G,
            "cache_bytes": kv_bytes + state_bytes,
            "recurrent_state_bytes": state_bytes,
            "prefill_s": prefill_s, "prefill_tok_per_s": R * P / prefill_s,
            "decode_timed_steps": steps, "decode_s": decode_s,
            "decode_ms_per_step": decode_s / steps * 1e3,
            "decode_tok_per_s": R * steps / decode_s,
            "decode_bound_ms": bound,
            "decode_bound_with_cache_ms":
                bound + kv_bytes / HBM_BYTES_PER_S * 1e3,
            "decode_profile_4_steps": profile,
            "kernels_per_step": profile["device_ops"] / 4,
            "host_syncs_one_step": syncs,
            "decode_16_steps_slots_dropped": [sum(n for n, _ in drops),
                                              sum(d for _, d in drops)],
            "sample_tokens": seq[0, P:P + 10].tolist()}, seq, server

    @staticmethod
    def _teacher_forced(cfg, params, stream, marks, max_len, keep_at=None,
                        next_steps=0, margins=None):
        """decode_step over every position of ``stream`` [B, T] from an
        empty cache: the logits at ``marks``; where ``keep_at`` is given, a
        CPU copy of the cache after that position and the logits of the
        ``next_steps`` steps after it (on the CPU).  ``margins``, a dict,
        gets each step's routing margins: the smallest over the MoE layers
        for each row ([B], see ``_route_margins``)."""
        import contextlib

        import torch

        from repro_torch.models import model as M

        cache = M.init_cache(cfg, stream.shape[0], max_len, stream.device)
        logits, kept, after, record = {}, None, [], []
        recording = (contextlib.nullcontext() if margins is None
                     else Smoke._route_margins(record))
        with torch.no_grad(), recording:
            for t in range(stream.shape[1]):
                record.clear()
                lg, cache = M.decode_step(params, stream[:, t:t + 1], t,
                                          cache, cfg)
                if margins is not None:
                    margins[t] = torch.stack(record).min(0).values
                if t in marks:
                    logits[t] = lg[:, 0].clone()
                if t == keep_at:
                    kept = Smoke._on_cpu(cache)
                if keep_at is not None and keep_at < t <= keep_at + next_steps:
                    after.append(lg[:, 0].cpu())
        return logits, kept, after

    def _lm_dense(self, smoke, R, P, G, mid):
        """gemma3-1b at full width (the module docstring's first item)."""
        import contextlib
        import io

        import numpy as np
        import torch

        from repro_torch import configs
        from repro_torch.launch import serve as S
        from repro_torch.models import model as M

        arch = "gemma3-1b"
        cfg = (configs.smoke_config if smoke else configs.get_config)(arch)
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, init_s, n_params, param_bytes = self._lm_model(cfg, dev)
        # the config's count leaves out the final norm's d_model scales
        if n_params - cfg.d_model != cfg.param_count():
            raise AssertionError(f"{n_params - cfg.d_model} parameters "
                                 f"outside the final norm, the config "
                                 f"counts {cfg.param_count()}")
        first_steps = 16
        marks = (P - 1, mid, P + G - 1)  # 63, 300, 575
        serving, _, server = self._lm_serve(cfg, params, R, P, G,
                                            param_bytes, first_steps)
        ring = tuple(server.cache["slot00"]["k"].shape)
        full = tuple(server.cache["slot05"]["k"].shape)
        if ring[2] != cfg.window or full[2] != P + G + 1:
            raise AssertionError(f"caches {ring} (local) and {full} (global)")
        decode_peak = torch.cuda.max_memory_allocated() - base
        del server

        # teacher-forced decode of a seeded random stream (with random
        # weights and tied embeddings, greedy decode repeats one token, so
        # its wrapped ring would hold identical tokens): every ring slot
        # holds a distinct token when the ring wraps at position 512
        rng = np.random.default_rng(0)
        rng.integers(0, cfg.vocab_size, (R, P), dtype=np.int32)  # prompts
        stream = torch.as_tensor(rng.integers(
            0, cfg.vocab_size, (R, P + G), dtype=np.int32), device=dev)
        logits, prefilled, step_logits = self._teacher_forced(
            cfg, params, stream, marks, P + G + 1, keep_at=P - 1,
            next_steps=first_steps)

        # teacher-forced forward over the same stream
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fwd, _ = M.forward(params, {"tokens": stream}, cfg)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        vs_forward = {str(m): self._agree(logits[m], fwd[:, m],
                                          f"decode logits at {m}")
                      for m in marks}
        del fwd

        # the same parameters on the CPU, from the stream's cache at
        # position 63, for the next 16 decode steps
        t0 = time.perf_counter()
        cpu, cache, cpu_stream, vs_cpu = self._on_cpu(params), prefilled, \
            stream.cpu(), []
        with torch.no_grad():
            for t in range(P, P + first_steps):
                lg, cache = M.decode_step(cpu, cpu_stream[:, t:t + 1], t,
                                          cache, cfg)
                vs_cpu.append(self._agree(step_logits[t - P], lg[:, 0],
                                          f"position {t}, card against CPU"))
        cpu_s = time.perf_counter() - t0
        del cpu, cache, params, logits, step_logits, stream
        torch.cuda.empty_cache()

        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli = S.main(["--arch", arch, "--requests", str(R),
                          "--prompt-len", "16", "--gen", "16"]
                         + ["--smoke"] * smoke)
        lines = out.getvalue().splitlines()
        print("\n".join(lines), flush=True)
        if len(lines) != 2 or \
                not lines[0].startswith(f"[serve] {R} reqs") or \
                not lines[1].startswith("[serve] sample output tokens"):
            raise AssertionError(f"the CLI printed {lines}")
        return {
            "arch": cfg.name, "parameters": n_params,
            "parameter_bytes": param_bytes,
            "cache_shapes": {"local": ring, "global": full},
            "init_s": init_s, **serving,
            "forward_s": forward_s, "vs_forward": vs_forward,
            "vs_cpu_max_rel": max(r["rel"] for r in vs_cpu),
            "vs_cpu_max_rms_rel": max(r["rms_rel"] for r in vs_cpu),
            "cpu_s": cpu_s, "peak_bytes": decode_peak,
            "peak_bytes_with_forward":
                torch.cuda.max_memory_allocated() - base,
            "cli": {k: v for k, v in cli.items() if k != "tokens"},
            "nvidia_smi": self.smi}

    def _lm_xlstm(self, smoke, R=8, P=64, G=448, rows_on_cpu=2):
        """xlstm-350m at full width and depth: serving, a 512-token stream
        teacher-forced against the forward, the forward on the card
        against the CPU's (the module docstring's second item)."""
        import numpy as np
        import torch

        from repro_torch import configs
        from repro_torch.models import layers as L
        from repro_torch.models import model as M

        arch = "xlstm-350m"
        cfg = (configs.smoke_config if smoke else configs.get_config)(arch)
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, init_s, n_params, param_bytes = self._lm_model(cfg, dev)
        serving, _, server = self._lm_serve(cfg, params, R, P, G,
                                            param_bytes)
        decode_peak = torch.cuda.max_memory_allocated() - base
        del server

        # 512 = two MLSTM_CHUNKs: the mLSTM forward takes S <= 256 or a
        # multiple of 256
        T, marks = P + G, (P - 1, 300, P + G - 1)  # 63, 300, 511
        stream = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (R, T), dtype=np.int32), device=dev)
        t0 = time.perf_counter()
        logits, _, _ = self._teacher_forced(cfg, params, stream, marks,
                                            T + 1)
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            x, _ = M.backbone(params, {"tokens": stream}, cfg)
            fwd = {m: L.logits_fwd(M.head_params(params, cfg), x[:, m:m + 1],
                                     cfg.final_logit_softcap)[:, 0]
                   for m in marks}
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        vs_forward = {str(m): self._agree(logits[m], fwd[m],
                                          f"xlstm decode logits at {m}")
                      for m in marks}
        del x

        # the forward on the CPU over the stream's first rows
        t0 = time.perf_counter()
        cpu = self._on_cpu(params)
        with torch.no_grad():
            x, _ = M.backbone(cpu, {"tokens": stream[:rows_on_cpu].cpu()},
                              cfg)
            vs_cpu = {str(m): self._agree(
                fwd[m][:rows_on_cpu], L.logits_fwd(
                    M.head_params(cpu, cfg), x[:, m:m + 1],
                    cfg.final_logit_softcap)[:, 0],
                f"xlstm forward at {m}, card against CPU") for m in marks}
        cpu_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        del cpu, x, params, fwd, logits, stream
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "parameters": n_params,
                "param_count_of_config": cfg.param_count(),
                "parameter_bytes": param_bytes, "init_s": init_s, **serving,
                "stream": T, "forced_decode_s": forced_s,
                "forward_s": forward_s, "vs_forward": vs_forward,
                "cpu_rows": rows_on_cpu, "vs_cpu": vs_cpu, "cpu_s": cpu_s,
                "peak_bytes": decode_peak, "peak_bytes_with_forward": peak,
                "nvidia_smi": self.smi}

    @staticmethod
    def _moe_oracle(p, x, top_vals, top_idx, C):
        """A plain per-token MoE at capacity ``C`` on the routing given:
        slots in token-major order, each expert's arrivals counted one by
        one on the host (a slot past ``C`` is dropped), each kept slot's
        SwiGLU on its own row (a row of a product per expert); the slots'
        outputs, weighted by their normalized gates, summed in slot order.
        All in the activation dtype, as the reference states its expert
        and combine arithmetic (bf16 products, the stepwise logistic of
        ``silu``, a bf16 combine, slot 0 first): an f32 oracle sits 1.1%
        of a row's RMS from it at kimi-k2's top 8.  Returns (keep [T, k]
        bool numpy, out [T, d] in x's dtype)."""
        import numpy as np
        import torch

        from repro_torch.models.layers import silu

        T, k = top_idx.shape
        idx = top_idx.cpu().numpy()
        seen = np.zeros(int(p["router"].shape[1]), np.int64)
        keep = np.zeros((T, k), bool)
        for t in range(T):
            for j in range(k):
                keep[t, j] = seen[idx[t, j]] < C
                seen[idx[t, j]] += 1
        y = torch.zeros((T, k, x.shape[1]), dtype=x.dtype, device=x.device)
        for e in np.unique(idx[keep]):
            tok, slot = (torch.as_tensor(a, device=x.device)
                         for a in np.nonzero(keep & (idx == e)))
            rows = x[tok]
            h = silu(rows @ p["w_gate"][e]) * (rows @ p["w_in"][e])
            y[tok, slot] = h @ p["w_out"][e]
        w = (top_vals * torch.as_tensor(keep, device=x.device)).to(x.dtype)
        out = torch.zeros((T, x.shape[1]), dtype=x.dtype, device=x.device)
        for j in range(k):
            out = out + w[:, j, None] * y[:, j]
        return keep, out

    def _moe_dispatch(self, p, cfg, T, seed, distinct=None):
        """moe_fwd_dense on [1, T, d] seeded bf16 inputs (``distinct`` rows
        repeated in turn, where given: a concentrated routing that
        overflows the capacity) against ``_moe_oracle`` at the
        configuration's capacity: the keep mask bit-equal, the outputs by
        ``_agree``; the port's routing against a plain softmax and top-k
        of the same gates."""
        import numpy as np
        import torch

        from repro_torch.models import moe as MOE

        dev = p["router"].device
        g = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((distinct or T, cfg.d_model), generator=g,
                        device=dev).to(torch.bfloat16)
        x = x[torch.arange(T, device=dev) % x.shape[0]]
        C = MOE.capacity(T, cfg)
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, aux = MOE.moe_fwd_dense(p, x[None], cfg)
            torch.cuda.synchronize()
            port_s = time.perf_counter() - t0
            top_vals, top_idx, gates = MOE._route(x, p["router"], cfg)
            plain = torch.topk(torch.softmax(x.float() @ p["router"], -1),
                               cfg.top_k, dim=-1)
            srt = torch.sort(gates, -1, descending=True).values
            clear = srt[:, cfg.top_k - 1] - srt[:, cfg.top_k] > 1e-6
            if not torch.equal(torch.sort(plain.indices[clear], -1).values,
                               torch.sort(top_idx[clear], -1).values):
                raise AssertionError(f"{cfg.name} T={T}: routing differs "
                                     "from softmax + top-k")
            _, keep, _ = MOE.dispatch_plan(top_idx.reshape(-1),
                                           cfg.num_experts, C)
            keep = keep.reshape(T, cfg.top_k).cpu().numpy()
            want_keep, want = self._moe_oracle(p, x, top_vals, top_idx, C)
        if not np.array_equal(keep, want_keep):
            raise AssertionError(f"{cfg.name} T={T}: keep masks differ in "
                                 f"{int((keep != want_keep).sum())} slots")
        return {"T": T, "distinct_rows": distinct, "capacity": C,
                "experts": cfg.num_experts,
                "top_k": cfg.top_k, "dropped_slots": int((~keep).sum()),
                "near_tie_tokens": int((~clear).sum()),
                "aux": float(aux), "port_s": port_s,
                **self._agree(out[0], want,
                              f"{cfg.name} MoE at T={T} against the oracle")}

    def _lm_jamba(self, smoke, R=8, P=64, G=128, B=4, T=320):
        """jamba-1.5-large at full width cut to 4 layers: serving at the
        published capacity, a 320-token stream teacher-forced against the
        forward at a capacity that drops nothing, the first MoE layer
        against the per-token oracle at the published capacity, the first
        mamba layer on the card against the CPU (the module docstring's
        third item)."""
        import dataclasses

        import numpy as np
        import torch

        from repro_torch import configs
        from repro_torch.models import layers as L
        from repro_torch.models import model as M
        from repro_torch.models import ssm as SSM

        arch = "jamba-1.5-large-398b"
        full = (configs.smoke_config if smoke else configs.get_config)(arch)
        # one 8-layer period holds four MoE layers of 9.66 B parameters:
        # about 90 GB in bf16, over the card's 80 GB
        cfg = dataclasses.replace(full, num_layers=4,
                                  layer_pattern=full.layer_pattern[:4])
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params, init_s, n_params, param_bytes = self._lm_model(cfg, dev)
        serving, _, server = self._lm_serve(cfg, params, R, P, G,
                                            param_bytes)
        decode_peak = torch.cuda.max_memory_allocated() - base
        del server

        # decode against the forward where neither drops a token: C > T
        nodrop = dataclasses.replace(
            cfg, capacity_factor=cfg.num_experts / cfg.top_k)
        marks = (63, 255, T - 1)  # T = 320 crosses one MAMBA_CHUNK
        stream = torch.as_tensor(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (B, T), dtype=np.int32), device=dev)
        margins = {}
        t0 = time.perf_counter()
        logits, _, _ = self._teacher_forced(nodrop, params, stream, marks,
                                            T + 1, margins=margins)
        torch.cuda.synchronize()
        forced_s = time.perf_counter() - t0
        near = sum(int((m <= 1e-3).sum()) for m in margins.values())
        t0 = time.perf_counter()
        with torch.no_grad():
            x, aux = M.backbone(params, {"tokens": stream}, nodrop)
            fwd = {m: L.logits_fwd(M.head_params(params, cfg), x[:, m:m + 1],
                                     cfg.final_logit_softcap)[:, 0]
                   for m in marks}
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        del x
        vs_forward = {}
        for m in marks:
            clear = margins[m] > 1e-3  # the margin rule at the mark
            if not bool(clear.any()):
                raise AssertionError(f"jamba at {m}: every row near a tie")
            vs_forward[str(m)] = {"rows": int(clear.sum()), **self._agree(
                logits[m][clear], fwd[m][clear],
                f"jamba decode logits at {m}")}
        del logits, fwd, stream

        # the dispatch at the published capacity: the first MoE layer
        moe = params["layers"][1]["moe"]
        dispatch = [self._moe_dispatch(moe, cfg, n, seed, distinct)
                    for n, seed, distinct in ((8, 3, None), (2048, 4, None),
                                              (8, 9, 2), (2048, 10, 64))]

        # the first mamba layer alone, on the card against the CPU
        pm = params["layers"][0]["mamba"]
        pc = self._on_cpu(pm)
        g = torch.Generator(device=dev).manual_seed(5)
        xm = torch.randn((2, 80, cfg.d_model), generator=g, device=dev).to(
            torch.bfloat16)
        xc = xm.cpu()
        t0 = time.perf_counter()
        with torch.no_grad():
            yg, cg = SSM.mamba_fwd(pm, xm[:, :64], cfg, want_cache=True)
            yc, cc = SSM.mamba_fwd(pc, xc[:, :64], cfg, want_cache=True)
            # a state's rows: one sequence's [di, N] each
            mamba = {"forward": self._agree(yg, yc, "mamba forward, card "
                                            "against CPU"),
                     "state": self._agree(cg["ssm"].flatten(1),
                                          cc["ssm"].flatten(1), "mamba "
                                          "state, card against CPU")}
            steps = []
            for t in range(64, 80):
                og, cg = SSM.mamba_decode(pm, xm[:, t:t + 1], cg, cfg)
                oc, cc = SSM.mamba_decode(pc, xc[:, t:t + 1], cc, cfg)
                steps.append(self._agree(og, oc, f"mamba decode step {t}, "
                                         "card against CPU"))
        mamba["decode_max_rel"] = max(s["rel"] for s in steps)
        mamba["decode_max_rms_rel"] = max(s["rms_rel"] for s in steps)
        mamba["final_state"] = self._agree(cg["ssm"].flatten(1),
                                           cc["ssm"].flatten(1),
                                           "mamba state after 16 steps")
        mamba["cpu_s"] = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        del params, moe, pm, pc, cg, cc
        torch.cuda.empty_cache()
        return {"arch": cfg.name, "layers": cfg.num_layers,
                "layer_pattern": cfg.layer_pattern, "parameters": n_params,
                "parameter_bytes": param_bytes, "init_s": init_s,
                "capacity_factor": cfg.capacity_factor, **serving,
                "stream": T, "stream_rows": B, "forced_decode_s": forced_s,
                "forward_s": forward_s, "forward_aux": float(aux),
                "near_tie_routings_in_stream": near,
                "vs_forward": vs_forward, "dispatch": dispatch,
                "mamba_layer_vs_cpu": mamba, "peak_bytes": decode_peak,
                "peak_bytes_with_forward": peak, "nvidia_smi": self.smi}

    def _lm_moe_smoke(self, R=8, P=16, G=8):
        """llama4-scout and kimi-k2 at their smoke configs on the card:
        BatchedServer, then the served tokens teacher-forced through
        decode_step on the card and on the CPU, each step within
        ``_agree`` on the rows whose routing is clear; and the dispatch at
        kimi-k2's 384 experts, top 8, at smoke width against the oracle."""
        import dataclasses

        import torch

        from repro_torch import configs
        from repro_torch.models import model as M
        from repro_torch.models import moe as MOE

        dev = torch.device("cuda")
        out = {}
        for arch in ("llama4-scout-17b-a16e", "kimi-k2-1t-a32b"):
            cfg = configs.smoke_config(arch)
            params, _, n_params, param_bytes = self._lm_model(cfg, dev)
            serving, seq, server = self._lm_serve(cfg, params, R, P, G,
                                                  param_bytes, first_steps=2)
            del server
            stream = torch.as_tensor(seq[:, :P + G], device=dev)
            cpu, cpu_stream = self._on_cpu(params), stream.cpu()
            cache = M.init_cache(cfg, R, P + G + 1, dev)
            ccache = M.init_cache(cfg, R, P + G + 1, "cpu")
            rows, worst = 0, {"rel": 0.0, "rms_rel": 0.0}
            margins = []
            with torch.no_grad():
                for t in range(P + G):
                    margins.clear()
                    with self._route_margins(margins):
                        lg, cache = M.decode_step(params, stream[:, t:t + 1],
                                                  t, cache, cfg)
                    lc, ccache = M.decode_step(cpu, cpu_stream[:, t:t + 1],
                                               t, ccache, cfg)
                    clear = torch.stack(margins).min(0).values > 1e-3
                    if bool(clear.any()):
                        got = self._agree(lg[clear, 0], lc[clear.cpu(), 0],
                                          f"{arch} step {t}, card against "
                                          "CPU")
                        worst = {k: max(worst[k], got[k]) for k in worst}
                    rows += int(clear.sum())
            if rows < (P + G) * R // 2:
                raise AssertionError(f"{arch}: {rows} clear rows")
            out[arch] = {"arch": cfg.name, "parameters": n_params,
                         **serving, "vs_cpu_rows": rows,
                         "vs_cpu_max_rel": worst["rel"],
                         "vs_cpu_max_rms_rel": worst["rms_rel"]}
            del params, cpu, cache, ccache
        kimi = configs.smoke_config("kimi-k2-1t-a32b")
        wide = dataclasses.replace(kimi, num_experts=384, top_k=8)
        p = MOE.init_moe(wide, torch.Generator(device=dev).manual_seed(6),
                         dev)
        out["dispatch_384x8"] = [self._moe_dispatch(p, wide, n, seed)
                                 for n, seed in ((8, 7), (2048, 8))]
        torch.cuda.empty_cache()
        return out

    @staticmethod
    def _device_profile(fn):
        """Device time by kernel over one call of ``fn`` (torch.profiler,
        CUDA activity) and the device's busy share of its wall time.
        Kernels and copies run on one stream, so their summed time is the
        time the device was busy."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA),
                      key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "device_ops": sum(r[2] for r in rows),
                "device_busy_share": busy_ms / wall_ms if busy_ms else None,
                "by_kernel": [{"name": k[:90], "device_ms": ms, "calls": n}
                              for k, ms, n in rows[:10]]}

    # -- phase train ---------------------------------------------------------

    def train(self, smoke=False, B=8, S=1024, steps=16):
        """The training path; see the module docstring.  gemma3-1b at full
        width and depth trains ``steps`` steps at ``B`` x ``S``, then every
        architecture's smoke config takes one step on the card against the
        CPU.  A rehearsal passes ``smoke=True`` (gemma3's smoke config) and
        smaller sizes."""
        seconds = {}
        for name, run in (("gemma3-1b",
                           lambda: self._train_gemma(smoke, B, S, steps)),
                          ("smoke_archs", self._train_smoke_archs)):
            t0 = time.perf_counter()
            emit({"train": name, **json.loads(json.dumps(run(), default=str))})
            seconds[name] = round(time.perf_counter() - t0, 3)
        return {"train_seconds": seconds}

    @staticmethod
    def _train_bound(cfg, B, S, state_bytes):
        """The least time a train step could take on the card: the larger
        of its FLOPs over the dense bf16 peak and its bytes over the HBM
        rate.  FLOPs: every product's forward (2 x its weights x tokens;
        the tied head's V x d too) and the attention scores and values
        over the keys each query sees (causal, the window on local
        layers), times 3 for the backward; no recompute.  Bytes: the
        state read once and written once (parameters and both moments;
        the batch is noise)."""
        d, hd, H, KV = cfg.d_model, cfg.hd, cfg.num_heads, cfg.num_kv_heads
        mixers = [m for m, _ in cfg.layer_pattern] * cfg.repeats + \
            [m for m, _ in cfg.tail_pattern]
        if set(mixers) - {"attn", "local"} or cfg.num_experts:
            raise ValueError("the bound counts dense attention models")
        proj = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * cfg.d_ff
        weights = len(mixers) * proj + cfg.vocab_size * d
        keys = 0
        for m in mixers:
            w = cfg.window if m == "local" and cfg.window else S
            keys += sum(min(i + 1, w) for i in range(S))
        fwd = 2 * weights * B * S + 4 * B * keys * H * hd
        flops = 3 * fwd
        byts = 2 * state_bytes
        ms = max(flops / BF16_OPS_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        return {"flops": flops, "bytes": byts, "bound_ms": ms,
                "bound_by": "operations" if flops / BF16_OPS_PER_S
                > byts / HBM_BYTES_PER_S else "bytes"}

    def _train_gemma(self, smoke, B, S, steps):
        """gemma3-1b at full width and depth (the module docstring)."""
        import dataclasses
        import shutil

        import torch

        from repro_torch import configs
        from repro_torch.checkpoint import AsyncCheckpointer
        from repro_torch.checkpoint.store import _leaves
        from repro_torch.data import SyntheticLM
        from repro_torch.launch import train as LT
        from repro_torch.models import train as T

        cfg = (configs.smoke_config if smoke else configs.get_config)(
            "gemma3-1b")
        dev = torch.device("cuda")
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()  # by the earlier phases
        opt = T.make_optimizer(peak_lr=1e-3, warmup=2, total=steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = T.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             opt, dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        leaves = [t for _, t in _leaves(state)]
        state_bytes = sum(t.numel() * t.element_size() for t in leaves)
        n_params = sum(t.numel() for _, t in _leaves(state.params))
        if n_params - cfg.d_model != cfg.param_count():
            raise AssertionError(f"{n_params} parameters; the config counts "
                                 f"{cfg.param_count()} and the final norm")

        # the data: every batch of the run, drawn on the card and timed
        pipe = SyntheticLM(cfg.vocab_size, B, S, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batches = [pipe.batch_at(s) for s in range(steps)]
        torch.cuda.synchronize()
        data_ms = (time.perf_counter() - t0) * 1e3 / steps
        again = pipe.batch_at(steps // 2)["tokens"]
        if not torch.equal(again, batches[steps // 2]["tokens"]):
            raise AssertionError("batch_at is not a function of the step")

        # the straight run, a checkpoint at its half
        step_fn = T.make_train_step(cfg, opt)
        ckdir = ROOT / "build" / "train_ckpt"  # git ignores build/
        shutil.rmtree(ckdir, ignore_errors=True)
        ckpt = AsyncCheckpointer(str(ckdir))
        half = steps // 2
        losses, norms, step_s = [], [], []
        torch.cuda.reset_peak_memory_stats()
        for s in range(steps):
            t0 = time.perf_counter()
            state, m = step_fn(state, batches[s])
            losses.append(m["loss"].item())
            step_s.append(time.perf_counter() - t0)
            norms.append(float(m["grad_norm"]))
            if s + 1 == half:
                t0 = time.perf_counter()
                ckpt.save(half, state)  # the host snapshot, then a thread
                snapshot_s = time.perf_counter() - t0
                # a host copy to hold the restore to (on the card it would
                # cost the steps after it 10 GB)
                saved = [t.to("cpu", copy=True) for _, t in _leaves(state)]
        t0 = time.perf_counter()
        ckpt.wait()
        wait_s = time.perf_counter() - t0
        if not all(map(math.isfinite, losses + norms)):
            raise AssertionError(f"losses {losses}, norms {norms}")
        first, last = (sum(losses[:4]) / 4, sum(losses[-4:]) / 4)
        if not last < first:
            raise AssertionError(f"the loss did not fall: {losses}")
        ck_bytes = sum(f.stat().st_size for f in
                       (ckdir / f"step_{half:08d}").iterdir())
        emit({"train_progress": "straight run", "losses": losses,
              "step_ms": [x * 1e3 for x in step_s], "data_ms": data_ms,
              "checkpoint_bytes": ck_bytes, "snapshot_s": snapshot_s,
              "write_left_s": wait_s, "held_before_bytes": held,
              "peak_bytes": torch.cuda.max_memory_allocated()})
        del state

        # the resume: restore the half's checkpoint into a fresh state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored, at = LT.restore_state(str(ckdir), cfg, opt, dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if at != half or int(restored.step) != half:
            raise AssertionError(f"restored step {at} / {restored.step}")
        for (path, a), b in zip(_leaves(restored), saved):
            if a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"restored leaf {path} differs")
        del saved
        shutil.rmtree(ckdir, ignore_errors=True)

        # microbatches=2 against 1 from the restored state, on the next batch
        s1, m1 = step_fn(restored, batches[half])
        s2, m2 = T.make_train_step(cfg, opt, microbatches=2)(
            restored, batches[half])
        mb_loss = abs(float(m2["loss"]) - float(m1["loss"])) / \
            abs(float(m1["loss"]))
        mb_err = 0.0
        for (path, a), (_, b) in zip(_leaves(s1.params), _leaves(s2.params)):
            # tests/test_train.py:41: rtol 1e-2, atol 2e-3
            if not torch.allclose(a.float(), b.float(), rtol=1e-2, atol=2e-3):
                raise AssertionError(f"microbatches 2 against 1: {path}")
            mb_err = max(mb_err, float((a.float() - b.float()).abs().max()))
        if mb_loss > 1e-4:
            raise AssertionError(f"microbatch loss {m2['loss']} vs "
                                 f"{m1['loss']}")
        del s2, restored

        # the resumed run against the straight one, steps half+1 .. half+4
        resumed, state = [float(m1["loss"])], s1
        del s1
        for s in range(half + 1, half + 4):
            state, m = step_fn(state, batches[s])
            resumed.append(m["loss"].item())
        resume_rel = max(abs(a - b) / abs(b) for a, b in
                         zip(resumed, losses[half:half + 4]))
        emit({"train_progress": "resumed", "restore_s": restore_s,
              "resumed": resumed, "microbatch_loss_rel": mb_loss,
              "microbatch_max_abs": mb_err})
        if resume_rel > 1e-3:
            raise AssertionError(f"resumed {resumed} against "
                                 f"{losses[half:half + 4]}")

        # two steps under the profiler; then one step's peak memory with
        # remat "dots" and "none" from the same state and batch
        def two_steps():
            st = state
            for s in (0, 1):
                st, mm = step_fn(st, batches[s])
                mm["loss"].item()

        profile = self._device_profile(two_steps)
        emit({"train_progress": "profiled", "kernels_per_step":
              profile["device_ops"] / 2,
              "busy_share": profile["device_busy_share"]})
        # the gradient's peak above the state (the optimizer's new state
        # comes after the activations are freed): "dots" at B, then both
        # on the batch's first B/2 rows ("none" at B=8 needs more than the
        # card holds beside the state)
        small = {k: v[:B // 2] for k, v in batches[0].items()}
        peaks, remat_loss = {}, {}
        for remat, batch in (("dots", batches[0]), ("dots", small),
                             ("none", small)):
            key = f"{remat}_B{batch['tokens'].shape[0]}"
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            mm, grads = T.value_and_grad(
                state.params, batch, dataclasses.replace(cfg, remat=remat))
            remat_loss[key] = mm["loss"].item()
            peaks[key] = torch.cuda.max_memory_allocated() - before
            del mm, grads
            emit({"train_progress": f"remat {key}", "peak_bytes": peaks[key]})
        half_b = f"_B{B // 2}"
        if remat_loss["dots" + half_b] != remat_loss["none" + half_b]:
            raise AssertionError(f"remat changed the loss: {remat_loss}")
        del state
        torch.cuda.empty_cache()

        # the user's entry point, two steps at the same size
        t0 = time.perf_counter()
        loop = LT.train_loop(cfg, steps=2, batch=B, seq=S, log_every=1,
                             peak_lr=1e-3)
        loop_s = time.perf_counter() - t0
        if not all(map(math.isfinite, loop["history"])):
            raise AssertionError(f"train_loop: {loop['history']}")
        torch.cuda.empty_cache()

        warm = sorted(step_s[2:])
        step_ms = warm[len(warm) // 2] * 1e3
        bound = self._train_bound(cfg, B, S, state_bytes)
        return {
            "arch": cfg.name, "B": B, "S": S, "steps": steps,
            "parameters": n_params, "state_bytes": state_bytes,
            "init_s": init_s, "losses": losses, "grad_norms": norms,
            "loss_first4_mean": first, "loss_last4_mean": last,
            "step_ms": [s * 1e3 for s in step_s],
            "step_ms_median_warm": step_ms,
            "tokens_per_s": B * S / (step_ms / 1e3),
            "data_ms_per_batch": data_ms,
            "kernels_per_step": profile["device_ops"] / 2,
            "busy_share": profile["device_busy_share"],
            "profile_2_steps": profile,
            "peak_bytes_gradient": peaks,
            "checkpoint": {"bytes": ck_bytes, "snapshot_s": snapshot_s,
                           "write_left_after_run_s": wait_s,
                           "restore_s": restore_s},
            "resumed_losses": resumed, "resume_max_rel": resume_rel,
            "microbatch_loss_rel": mb_loss, "microbatch_max_abs": mb_err,
            "remat_losses": remat_loss,
            "train_loop": {"history": loop["history"], "seconds": loop_s},
            **bound, "step_over_bound": step_ms / bound["bound_ms"],
            "nvidia_smi": self.smi}

    @staticmethod
    def _train_batch(cfg, seed, device, Bs=2, Ss=32):
        """One training batch of the model's contract from a numpy seed (the
        CPU tests' make_batch)."""
        import numpy as np
        import torch

        rng = np.random.default_rng(seed)
        labels = rng.integers(0, cfg.vocab_size, (Bs, Ss), dtype=np.int32)
        if cfg.frontend == "audio":
            frames = torch.as_tensor(rng.standard_normal((Bs, Ss, cfg.d_model)))
            return {"frames": frames.to(torch.bfloat16).to(device),
                    "labels": torch.as_tensor(labels, device=device)}
        toks = rng.integers(0, cfg.vocab_size, (Bs, Ss - cfg.frontend_len),
                            dtype=np.int32)
        out = {"tokens": torch.as_tensor(toks, device=device),
               "labels": torch.as_tensor(
                   toks if cfg.frontend != "vision" else labels,
                   device=device)}
        if cfg.frontend == "vision":
            out["patches"] = torch.as_tensor(rng.standard_normal(
                (Bs, cfg.frontend_len, cfg.d_model))).to(torch.bfloat16) \
                .to(device)
        return out

    @staticmethod
    def _leaf_errors(got, want):
        """Per gradient leaf, max |got - want| over max |want| (a leaf zero
        in ``want`` must be zero in ``got``)."""
        from repro_torch.checkpoint.store import _leaves

        out = {}
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            scale = float(b.abs().max())
            err = float((a.cpu().float() - b.float()).abs().max())
            out["/".join(map(str, path))] = err / scale if scale else \
                (0.0 if err == 0 else math.inf)
        return out

    def _grad_sensitivity(self, params, batch, cfg, grads, trials=2):
        """How far two bf16 evaluations of this gradient may fall apart on
        their own: the largest per-leaf change (of the leaf's max) of the
        bf16 leaves' gradients when every f32 leaf (the norm scales, in
        each layer; the SSM gates and the router) takes relative
        N(0, 2^-9) noise, half a bf16 ulp, as another card's rounding
        would move the activations they scale; the largest over
        ``trials`` draws on the CPU."""
        import torch

        from repro_torch.checkpoint.store import _leaves
        from repro_torch.models import train as T
        from repro_torch.optim.transforms import tree_map

        f32 = {"/".join(map(str, path)) for path, t in _leaves(grads)
               if t.dtype == torch.float32}
        worst = 0.0
        for trial in range(trials):
            gen = torch.Generator().manual_seed(100 + trial)
            noisy = tree_map(lambda t: t * (1 + 2.0 ** -9 * torch.randn(
                t.shape, generator=gen)) if t.dtype == torch.float32 else t,
                params)
            got = T.value_and_grad(noisy, batch, cfg)[1]
            errors = self._leaf_errors(got, grads)
            worst = max([worst] + [e for k, e in errors.items()
                                   if k not in f32])
        return worst

    def _train_smoke_archs(self):
        """Every architecture's smoke config, one step, card against CPU on
        the same parameters (drawn on the CPU, copied) and the same batch
        (for the MoE archs the first numpy seed whose every routing clears
        the next gate by 1e-3 on the CPU, the margin rule): the loss within
        1e-3, the global gradient norm within 2e-2, every gradient leaf
        within max(3e-2, the gradient's own sensitivity, _grad_sensitivity)
        of its max -- the CPU tests' fixed bound where the gradient is well
        conditioned, its bf16 spread where it is not (xlstm, whose CPU test
        holds it to the reference's own spread, and paligemma); then the
        optimizer's update on the card."""
        import torch

        from repro_torch import configs
        from repro_torch.checkpoint.store import _leaves
        from repro_torch.models import model as M
        from repro_torch.models import train as T
        from repro_torch.optim import apply_updates, global_norm
        from repro_torch.optim.transforms import tree_map

        dev, cpu = torch.device("cuda"), torch.device("cpu")
        rows = {}
        for arch in configs.list_archs():
            cfg = configs.smoke_config(arch)
            opt = T.make_optimizer(peak_lr=1e-3, warmup=2, total=16)
            state = T.init_state(torch.Generator().manual_seed(0), cfg, opt,
                                 cpu)
            seed = 0
            while cfg.num_experts:
                margins = []
                with self._route_margins(margins), torch.no_grad():
                    M.backbone(T.model_params(state.params, cfg),
                               self._train_batch(cfg, seed, cpu), cfg)
                if float(torch.cat(margins).min()) >= 1e-3:
                    break
                seed += 1
            batch = self._train_batch(cfg, seed, cpu)
            mc, gc = T.value_and_grad(state.params, batch, cfg)
            params = tree_map(lambda t: t.to(dev), state.params)
            md, gd = T.value_and_grad(params,
                                      self._train_batch(cfg, seed, dev), cfg)
            loss_rel = abs(float(md["loss"]) - float(mc["loss"])) / \
                abs(float(mc["loss"]))
            nc, nd = float(global_norm(gc)), float(global_norm(gd))
            errors = self._leaf_errors(gd, gc)
            worst_at = max(errors, key=errors.get)
            sensitivity = self._grad_sensitivity(state.params, batch, cfg, gc)
            bound = max(3e-2, sensitivity)
            if loss_rel > 1e-3 or abs(nd - nc) > 2e-2 * nc or \
                    errors[worst_at] > bound:
                raise AssertionError(
                    f"{arch}: loss {md['loss']} vs {mc['loss']}, norm {nd} vs "
                    f"{nc}, leaf {worst_at} at {errors[worst_at]} of its max "
                    f"(bound {bound})")
            updates, _ = opt.update(gd, opt.init(params), params)
            new = apply_updates(params, updates)
            if not all(bool(torch.isfinite(t.float()).all())
                       for _, t in _leaves(new)):
                raise AssertionError(f"{arch}: the update is not finite")
            rows[arch] = {"seed": seed, "loss_card": float(md["loss"]),
                          "loss_rel": loss_rel, "grad_norm_rel":
                          abs(nd - nc) / nc, "worst_leaf": worst_at,
                          "worst_leaf_rel": errors[worst_at],
                          "sensitivity": sensitivity, "bound": bound}
            del params, gd, new, updates
        torch.cuda.empty_cache()
        return rows

    def kernel_time(self):
        import torch

        from repro_torch.kernels import push_fused

        eng, engu = self.engines["pagerank"], self.engines["labelprop"]
        arrs, arrsu = eng.arrays, engu.arrays
        K = self.pgw.chunk_size
        S = K
        SF, SI = float(push_fused.SENTINEL_F32), push_fused.SENTINEL
        gen = torch.Generator(device="cuda").manual_seed(0)
        rand = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
        fvals = rand(1, K)
        dist = torch.where(rand(1, K) < 0.5, fvals * 100, SF)
        ivals = (fvals * 1e6).to(torch.int32)
        labels = torch.arange(K, device="cuda", dtype=torch.int32)[None]
        # B=4 planes, and a sparse frontier: 1% of sources reached, the rest
        # at the identity, as a min program's quiesced sources send it
        dist4 = torch.where(rand(1, K, 4) < 0.5, rand(1, K, 4) * 100, SF)
        ivals4 = (rand(1, K, 4) * 1e6).to(torch.int32)
        labels4 = labels[..., None] * 4 + torch.arange(
            4, device="cuda", dtype=torch.int32)
        # B=8 and B=16 planes: the batched plane's calls (PPR's add, bfs,
        # sssp) at the server's width and at the plane phase's
        planes = {B: (rand(1, K, B),
                      torch.where(rand(1, K, B) < 0.5, rand(1, K, B) * 100,
                                  SF),
                      (rand(1, K, B) * 1e6).to(torch.int32))
                  for B in (8, 16)}
        few = rand(1, K) < 0.01
        dist_f = torch.where(few, fvals * 100, SF)
        ivals_f = torch.where(few, 3, SI).to(torch.int32)
        labels_f = torch.where(few, labels, SI)
        # (program, kernel, case, layout, vals, weighted, unit): the calls
        # the main path makes, at its shapes
        variants = [
            ("pagerank", "fused_push_add", "dense", arrs, fvals, False,
             False),
            ("pagerank_weighted", "fused_push_add", "dense", arrs, fvals,
             True, False),
            ("sssp", "fused_push_min", "dense", arrs, dist, True, False),
            ("bfs", "fused_push_min", "dense", arrs, ivals, False, True),
            ("labelprop", "fused_push_min", "dense", arrsu, labels, False,
             False),
            ("sssp", "fused_push_min", "B=4", arrs, dist4, True, False),
            ("bfs", "fused_push_min", "B=4", arrs, ivals4, False, True),
            ("labelprop", "fused_push_min", "B=4", arrsu, labels4, False,
             False),
            ("sssp", "fused_push_min", "frontier 1%", arrs, dist_f, True,
             False),
            ("bfs", "fused_push_min", "frontier 1%", arrs, ivals_f, False,
             True),
            ("labelprop", "fused_push_min", "frontier 1%", arrsu, labels_f,
             False, False),
        ]
        for B, (fv, dv, iv) in planes.items():
            variants += [
                ("personalized_pagerank", "fused_push_add", f"B={B}", arrs,
                 fv, False, False),
                ("sssp", "fused_push_min", f"B={B}", arrs, dv, True, False),
                ("bfs", "fused_push_min", f"B={B}", arrs, iv, False, True)]
        rows = []
        for prog, kern, case, a, vals, weighted, unit in variants:
            combine = "add" if kern.endswith("add") else "min"
            args = (a["sd_band"], a["sd_src_local"], a["sd_dst_global"],
                    a["sd_edge_valid"], a["sd_edge_weight"] if weighted
                    else None, vals, S)
            kw = dict(combine=combine, unit_weight=unit)
            what = f"{prog}/{case} at main shape"
            got = push_fused.fused_push(*args, **kw)
            want = push_fused.fused_push_plain(*args, **kw)
            torch.cuda.synchronize()
            err = self.compare(got, want, combine, what)
            del want
            extra = (self._tiled_add_checks(args, got, what)
                     if combine == "add"
                     else self._min_paths(args, kw, got, what))
            ms = extra.pop("tiled_ms")
            del got
            plain_ms = self.cuda_ms(
                lambda: push_fused.fused_push_plain(*args, **kw), 3)
            bound_ms, nbytes, ops = self._bound(a, vals, S, weighted)
            # yardstick only (the port never calls it): index_add_ or
            # scatter_reduce_ over values gathered beforehand
            yard_ms = (self._yardstick(a, vals, S, combine)
                       if case in ("dense", "B=4") else None)
            rows.append({"program": prog, "kernel": kern, "case": case,
                         "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bytes": nbytes,
                         "operations": ops, "max_abs_err": err,
                         "yardstick_ms": yard_ms, **extra})
        del dist4, ivals4, labels4, planes
        # one line per kernel: its heaviest main-path call (weighted f32),
        # and the batched plane's B=8 and B=16 calls beside it
        pick = {"fused_push_add": ("pagerank_weighted",
                                   "personalized_pagerank"),
                "fused_push_min": ("sssp", "sssp")}
        for kern, (prog, prog_b) in pick.items():
            r = next(r for r in rows
                     if r["program"] == prog and r["case"] == "dense")
            wide = {f"b{B}": next(r for r in rows if r["program"] == prog_b
                                  and r["case"] == f"B={B}")
                    for B in (8, 16)}
            self.kernel_rows[kern] = {
                "name": kern, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_fused.cu",
                "replaces": ("src/repro/kernels/push_fused.py:54"
                             if kern.endswith("add") else
                             "src/repro/kernels/push_fused.py:104"),
                "launches": self.main_launches[kern],
                "serve_launches": self.serve_launches[kern],
                "max_abs_err": max(x["max_abs_err"] for x in rows
                                   if x["kernel"] == kern),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": None, "timed_call": prog,
                "atomic_ms": r["atomic_ms"],
                "yardstick_ms": r["yardstick_ms"],
                "path": ("tiled (tile pass + merge pass)"
                         if kern.endswith("add") else "tiled"),
                **{b: {k: rb[k] for k in ("program", "ms", "plain_ms",
                                          "bound_ms", "atomic_ms")}
                   for b, rb in wide.items()}}
        return {"calls": rows, "staged_calls": self._staged_time(),
                "gated_calls": self._gated_time()}

    def _min_paths(self, args, kw, got, what):
        """The fused min as planned (``got``, already held to the plain
        version: the tiled kernel where the table is dense enough) against
        the atomic kernel alone on the same operands: bit-equal, and both
        timed in turns (planned, atomic, atomic, planned; each the mean of
        20 launches, the better of its two turns kept)."""
        import torch

        from repro_torch.kernels import push_fused

        fp = lambda: push_fused.fused_push(*args, **kw)
        fa = lambda: push_fused.fused_push_atomic(*args, **kw)
        plan = push_fused.tile_plan(args[0])
        if plan.num_tiled != args[0].shape[0]:
            raise AssertionError(f"{what}: the layout is not seg-sorted")
        atomic = fa()
        torch.cuda.synchronize()
        self.compare(atomic, got, "min", f"{what} atomic vs tiled")
        del atomic
        t1 = self.cuda_ms(fp, 20)
        a1 = self.cuda_ms(fa, 20)
        a2 = self.cuda_ms(fa, 20)
        t2 = self.cuda_ms(fp, 20)
        return {"tiled_ms": min(t1, t2), "atomic_ms": min(a1, a2),
                "turns_ms": {"tiled": [t1, t2], "atomic": [a1, a2]},
                "path": "tiled" if plan.min_tiled else "atomic",
                "bit_equal": {"atomic_vs_tiled": True}}

    def _tiled_add_checks(self, args, got, what):
        """The tiled fused add at the main shape against the atomic path it
        replaces: both timed in turns (tiled, atomic, atomic, tiled; each
        the mean of 20 launches, the better of its two turns kept), the
        atomic result held to the tiled one within the plain version's
        tolerance, a repeated tiled call bit-identical, and each column of
        the call's plane (of a [B=4] call for a one-column call)
        bit-identical to the one-column call on it."""
        import torch

        from repro_torch.kernels import push_fused

        band, src, dst, valid, w, vals, S = args
        fp = push_fused.fused_push
        fa = push_fused.fused_push_atomic
        if push_fused.tile_plan(band).num_tiled != band.shape[0]:
            raise AssertionError(f"{what}: the layout is not seg-sorted")
        atomic = fa(*args)
        again = fp(*args)
        torch.cuda.synchronize()
        if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
            raise AssertionError(f"{what}: two tiled calls differ")
        err = self.compare(atomic, got, "add", f"{what} atomic vs tiled")
        del atomic, again
        if vals.dim() == 3:  # a plane: its own columns
            cols, wide = vals, got
        else:
            gen = torch.Generator(device="cuda").manual_seed(7)
            cols = torch.rand(vals.shape + (4,), generator=gen,
                              device="cuda")
            wide = fp(band, src, dst, valid, w, cols, S)
        B = cols.shape[-1]
        for b in range(B):
            one = fp(band, src, dst, valid, w, cols[..., b].contiguous(), S)
            if not torch.equal(wide[..., b].contiguous().view(torch.int32),
                               one.view(torch.int32)):
                raise AssertionError(f"{what}: column {b} of a B={B} call "
                                     "differs from its one-column call")
        del cols, wide, one
        t1 = self.cuda_ms(lambda: fp(*args), 20)
        a1 = self.cuda_ms(lambda: fa(*args), 20)
        a2 = self.cuda_ms(lambda: fa(*args), 20)
        t2 = self.cuda_ms(lambda: fp(*args), 20)
        # device ms per call of each pass (the tile pass, the merge pass)
        passes = {k["name"][:40]: k["device_ms"] / k["calls"] for k in
                  self._device_profile(lambda: [fp(*args) for _ in range(3)])
                  ["by_kernel"] if "namespace" in k["name"]}
        return {"tiled_ms": min(t1, t2), "atomic_ms": min(a1, a2),
                "turns_ms": {"tiled": [t1, t2], "atomic": [a1, a2]},
                "passes_ms": passes,
                "atomic_vs_tiled_max_abs_err": err,
                "bit_identical": {"repeat": True, f"columns_of_B{B}": True}}

    def _staged_time(self):
        """The staged kernels at the main path's shapes -- the sd layout
        (push_fn=None) and the pairwise layout (basic) of the scale-22
        weighted graph -- against their plain versions, with CUDA-event
        times and the byte bound; the min pair at B=1 and B=4.  A gather
        reads src and valid (8 B per edge) and vals (4 B per vertex and
        column) and writes c (4 B per edge and column); a scatter reads dst
        (4 B per edge) and c and writes out (4 B per segment and column).
        Scatter rows also time the one PyTorch call that computes the same
        function (``index_add_`` into zeros, ``scatter_reduce_(amin)`` into
        the sentinel) in turns with the kernel; gather rows time
        ``index_select`` as a yardstick only (it has no valid mask)."""
        import torch

        from repro_torch.kernels import push_staged as ps
        from repro_torch.kernels.push_fused import SENTINEL_F32

        sd = self.engines["pagerank"].arrays
        pw = self.staged_engines["basic"][0].arrays
        K = self.pgw.chunk_size
        gen = torch.Generator(device="cuda").manual_seed(0)
        rand = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
        fvals = rand(1, K)
        # sssp-like distances: half the vertices unreached
        dist = torch.where(rand(1, K) < 0.5, fvals * 100, SENTINEL_F32)
        dist4 = torch.where(rand(1, K, 4) < 0.5, rand(1, K, 4) * 100,
                            SENTINEL_F32)
        layouts = {
            "sd": (sd["sd_src_local"], sd["sd_dst_global"],
                   sd["sd_edge_valid"]),
            "pairwise": tuple(pw[k].reshape(1, -1) for k in
                              ("pb_src_local", "pb_dst_local", "pb_valid")),
        }
        rows = []
        for layout, (src, dst, valid) in layouts.items():
            E = src.numel()
            for half, vals, prog in (("sum", fvals, "pagerank"),
                                     ("min", dist, "sssp"),
                                     ("min", dist4, "sssp")):
                B = vals[0, 0].numel()
                gather = getattr(ps, f"gather_{half}")
                gplain = getattr(ps, f"gather_{half}_plain")
                c = gather(src, valid, vals)
                want = gplain(src, valid, vals)
                torch.cuda.synchronize()
                err = self.compare(c, want, "min",
                                   f"gather_{half}/{layout}/B={B}")
                del want
                src64 = src.reshape(-1).long()
                nbytes = 8 * E + 4 * E * B + 4 * K * B
                rows.append({
                    "kernel": f"gather_{half}", "layout": layout,
                    "program": prog, "B": B, "edges": E,
                    "ms": self.cuda_ms(lambda: gather(src, valid, vals), 20),
                    "plain_ms": self.cuda_ms(
                        lambda: gplain(src, valid, vals), 3),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bytes": nbytes, "max_abs_err": err,
                    "library_ms": None,
                    "yardstick_ms": self.cuda_ms(
                        lambda: vals[0].index_select(0, src64), 20)})
                del src64
                scatter = getattr(ps, f"scatter_{half}")
                splain = getattr(ps, f"scatter_{half}_plain")
                combine = "add" if half == "sum" else "min"
                got = scatter(dst, c, K)
                want = splain(dst, c, K)
                torch.cuda.synchronize()
                err = self.compare(got, want, combine,
                                   f"scatter_{half}/{layout}/B={B}")
                del got, want
                tail = tuple(vals.shape[2:])
                dst64 = dst.reshape(-1).long()
                cflat = c.reshape((-1,) + tail)
                if half == "sum":
                    out = torch.zeros((K,) + tail, device="cuda")
                    lib = lambda: out.index_add_(0, dst64, cflat)
                else:
                    out = torch.full((K,) + tail, SENTINEL_F32,
                                     device="cuda")
                    dst64 = dst64.reshape(dst64.shape + (1,) * len(tail)) \
                        .expand_as(cflat)
                    lib = lambda: out.scatter_reduce_(
                        0, dst64, cflat, reduce="amin", include_self=True)
                nbytes, ops = 4 * E + 4 * E * B + 4 * K * B, E * B
                # kernel and library call in turns: k, lib, lib, k
                k1 = self.cuda_ms(lambda: scatter(dst, c, K), 20)
                l1, l2 = self.cuda_ms(lib, 20), self.cuda_ms(lib, 20)
                k2 = self.cuda_ms(lambda: scatter(dst, c, K), 20)
                rows.append({
                    "kernel": f"scatter_{half}", "layout": layout,
                    "program": prog, "B": B, "edges": E,
                    "ms": min(k1, k2),
                    "plain_ms": self.cuda_ms(lambda: splain(dst, c, K), 3),
                    "bound_ms": max(nbytes / HBM_BYTES_PER_S,
                                    ops / FP32_OPS_PER_S) * 1e3,
                    "bytes": nbytes, "max_abs_err": err,
                    "library_ms": min(l1, l2),
                    "turns_ms": {"kernel": [k1, k2], "library": [l1, l2]}})
                del dst64, cflat, out, c
        del dist4
        replaces = {
            "gather_sum": "src/repro/kernels/push_sum.py:31",
            "scatter_sum": "src/repro/kernels/push_sum.py:46",
            "gather_min": "src/repro/kernels/push_min.py:22",
            "scatter_min": "src/repro/kernels/push_min.py:37",
        }
        for kern, where in replaces.items():
            r = next(r for r in rows if r["kernel"] == kern
                     and r["layout"] == "sd" and r["B"] == 1)
            self.kernel_rows[kern] = {
                "name": kern, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_staged.cu",
                "replaces": where,
                "launches": self.staged_launches[kern],
                "max_abs_err": max(x["max_abs_err"] for x in rows
                                   if x["kernel"] == kern),
                "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes",
                "library_ms": r["library_ms"],
                "timed_call": f"{r['program']}/sd"}
        return rows

    @staticmethod
    def _bound(a, vals, S, weighted, layout="sd"):
        """Least time for one call: the bytes it must move (band table, the
        edge planes of the non-empty edge blocks, vals read once, out
        written once) over HBM bandwidth, or its operations (one transform
        and one combine per valid edge and column) over the float32 rate,
        whichever is larger.  ``layout`` names the arrays' prefix: ``sd``
        or ``gr`` (the grid's rectangle layout)."""
        band = a[f"{layout}_band"]
        live_blocks = int((band[:, 1] >= 0).sum())
        per_edge = 12 + (4 if weighted else 0)
        B = vals[0, 0].numel()
        nbytes = (band.numel() * 4 + live_blocks * 256 * per_edge
                  + vals.numel() * vals.element_size()
                  + vals.shape[0] * S * B * vals.element_size())
        ops = 2 * int(a[f"{layout}_edge_valid"].sum()) * B
        ms = max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        return ms, nbytes, ops

    def _yardstick(self, a, vals, S, combine):
        """One PyTorch call over values gathered beforehand: ``index_add_``
        into zeros, or ``scatter_reduce_(amin)`` into the identity (min's
        function: out starts at the identity, as the kernel's does)."""
        import torch

        from repro_torch.kernels.push_fused import _identity

        keep = a["sd_edge_valid"][0] != 0
        idx = a["sd_dst_global"][0][keep].long()
        data = vals[0].index_select(0, a["sd_src_local"][0][keep].long())
        shape = (S,) + tuple(vals.shape[2:])
        if combine == "add":
            out = torch.zeros(shape, dtype=vals.dtype, device="cuda")
            fn = lambda: out.index_add_(0, idx, data)
        else:
            out = torch.full(shape, _identity("min", vals.dtype),
                             dtype=vals.dtype, device="cuda")
            idx = idx.reshape(idx.shape + (1,) * (data.dim() - 1)) \
                .expand_as(data)
            fn = lambda: out.scatter_reduce_(0, idx, data, reduce="amin",
                                             include_self=True)
        ms = self.cuda_ms(fn, 10)
        del idx, data, out
        return ms

    def _chare_graphs(self):
        """The chare-axis graph (2^chare-scale vertices), its weighted and
        symmetrized forms and their C-chare partitions; built once."""
        from repro_torch.core import graph as G

        if not hasattr(self, "_chare"):
            a = self.args
            g = G.load_dataset("soc-lj1-mini", scale_log2=a.chare_scale,
                               seed=1)
            gw = G.random_weights(g, seed=5)
            gu = g.to_undirected()
            self._chare = (g, gw, gu, G.partition(gw, a.chares),
                           G.partition(gu, a.chares))
        return self._chare

    def chares(self):
        from repro_torch.core import Engine
        from repro_torch.kernels import push_fused

        a = self.args
        g, gw, gu, pgw, pgu = self._chare_graphs()
        rows = []
        push_fused.reset_launch_counts()
        for strategy in ("sortdest", "reduction", "pairs", "basic"):
            eng, engu = Engine(pgw, strategy), Engine(pgu, strategy)
            if strategy == "sortdest":
                sd = eng.arrays
            for name in ("pagerank", "pagerank_weighted", "sssp", "bfs",
                         "labelprop"):
                e, graph = (engu, gu) if name == "labelprop" else (eng, gw)
                # the serial labelprop's superstep count is cheap here
                row = self._check_program(e, name, graph, a.chares, "chares",
                                          labelprop_iters=True)
                row.update(strategy=strategy, choice=e.dispatch["choice"],
                           kernel=e.dispatch["kernel"])
                rows.append(row)
        launches = dict(push_fused.launch_counts)
        # each monoid's path: tiled on the sd layout, atomic on the basic one
        for row in rows:
            for combine in ("add", "min"):
                n = row["launches"].get(f"fused_push_{combine}")
                if row["strategy"] == "basic" or not n:
                    continue
                path = "atomic" if row["strategy"] == "reduction" \
                    else "tiled"
                if row["launches"].get(f"fused_push_{combine}_{path}") != n:
                    raise AssertionError(f"{row['program']}/"
                                         f"{row['strategy']}: launches "
                                         f"{row['launches']}")
        paths = self._chare_paths(sd, pgw.num_chunks, pgw.chunk_size)
        staged = self._staged_choice()
        return {"vertices": g.num_vertices, "edges": g.num_edges,
                "chares": a.chares, "runs": rows, "launches": launches,
                "paths": paths, "staged_choice": staged}

    def _chare_paths(self, a, C, K):
        """The fused push on the C-chare sd layout (every chare row in one
        call, as sortdest and pairs make it): the tiled add against the
        atomic one with ``_tiled_add_checks``, and the tiled min against
        the atomic one with ``_min_paths``, beside the byte bound.  These
        rows are far sparser per segment block than the main path's."""
        import torch

        from repro_torch.kernels import push_fused

        gen = torch.Generator(device="cuda").manual_seed(3)
        vals = torch.rand((C, K), generator=gen, device="cuda")
        dist = torch.where(torch.rand((C, K), generator=gen, device="cuda")
                           < 0.5, vals * 100, push_fused.SENTINEL_F32)
        ivals = (vals * 1e6).to(torch.int32)
        rows = []
        for prog, combine, x, weighted, unit in (
                ("pagerank", "add", vals, False, False),
                ("pagerank_weighted", "add", vals, True, False),
                ("sssp", "min", dist, True, False),
                ("bfs", "min", ivals, False, True)):
            args = (a["sd_band"], a["sd_src_local"], a["sd_dst_global"],
                    a["sd_edge_valid"], a["sd_edge_weight"] if weighted
                    else None, x, C * K)
            kw = dict(combine=combine, unit_weight=unit)
            what = f"{prog} at C={C}"
            got = push_fused.fused_push(*args, **kw)
            want = push_fused.fused_push_plain(*args, **kw)
            torch.cuda.synchronize()
            err = self.compare(got, want, combine, what)
            row = {"program": prog, "max_abs_err": err,
                   **(self._tiled_add_checks(args, got, what)
                      if combine == "add"
                      else self._min_paths(args, kw, got, what))}
            row["bound_ms"] = self._bound(a, x, C * K, weighted)[0]
            row["plain_ms"] = self.cuda_ms(
                lambda: push_fused.fused_push_plain(*args, **kw), 3)
            rows.append(row)
            del got, want
        return rows

    def _staged_choice(self):
        """The near-uniform contrast graph at C chares: its dispatch must
        choose the staged pair, which then runs on the card."""
        from repro_torch.core import Engine
        from repro_torch.core import graph as G
        from repro_torch.kernels import push_fused

        a = self.args
        t0 = time.perf_counter()
        n = 1 << a.scale
        g = G.erdos_renyi(n, 2 * n, seed=1)
        gw = G.random_weights(g, seed=5)
        gu = g.to_undirected()
        pgw, pgu = G.partition(gw, a.chares), G.partition(gu, a.chares)
        eng, engu = Engine(pgw), Engine(pgu)
        setup_s = time.perf_counter() - t0
        for e in (eng, engu):
            if e.dispatch["choice"] != "staged" or \
                    e.dispatch["kernel"] != "cuda":
                raise AssertionError(f"staged-choice graph: dispatch "
                                     f"{e.dispatch}")
        rows = []
        push_fused.reset_launch_counts()
        for name in ("pagerank", "pagerank_weighted", "sssp", "bfs",
                     "labelprop"):
            e, graph = (engu, gu) if name == "labelprop" else (eng, gw)
            rows.append(self._check_program(e, name, graph, a.chares,
                                            "staged_choice"))
        self.er = (pgw, eng)
        return {"vertices": n, "edges": g.num_edges,
                "undirected_edges": gu.num_edges,
                "dispatch": {k: v for k, v in eng.dispatch.items()
                             if not isinstance(v, dict)},
                "setup_s": round(setup_s, 3), "runs": rows,
                "launches": dict(push_fused.launch_counts)}

    def push_choice(self):
        """One fused push against one staged pair, through the hooks the
        dispatch chooses between, on the main layout (dispatch: fused) and
        on the staged-choice layout (dispatch: staged); then program seconds
        on the staged-choice graph with either hook.  A measurement only:
        the rule stays as it is."""
        import torch

        from repro_torch.core import Engine
        from repro_torch.kernels import ops, push_fused

        fused, staged = ops.make_push_fn(), ops.make_push_fn(fused=False)
        layouts = (("main", self.engines["pagerank"]),
                   ("staged_choice", self.er[1]))
        calls = []
        for label, eng in layouts:
            a = eng.arrays
            C, K = eng._C, eng._K
            gen = torch.Generator(device="cuda").manual_seed(3)
            fvals = torch.rand((C, K), generator=gen, device="cuda")
            ivals = (fvals * 1e6).to(torch.int32)
            for prog, combine, vals, weighted, unit in (
                    ("pagerank", "add", fvals, False, False),
                    ("sssp", "min", fvals * 100, True, False),
                    ("bfs", "min", ivals, False, True)):
                args = (vals, a["sd_src_local"], a["sd_dst_global"],
                        a["sd_edge_valid"],
                        a["sd_edge_weight"] if weighted else None, C * K)
                kw = dict(combine=combine, band=a["sd_band"], unit=unit)
                got_s, got_f = staged(*args, **kw), fused(*args, **kw)
                torch.cuda.synchronize()
                self.compare(got_s, got_f, combine, f"{label}/{prog}")
                f1 = self.cuda_ms(lambda: fused(*args, **kw), 10)
                s1 = self.cuda_ms(lambda: staged(*args, **kw), 10)
                s2 = self.cuda_ms(lambda: staged(*args, **kw), 10)
                f2 = self.cuda_ms(lambda: fused(*args, **kw), 10)
                row = {"layout": label, "program": prog,
                       "dispatch": eng.dispatch["choice"],
                       "max_occupancy": eng.dispatch["max_occupancy"],
                       "fused_ms": min(f1, f2), "staged_ms": min(s1, s2),
                       "faster": "fused" if min(f1, f2) < min(s1, s2)
                       else "staged"}
                # the fused kernel alone (without ops.push's padding and
                # sentinel mapping) on its planned path and on the atomic
                # path, in turns, and the path the fused hook took (one
                # call's launches)
                call = (a["sd_band"], *args[1:5], vals, C * K)
                kern = lambda: push_fused.fused_push(
                    *call, combine=combine, unit_weight=unit)
                atomic = lambda: push_fused.fused_push_atomic(
                    *call, combine=combine, unit_weight=unit)
                k1, a1 = self.cuda_ms(kern, 10), self.cuda_ms(atomic, 10)
                a2, k2 = self.cuda_ms(atomic, 10), self.cuda_ms(kern, 10)
                row["fused_kernel_ms"] = min(k1, k2)
                row["fused_atomic_ms"] = min(a1, a2)
                row["bound_ms"] = self._bound(a, vals, C * K, weighted)[0]
                row["plain_ms"] = self.cuda_ms(
                    lambda: push_fused.fused_push_plain(
                        *call, combine=combine, unit_weight=unit), 3)
                push_fused.reset_launch_counts()
                fused(*args, **kw)
                row["fused_path"] = {k: n for k, n in
                                     push_fused.launch_counts.items() if n}
                calls.append(row)
        pgw, eng = self.er
        forced = Engine(pgw, push_fn=fused)
        programs = []
        for name in ("pagerank", "sssp", "bfs"):
            secs = {}
            for how, e in (("auto_staged", eng), ("fused", forced),
                           ("fused_again", forced),
                           ("auto_staged_again", eng)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.run(name)
                secs[how] = time.perf_counter() - t0
            programs.append({"program": name, **secs})
        return {"calls": calls, "staged_choice_programs": programs}

    # -- the row gate ---------------------------------------------------------

    GATED_FUSED = (("add", "float32", "none"), ("add", "float32", "array"),
                   ("min", "int32", "unit"), ("min", "float32", "array"))
    GATED_STAGED = (("gather_sum", "float32"), ("gather_min", "int32"),
                    ("gather_min", "float32"), ("scatter_sum", "float32"),
                    ("scatter_min", "int32"), ("scatter_min", "float32"))

    @staticmethod
    def _row_mask(kind, rows):
        """``None`` (no gate), every row gated, or every other row."""
        import torch

        if kind == "none":
            return None
        keep = (torch.zeros(rows, dtype=torch.int32) if kind == "all"
                else torch.arange(rows, dtype=torch.int32) % 2)
        return keep.to("cuda")

    def _gated_rows(self, got, full, ra, init, identity, exact, what):
        """Gated rows hold ``init`` or ``identity`` bit for bit; active rows
        equal the call without the gate (bit for bit where ``exact``, else
        within the float-add tolerance)."""
        import torch

        if ra is None:
            return
        off = (ra == 0).nonzero().flatten()
        on = ra.nonzero().flatten()
        want = (init[off] if init is not None
                else torch.full_like(got[off], identity))
        if not torch.equal(got[off].view(torch.int32),
                           want.to(got.dtype).view(torch.int32)):
            raise AssertionError(f"{what}: a gated row was written")
        if exact:
            if not torch.equal(got[on].view(torch.int32),
                               full[on].view(torch.int32)):
                raise AssertionError(f"{what}: an active row differs from "
                                     "the call without the gate")
        else:
            self.compare(got[on], full[on], "add", what + " active rows")

    def _gated_layouts(self):
        """The chare-axis graph's C-chare sd layout and its grid(2,4)
        gr_band, on the card: {name: (band, src, dst, valid, weight, V,
        S)}."""
        from repro_torch.core import graph as G

        _, gw, _, pgw, _ = self._chare_graphs()
        if not hasattr(self, "_chare_grid"):
            self._chare_grid = G.partition(gw, 8, "grid(2,4)")
        pgr = self._chare_grid
        sd = pgw.device_arrays("sd", "cuda")
        gr = pgr.device_arrays("grid", "cuda")
        return {
            f"sd C={pgw.num_chunks}": (
                sd["sd_band"], sd["sd_src_local"], sd["sd_dst_global"],
                sd["sd_edge_valid"], sd["sd_edge_weight"], pgw.chunk_size,
                pgw.num_chunks * pgw.chunk_size),
            "gr_band grid(2,4)": (
                gr["gr_band"], gr["gr_src_local"], gr["gr_dst_col"],
                gr["gr_edge_valid"], gr["gr_edge_weight"], pgr.chunk_size,
                pgr.grid_shape[1] * pgr.col_chunk_size)}

    def _gated_matrix(self):
        """Gated cases of all six kernels against their plain versions: row
        masks none, all and half, on the chare-axis graph's C-chare sd
        layout and grid(2,4) gr_band, with and without init (the fused
        pair), at one column and at B=4.  Returns the number of cases."""
        import torch

        from repro_torch.kernels import push_fused, push_staged

        gen = torch.Generator(device="cuda").manual_seed(11)
        cases = 0

        def draw(dtype, combine, shape):
            x = torch.rand(shape, generator=gen, device="cuda")
            if dtype == "int32":
                x = (x * 1e6).to(torch.int32)
            elif combine == "add":
                # 0 or 1 (and whole weights below 10): every sum -- a hub
                # segment takes ~1.5M terms here -- stays below 2^24 and is
                # exact in any order, so the gated sums are held bit for
                # bit; fractional sums are held to the plain versions
                # within tolerance by the matrices above
                x = torch.floor(x * 2)
            if combine == "min":  # a third unreached
                x.view(-1)[::3] = (push_fused.SENTINEL if dtype == "int32"
                                   else float("inf"))
            return x

        for lname, (band, src, dst, valid, w, V, S) in \
                self._gated_layouts().items():
            P = src.shape[0]
            for kind in ("none", "all", "half"):
                ra = self._row_mask(kind, P)
                for B in (None, 4):
                    tail = () if B is None else (B,)
                    for combine, dtype, mode in self.GATED_FUSED:
                        vals = draw(dtype, combine, (P, V) + tail)
                        wt = None
                        if mode == "array":
                            wt = torch.floor(w) if combine == "add" else w
                        for seeded in (False, True):
                            init = (draw(dtype, combine, (P, S) + tail)
                                    if seeded else None)
                            if init is not None and combine == "min" \
                                    and dtype == "float32":
                                init = init.clamp(
                                    max=push_fused.SENTINEL_F32)
                            kw = dict(combine=combine, init=init,
                                      unit_weight=mode == "unit")
                            args = (band, src, dst, valid, wt, vals, S)
                            what = (f"gated {combine}/{dtype}/{mode} "
                                    f"on {lname}/{kind}/B={B}/"
                                    f"init={seeded}")
                            got = push_fused.fused_push(*args, row_active=ra,
                                                        **kw)
                            want = push_fused.fused_push_plain(
                                *args, row_active=ra, **kw)
                            torch.cuda.synchronize()
                            self.compare(got, want, combine, what)
                            full = push_fused.fused_push(*args, **kw)
                            ident = push_fused._identity(combine, got.dtype)
                            # the tiled add is fixed-order: exact too
                            self._gated_rows(got, full, ra, init, ident,
                                             True, what)
                            cases += 1
                    for kernel, dtype in self.GATED_STAGED:
                        combine = "min" if kernel.endswith("min") else "add"
                        gather = kernel.startswith("gather")
                        x = draw(dtype, combine,
                                 (P, V if gather else src.shape[1]) + tail)
                        args = (src, valid, x) if gather else (dst, x, S)
                        fn = getattr(push_staged, kernel)
                        plain = getattr(push_staged, kernel + "_plain")
                        what = f"gated {kernel}/{dtype} on {lname}/{kind}/B={B}"
                        got, want = fn(*args, ra), plain(*args, ra)
                        torch.cuda.synchronize()
                        self.compare(got, want,
                                     "add" if kernel == "scatter_sum"
                                     else "min", what)
                        ident = 0 if combine == "add" else (
                            push_fused.SENTINEL if dtype == "int32"
                            else push_fused.SENTINEL_F32)
                        self._gated_rows(got, fn(*args), ra, None, ident,
                                         True, what)
                        cases += 1
        return cases

    # -- the adaptive modes: replan, overlap and the frontier gate -------------

    @staticmethod
    def _policy(target, **kw):
        from repro_torch.core import ReplanPolicy

        return ReplanPolicy(target, every=2, mode="always", **kw)

    def _replan_timers(self):
        """Wrap the replan's three steps with synchronized host timers:
        ``plan`` (the new plan and the lazy repartition), ``move`` (the
        on-device state move), ``rebind`` (the new layout's build, upload
        and tile plan).  -> (timings dict of lists, restore function)."""
        import torch

        from repro_torch.core.engine import Engine

        timing = {"plan_s": [], "move_s": [], "rebind_s": []}
        saved = {n: getattr(Engine, n)
                 for n in ("_replan_to", "_move_state", "_rebind")}

        def timed(key, fn):
            def wrapper(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                timing[key].append(round(time.perf_counter() - t0, 4))
                return out
            return wrapper

        Engine._replan_to = timed("plan_s", saved["_replan_to"])
        Engine._move_state = timed("move_s", saved["_move_state"])
        Engine._rebind = timed("rebind_s", saved["_rebind"])

        def restore():
            for n, fn in saved.items():
                setattr(Engine, n, fn)

        return timing, restore

    def replan(self):
        """Mid-run replanning on the main path's graphs; see the module
        docstring."""
        import numpy as np
        import torch

        from repro_torch.core import Engine
        from repro_torch.core import graph as G
        from repro_torch.kernels import push_fused

        timing, restore = self._replan_timers()
        try:
            eng = Engine(self.pgw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            push_fused.reset_launch_counts()
            rows = []
            for prog, target in (("sssp", "degree_sorted"),
                                 ("bfs", "contiguous"),
                                 ("pagerank", "degree_sorted")):
                t0 = time.perf_counter()
                got, it = eng.run(prog, replan=self._policy(target))
                secs = time.perf_counter() - t0
                if eng.pg.partitioner != target:
                    raise AssertionError(f"replan {prog}: bound to "
                                         f"{eng.pg.partitioner}")
                ref, ref_it, _ = self._reference(prog, self.gw, "main")
                row = {"program": prog, "target": target, "seconds": secs,
                       "supersteps": it, "serial_supersteps": ref_it}
                if prog == "pagerank":
                    err = float(np.max(np.abs(got - ref)))
                    base = self.engines["pagerank"].run("pagerank")[0]
                    row.update(max_abs_err_vs_serial=err,
                               max_abs_dev_vs_no_replan=float(
                                   np.max(np.abs(got - base))))
                    if not err < 1e-3:
                        raise AssertionError(f"replan pagerank: {err}")
                else:
                    if not np.array_equal(got, ref) or it != ref_it:
                        raise AssertionError(f"replan {prog}: differs from "
                                             f"serial ({it}/{ref_it})")
                plan = push_fused.tile_plan(eng.arrays["sd_band"])
                row["new_table"] = {"tiled_rows": plan.num_tiled,
                                    "min_tiled": plan.min_tiled,
                                    "build": eng.pg.layout_builds["sd"]}
                if (self.gw.num_edges >= G._DEVICE_BUILD_MIN_EDGES
                        and eng.pg.layout_builds["sd"] != "cuda"):
                    raise AssertionError(f"replan {prog}: the rebind built "
                                         "its layout on the host")
                if plan.num_tiled != 1 or not plan.min_tiled:
                    raise AssertionError(f"replan {prog}: the new sd table "
                                         "does not take the tiled path")
                rows.append(row)
            launches = dict(push_fused.launch_counts)
            peak = torch.cuda.max_memory_allocated()
            main_timing = {k: v[:] for k, v in timing.items()}
            for k in ("fused_push_add_tiled", "fused_push_min_tiled"):
                if not launches[k]:
                    raise AssertionError(f"{k} was not launched across the "
                                         "replans")
            for combine in ("add", "min"):
                if launches[f"fused_push_{combine}_atomic"]:
                    raise AssertionError(f"a replanned {combine} took the "
                                         "atomic path")
            del eng
            torch.cuda.empty_cache()
            plane = self._replan_plane()
            chares = self._replan_chares()
        finally:
            restore()
        return {"runs": rows, "launches": {k: n for k, n in launches.items()
                                           if n},
                "timings": main_timing, "peak_device_bytes": peak,
                "plane_b16": plane, "chare_axis": chares}

    def _replan_plane(self):
        """sssp at B=16 across a replan against the main engine's plane
        without one: every column and per-query count equal."""
        import numpy as np

        from repro_torch.core import Engine

        rng = np.random.default_rng(19)
        srcs = [0] + [int(s) for s in rng.choice(
            np.flatnonzero(self.gw.out_degrees > 0), 15, replace=False)]
        want, want_it = self.engines["sssp"].run_batch("sssp", sources=srcs)
        eng = Engine(self.pgw)
        t0 = time.perf_counter()
        got, got_it = eng.run_batch("sssp", sources=srcs,
                                    replan=self._policy("degree_sorted",
                                                        max_replans=1))
        secs = time.perf_counter() - t0
        if eng.pg.partitioner != "degree_sorted":
            raise AssertionError("replan plane did not switch")
        if not (np.array_equal(got, want) and np.array_equal(got_it,
                                                             want_it)):
            raise AssertionError("sssp B=16 across a replan differs from "
                                 "the plane without one")
        return {"B": 16, "seconds": secs, "supersteps": int(got_it.max())}

    def _replan_chares(self):
        """The chare-axis graph (C=8): the 1-D <-> 2-D switches of the
        reference's subprocess suite for sssp against serial (bit for bit,
        equal superstep counts), and PageRank across a replan on ``basic``
        and ``push_fn=None`` (the staged add pair) within 1e-3."""
        import numpy as np

        from repro_torch.core import Engine
        from repro_torch.core import graph as G

        _, gw, _, pgw, _ = self._chare_graphs()
        ref, ref_it, _ = self._reference("sssp", gw, "chares")
        out = []
        for start, target in (("contiguous", "grid(2,4)"),
                              ("grid(2,4)", "degree_sorted"),
                              ("grid(4,2)", "grid(2,4)")):
            pg = pgw if start == "contiguous" else G.partition(gw, 8, start)
            got, it = Engine(pg).run("sssp", replan=self._policy(target))
            if not np.array_equal(got, ref) or it != ref_it:
                raise AssertionError(f"sssp {start}->{target}: differs")
            out.append({"program": "sssp", "start": start, "target": target,
                        "supersteps": it})
        pref = self._reference("pagerank", gw, "chares")[0]
        for label, kw in (("basic", dict(strategy="basic")),
                          ("push_fn=None", dict(push_fn=None))):
            got, it = Engine(pgw, **kw).run(
                "pagerank", replan=self._policy("degree_sorted"))
            err = float(np.max(np.abs(got - pref)))
            if not err < 1e-3:
                raise AssertionError(f"pagerank {label} replan: {err}")
            out.append({"program": "pagerank", "engine": label,
                        "target": "degree_sorted", "max_abs_err": err})
        return out

    def _record_gate(self, eng):
        """Wrap ``eng._push`` and its push hook: keep, per gated push, the
        frontier's rows on the host and the mask the kernels got, and the
        first call whose mask gates some rows but not all and the first
        that gates every row (real supersteps' masks, for
        ``kernel_time``).  -> the record dict."""
        rec = {"frontiers": [], "masks": [], "partial": None, "empty": None}
        push, hook = eng._push, eng.push_fn

        def recording(program, vals, frontier=None, gate=False):
            if gate:
                rec["frontiers"].append(frontier.cpu())
            return push(program, vals, frontier, gate)

        def hooked(*args, **kw):
            ra = kw.get("row_active")
            if ra is not None:
                rec["masks"].append(ra.cpu())
                n = int(ra.sum())
                key = ("partial" if 0 < n < ra.numel() else
                       "empty" if n == 0 else None)
                if key is not None and rec[key] is None:
                    # the vals and the mask; the layout's tensors live on
                    rec[key] = ((args[0].clone(),) + tuple(args[1:]),
                                {**kw, "row_active": ra.clone()})
            return hook(*args, **kw)

        eng._push = recording
        if hook is not None:
            eng.push_fn = hooked
        return rec

    @staticmethod
    def _recount(eng, frontiers):
        """The gate's skipped rows recounted on the host from the frontiers
        a run went through and the bound layout's own edge arrays, sharing
        no code with the engine's gate: per chare row, the source blocks
        (``src_local // BLOCK_V``) of each BLOCK_E edge block's valid edges
        as the inclusive range ``[min, max]`` the gate covers, and as the
        exact set the edges read.  A row is active where a live frontier
        block meets its ranges; a row whose edges read a live block must be
        active (raises otherwise).  The pairwise layout gates on any
        frontier at all.  -> (skipped, masks)."""
        import numpy as np

        from repro_torch.core import strategies as strat
        from repro_torch.kernels.blocks import BLOCK_E, BLOCK_V

        C, K, nsb = eng._C, eng._K, eng._gate_nsb
        prefix = {"basic": "", "sd": "sd_", "grid": "gr_"}.get(
            strat.STRATEGY_LAYOUT[eng.strategy])
        if prefix is None:
            ranged = exact = np.ones((C, nsb), bool)
        else:
            src = getattr(eng.pg, prefix + "src_local")
            live = getattr(eng.pg, prefix + "edge_valid") != 0
            pad = ((0, 0), (0, (-src.shape[1]) % BLOCK_E))
            blk = np.pad(src // BLOCK_V, pad)
            live = np.pad(live, pad)
            exact = np.zeros((C, nsb), bool)
            exact[np.nonzero(live)[0], blk[live]] = True
            blk = blk.reshape(C, -1, BLOCK_E)
            live = live.reshape(C, -1, BLOCK_E)
            lo = np.where(live, blk, nsb).min(axis=2)
            hi = np.where(live, blk, -1).max(axis=2)
            del blk, live
            ranged = np.zeros((C, nsb), bool)
            for c, k in zip(*np.nonzero(hi >= 0)):
                ranged[c, lo[c, k]:hi[c, k] + 1] = True
        masks = []
        for f in frontiers:
            f = f.numpy()
            if f.ndim == 3:
                f = f.any(axis=-1)
            f = np.pad(f, ((0, 0), (0, nsb * BLOCK_V - K)))
            fb = f.reshape(C, nsb, BLOCK_V).any(axis=2)
            active = (fb & ranged).any(axis=1)
            if ((fb & exact).any(axis=1) & ~active).any():
                raise AssertionError("the gate's recount skips a row whose "
                                     "edges read a live block")
            masks.append(active)
        return sum(int((~m).sum()) for m in masks), masks

    def async_modes(self):
        """Barrier relaxation and the frontier gate; see the module
        docstring (phase ``async``)."""
        import numpy as np

        from repro_torch.benchmarks import tables
        from repro_torch.core import get_spec
        from repro_torch.kernels import push_fused

        rows = []
        push_fused.reset_launch_counts()
        for prog in ("sssp", "bfs", "labelprop"):
            eng = self.engines[prog]
            graph = self.gu if prog == "labelprop" else self.gw
            ref, ref_it, _ = self._reference(prog, graph, "main")
            got_b, it_b = eng.run(prog)
            got_o, it_o = eng.run(prog, sync="overlap")
            before = dict(push_fused.launch_counts)
            got_g, it_g = eng.run(prog, sync="overlap", gate="frontier")
            launched = push_fused.launch_counts["fused_push_min"] \
                - before["fused_push_min"]
            gate = dict(eng.dispatch["gate"])
            for label, got in (("barrier", got_b), ("overlap", got_o),
                               ("overlap+gate", got_g)):
                if not get_spec(prog).matches(got, ref):
                    raise AssertionError(f"async {prog}/{label}: differs "
                                         "from serial")
            if not it_b <= it_o <= 2 * it_b + 2 or it_g != it_o:
                raise AssertionError(f"async {prog}: supersteps barrier "
                                     f"{it_b}, overlap {it_o}, gated {it_g}")
            if gate["launched"] + gate["skipped_launches"] != \
                    gate["launch_slots"] or gate["launch_slots"] != it_g + 1 \
                    or launched != it_g + 1:
                raise AssertionError(f"async {prog}: accounting {gate}, "
                                     f"{launched} launches")
            run_b = lambda: eng.run(prog)
            run_g = lambda: eng.run(prog, sync="overlap", gate="frontier")
            b1, g1 = self._timed(run_b), self._timed(run_g)
            g2, b2 = self._timed(run_g), self._timed(run_b)
            rows.append({"program": prog, "supersteps": {
                "barrier": it_b, "overlap": it_o, "overlap+gate": it_g,
                "serial": ref_it}, "gate": gate,
                "seconds": {"barrier": min(b1, b2), "overlap+gate":
                            min(g1, g2)},
                "superstep_s": {"barrier": min(b1, b2) / it_b,
                                "overlap+gate": min(g1, g2) / it_g},
                "turns_s": {"barrier": [b1, b2], "overlap+gate": [g1, g2]}})
        c1_launches = dict(push_fused.launch_counts)
        table = tables.async_table(engine=self.engines["sssp"], repeats=3)
        grid = self._async_grid()
        mid = self._async_replan()
        plane = self._async_plane()
        chares = self._async_chares()
        gm = tables.gating_model(shape=(2, 4), graph=self._chare_graphs()[1])
        return {"c1": rows, "c1_launches": {k: n for k, n in
                                            c1_launches.items() if n},
                "async_table": table, "grid24": grid,
                "replan_mid_overlap": mid, "plane_b8": plane,
                "chare_axis": chares, "gating_model_chare_scale": gm}

    def _async_grid(self):
        """sssp with overlap and the gate on the main graph's grid(2,4)
        partition (kept from phase grid): bit-equal to serial, the skipped
        share, a host recount of the run's gate, the launches (counts
        zeroed just before and read just after), and
        ``tables.async_grid_metrics`` on the same partition."""
        import numpy as np

        from repro_torch.benchmarks import tables
        from repro_torch.core import Engine
        from repro_torch.kernels import push_fused

        eng = Engine(self.grid_pgw)
        rec = self._record_gate(eng)
        push_fused.reset_launch_counts()
        got, it = eng.run("sssp", sync="overlap", gate="frontier")
        self.async_launches = dict(push_fused.launch_counts)
        gate = dict(eng.dispatch["gate"])
        ref, ref_it, _ = self._reference("sssp", self.gw, "main")
        if not np.array_equal(got, ref):
            raise AssertionError("grid(2,4) overlap+gate sssp differs from "
                                 "serial")
        skipped, masks = self._recount(eng, rec["frontiers"])
        if skipped != gate["skipped_launches"] or any(
                not np.array_equal(m.numpy() != 0, h)
                for m, h in zip(rec["masks"], masks)):
            raise AssertionError(f"grid gate: {gate} against a recount of "
                                 f"{skipped}")
        if self.async_launches["fused_push_min"] != it + 1:
            raise AssertionError(f"grid gate: {self.async_launches}")
        self.bubble_call = rec["empty"]
        active = [int(h.sum()) for h in masks]
        metrics = tables.async_grid_metrics(graph=self.gw, pg=self.grid_pgw)
        if not metrics["bit_exact"] or metrics["counted_ratio"] > 0.6:
            raise AssertionError(f"async_grid_metrics: {metrics}")
        return {"supersteps": it, "serial_supersteps": ref_it, "gate": gate,
                "recounted_skipped": skipped,
                "active_rows_per_push": active,
                "partial_mask_seen": rec["partial"] is not None,
                "empty_mask_seen": rec["empty"] is not None,
                "launches": {k: n for k, n in self.async_launches.items()
                             if n},
                "metrics": metrics}

    def _async_replan(self):
        """A replan in the middle of overlap at C=1 (sssp, overlap + gate,
        to degree_sorted every 2 supersteps): bit-equal to serial within
        the overlap bound."""
        import numpy as np

        from repro_torch.core import Engine

        eng = Engine(self.pgw)
        t0 = time.perf_counter()
        got, it = eng.run("sssp", sync="overlap", gate="frontier",
                          replan=self._policy("degree_sorted"))
        secs = time.perf_counter() - t0
        ref, ref_it, _ = self._reference("sssp", self.gw, "main")
        if not np.array_equal(got, ref) or not it <= 2 * ref_it + 2 \
                or eng.pg.partitioner != "degree_sorted":
            raise AssertionError(f"replan mid overlap: {it} supersteps")
        return {"supersteps": it, "serial_supersteps": ref_it,
                "seconds": secs, "gate": dict(eng.dispatch["gate"])}

    def _async_plane(self):
        """A B=8 overlapped, gated sssp plane on the main engine against
        the barrier plane of the same sources: equal columns, each query's
        count within the overlap bound of its barrier count."""
        import numpy as np

        rng = np.random.default_rng(23)
        srcs = [0] + [int(s) for s in rng.choice(
            np.flatnonzero(self.gw.out_degrees > 0), 7, replace=False)]
        eng = self.engines["sssp"]
        want, want_it = eng.run_batch("sssp", sources=srcs)
        got, got_it = eng.run_batch("sssp", sources=srcs, sync="overlap",
                                    gate="frontier")
        if not np.array_equal(got, want) or not (
                (want_it <= got_it) & (got_it <= 2 * want_it + 2)).all():
            raise AssertionError("B=8 overlapped plane differs")
        return {"B": 8, "q_it": got_it.tolist(),
                "barrier_q_it": want_it.tolist(),
                "gate": dict(eng.dispatch["gate"])}

    def _async_chares(self):
        """The chare-axis graph (C=8): sssp with overlap and the gate on
        sortdest (fused), ``push_fn=None`` and ``basic`` (the staged min
        pair, gated), each against serial with a host recount of its gate;
        keeps a real superstep's mask of the ``push_fn=None`` run for
        ``kernel_time``."""
        import numpy as np

        from repro_torch.core import Engine
        from repro_torch.kernels import push_fused

        _, gw, _, pgw, _ = self._chare_graphs()
        ref, ref_it, _ = self._reference("sssp", gw, "chares")
        out = []
        for label, kw in (("sortdest", {}), ("push_fn=None",
                                             dict(push_fn=None)),
                          ("basic", dict(strategy="basic"))):
            eng = Engine(pgw, **kw)
            rec = self._record_gate(eng)
            if label == "sortdest":  # the fused min's real partial mask
                self.gated_call = None
            if label == "push_fn=None":  # the staged pair's real masks
                push = eng._push

                def keep(program, vals, frontier=None, gate=False,
                         push=push, eng=eng):
                    if gate and self.staged_call is None:
                        ra = eng._row_active(frontier)
                        if 0 < int(ra.sum()) < ra.numel():
                            self.staged_call = (vals.clone(), ra, eng)
                    return push(program, vals, frontier, gate)

                self.staged_call = None
                eng._push = keep
            push_fused.reset_launch_counts()
            got, it = eng.run("sssp", sync="overlap", gate="frontier")
            launched = dict(push_fused.launch_counts)
            # every push of a gated run is a gated launch: the fused min's
            # on sortdest, the staged min pair's under push_fn=None (whose
            # phase 2 launches no scatter); basic's phase-2 scatter is not
            if label == "sortdest":
                self.gated_launches = launched["fused_push_min"]
            if label == "push_fn=None":
                self.staged_gate_launches = launched
                if not launched["gather_min"] == launched["scatter_min"] \
                        == it + 1:
                    raise AssertionError(f"chare {label}: launches "
                                         f"{launched}, {it} supersteps")
            gate = dict(eng.dispatch["gate"])
            if not np.array_equal(got, ref) or not it <= 2 * ref_it + 2:
                raise AssertionError(f"chare {label} overlap+gate differs")
            if label == "sortdest":
                self.gated_call = rec["partial"]
            skipped, _ = self._recount(eng, rec["frontiers"])
            if skipped != gate["skipped_launches"]:
                raise AssertionError(f"chare {label}: {gate}, recount "
                                     f"{skipped}")
            out.append({"engine": label, "supersteps": it, "gate": gate,
                        "launches": {k: n for k, n in launched.items()
                                     if n}})
        return out

    @staticmethod
    def _active_bound(band, ra, vals, S, weighted, live_rows=None):
        """The gated call's least time: the bytes its active rows read
        (their band rows, the edge planes of their non-empty edge blocks,
        their vals rows, once each), the row mask, and every output row
        written once (a gated row's holds the identity) over HBM bandwidth;
        the operations are far below it.  -> (ms, bytes)."""
        on = ra != 0
        C = band.shape[0]
        live = int(((band[:, 1] >= 0) & on[:, None]).sum())
        rows = int(on.sum())
        per_edge = 12 + (4 if weighted else 0)
        row_vals = vals[0].numel() * vals.element_size()
        out_row = S * vals[0, 0].numel() * vals.element_size()
        nbytes = (band[0].numel() * 4 * rows + live * 256 * per_edge
                  + rows * row_vals + C * (out_row + 4))
        return nbytes / HBM_BYTES_PER_S * 1e3, nbytes

    def _gated_time(self):
        """The gated kernels under real supersteps' row masks, each held
        against its gated plain version, then timed against the same call
        without the gate (in turns) and the plain version: the fused min on
        the main graph's grid(2,4) gr_band (a push of phase async's grid run
        that gated every row) and on the chare-axis sd layout (one that
        gated some rows), and the staged min pair on that layout (from its
        ``push_fn=None`` run).  Each goes on the kernels line."""
        import torch

        from repro_torch.kernels import ops, push_fused, push_staged
        from repro_torch.kernels.blocks import BLOCK_S, BLOCK_V

        out = {}

        def prepared(recorded):
            """A recorded push hook call as the kernel's own operands (what
            ``ops.push`` hands ``fused_push``): ``call(gate, fn)``."""
            args, kw = recorded
            vals, src, dst, valid, weight, S = args
            vals_p = ops._pad_to(vals, BLOCK_V, push_fused.SENTINEL, dim=1)
            vals_p = torch.clamp(vals_p, max=push_fused.SENTINEL_F32)
            S_p = S + (-S) % BLOCK_S
            call = lambda gate, fn=push_fused.fused_push: fn(
                kw["band"], src, dst, valid, weight, vals_p, S_p,
                combine="min", unit_weight=kw["unit"], row_active=gate)
            return call, kw["band"], kw["row_active"], vals_p, S_p, weight

        def fused_row(name, recorded, launches, timed_call):
            """Hold a recorded gated call against its gated plain version,
            time it in turns against the same call without the gate, and
            put it on the kernels line."""
            call, band, ra, vals_p, S_p, weight = prepared(recorded)
            what = f"{name} ({timed_call})"
            got, want = call(ra), call(ra, push_fused.fused_push_plain)
            torch.cuda.synchronize()
            err = self.compare(got, want, "min", what)
            full = call(None)
            self._gated_rows(got, full, ra, None,
                             push_fused._identity("min", got.dtype), True,
                             what)
            del got, want, full
            g1, f1 = self.cuda_ms(lambda: call(ra), 20), self.cuda_ms(
                lambda: call(None), 20)
            f2, g2 = self.cuda_ms(lambda: call(None), 20), self.cuda_ms(
                lambda: call(ra), 20)
            plain_ms = self.cuda_ms(
                lambda: call(ra, push_fused.fused_push_plain), 3)
            bound_ms, nbytes = self._active_bound(band, ra, vals_p, S_p,
                                                  weight is not None)
            out[name] = {
                "active_rows": int((ra != 0).sum()), "rows": int(ra.numel()),
                "ms": min(g1, g2), "ungated_ms": min(f1, f2),
                "turns_ms": {"gated": [g1, g2], "ungated": [f1, f2]},
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
                "max_abs_err": err}
            self.kernel_rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_fused.cu",
                "replaces": "src/repro/kernels/push_fused.py:104",
                "launches": launches, "max_abs_err": err, "ms": min(g1, g2),
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": None,
                "timed_call": timed_call, "ungated_ms": min(f1, f2)}

        # the pipeline's bubble on grid(2,4): every row gated (at scale 22
        # every live push of the grid run keeps all 8 rectangles active);
        # launches: that gated run's
        if self.bubble_call is None:
            raise AssertionError("phase async saw no all-gated push on "
                                 "grid(2,4)")
        fused_row("fused_push_min/gated/grid", self.bubble_call,
                  self.async_launches["fused_push_min"],
                  "sssp overlap+gate on grid(2,4) gr_band, the pipeline's "
                  "empty half (every row gated)")
        # some rows gated: a real superstep of the chare-axis sd run;
        # launches: that gated run's
        if self.gated_call is None:
            raise AssertionError("phase async saw no fused push with some "
                                 "rows gated")
        fused_row("fused_push_min/gated", self.gated_call,
                  self.gated_launches,
                  f"sssp overlap+gate, C={self.args.chares} chare-axis sd "
                  "layout, a superstep's row mask")
        # the staged min pair on the chare-axis sd layout
        if self.staged_call is None:
            raise AssertionError("phase async saw no staged push with some "
                                 "rows gated")
        vals, ra, eng = self.staged_call
        a = eng.arrays
        src, dst, valid, w = (a["sd_src_local"], a["sd_dst_global"],
                              a["sd_edge_valid"], a["sd_edge_weight"])
        S = eng._C * eng._K
        c = ops._sat_add(push_staged.gather_min(src, valid, vals, ra), w)
        for kernel, fn, plain, xs in (
                ("gather_min", push_staged.gather_min,
                 push_staged.gather_min_plain, (src, valid, vals)),
                ("scatter_min", push_staged.scatter_min,
                 push_staged.scatter_min_plain, (dst, c, S))):
            got, want = fn(*xs, ra), plain(*xs, ra)
            torch.cuda.synchronize()
            err = self.compare(got, want, "min", f"gated {kernel}")
            del got, want
            g1, f1 = self.cuda_ms(lambda: fn(*xs, ra), 20), self.cuda_ms(
                lambda: fn(*xs), 20)
            f2, g2 = self.cuda_ms(lambda: fn(*xs), 20), self.cuda_ms(
                lambda: fn(*xs, ra), 20)
            plain_ms = self.cuda_ms(lambda: plain(*xs, ra), 3)
            rows = int((ra != 0).sum())
            E = src.shape[1]
            # active rows: gather reads src + valid and a vals element and
            # writes c per edge; scatter reads dst and c per edge and writes
            # its out rows
            nbytes = rows * (E * 16 if kernel == "gather_min"
                             else E * 8 + S * 4)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            out[f"{kernel}/gated"] = {
                "active_rows": rows, "rows": int(ra.numel()),
                "ms": min(g1, g2), "ungated_ms": min(f1, f2),
                "turns_ms": {"gated": [g1, g2], "ungated": [f1, f2]},
                "plain_ms": plain_ms, "bound_ms": bound_ms, "bytes": nbytes,
                "max_abs_err": err}
            self.kernel_rows[f"{kernel}/gated"] = {
                "name": f"{kernel}/gated", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_staged.cu",
                "replaces": ("src/repro/kernels/push_min.py:22"
                             if kernel == "gather_min"
                             else "src/repro/kernels/push_min.py:37"),
                "launches": self.staged_gate_launches[kernel],
                "max_abs_err": err, "ms": min(g1, g2),
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes", "library_ms": None,
                "timed_call": (f"sssp overlap+gate, push_fn=None, C="
                               f"{eng._C} sd layout, a superstep's row "
                               "mask"),
                "ungated_ms": min(f1, f2)}
        del c
        return out

    # -- out-of-core streaming (residency="stream") --------------------------

    @staticmethod
    def _block_chain(nblocks=8, per=256):
        """The reference's gate fixture (``tests/test_stream.py``): each
        vertex block a star from its first vertex, bridged to the next, so
        a BFS frontier stays inside about one block and the window gate has
        slots to skip even at grid(1,1)."""
        import numpy as np

        from repro_torch.core import from_edges

        srcs, dsts = [], []
        for b in range(nblocks):
            lo = b * per
            srcs += [lo] * (per - 1)
            dsts += list(range(lo + 1, lo + per))
            if b + 1 < nblocks:
                srcs.append(lo + 1)
                dsts.append(lo + per)
        return from_edges(nblocks * per, np.array(srcs, np.int32),
                          np.array(dsts, np.int32))

    def _stream_builds(self):
        """The grid(1,1) partitions of the main graphs, their layouts built
        on the card (asserted), compared array by array with the host build
        of the same grid layout, and phase graph's sd layout (built on the
        card there, asserted) with the host build of the sd layout; the
        seconds of each partition's relabel and of each layout build.
        -> (pgw, pgu, record)."""
        import os

        import numpy as np
        import torch

        from repro_torch.core import graph as G

        def build(mode, g, which, partitioner="grid(1,1)"):
            old = os.environ.get("REPRO_DEVICE_BUILD")
            os.environ["REPRO_DEVICE_BUILD"] = mode
            try:
                t0 = time.perf_counter()
                pg = G.partition(g, 1, partitioner, eager=False)
                t1 = time.perf_counter()
                pg._layout(which)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            finally:
                if old is None:
                    del os.environ["REPRO_DEVICE_BUILD"]
                else:
                    os.environ["REPRO_DEVICE_BUILD"] = old
            return pg, {"relabel_s": t1 - t0, "build_s": t2 - t1,
                        "build": pg.layout_builds[which]}

        def same(a, b, what):
            for x, y, name in zip(a._layout(what), b._layout(what),
                                  ("src", "dst", "weight", "band")):
                if x.dtype != y.dtype or not np.array_equal(x, y):
                    raise AssertionError(f"device-built {what} {name} "
                                         "differs from the host build")

        pgw, dev_w = build("device", self.gw, "grid")
        pgu, dev_u = build("device", self.gu, "grid")
        host_grid, host_w = build("host", self.gw, "grid")
        host_sd, host_s = build("host", self.gw, "sd", "contiguous")
        builds = {"grid": dev_w, "grid_undirected": dev_u,
                  "grid_host": host_w, "sd_host": host_s,
                  "sd": self.pgw.layout_builds["sd"]}
        for key in ("grid", "grid_undirected", "sd"):
            got = builds[key] if key == "sd" else builds[key]["build"]
            if got != "cuda":
                raise AssertionError(f"the {key} layout was built by {got}")
        same(pgw, host_grid, "grid")
        same(self.pgw, host_sd, "sd")
        del host_grid, host_sd
        torch.cuda.empty_cache()
        return pgw, pgu, builds

    def _stream_cases(self, eng, sources, seeds, launches=None):
        """Every run phase stream holds the streamed engine to: -> dict of
        results (numpy).  ``launches`` (optional) receives the launch
        counts of each single-query run, zeroed just before it and read
        just after."""
        from repro_torch.kernels import push_fused
        from repro_torch.launch import serve as S

        out = {}
        for prog in ("sssp", "bfs", "pagerank", "pagerank_weighted"):
            push_fused.reset_launch_counts()
            out[prog] = eng.run(prog)
            if launches is not None:
                launches[prog] = dict(push_fused.launch_counts)
        out["betweenness"] = eng.run("betweenness", pivots=(0, 1, 2, 3))
        for prog, srcs in (("bfs", sources), ("sssp", sources),
                           ("personalized_pagerank", seeds)):
            out[f"{prog}/B16"] = eng.run_batch(prog, sources=srcs, batch=16)
        server = S.GraphQueryServer(eng, batch=8)
        ids = ([server.submit("bfs", s) for s in sources[:4]]
               + [server.submit("sssp", s) for s in sources[4:6]]
               + [server.submit("personalized_pagerank", s, iters=4)
                  for s in sources[6:8]])
        server.drain()
        out["served"] = [server.result(i) for i in ids]
        out["served_programs"] = ["bfs"] * 4 + ["sssp"] * 2 + ["ppr"] * 2
        return out

    def _stream_held(self, got, want):
        """Streamed results against resident ones: min programs and their
        planes bit for bit with equal superstep counts, the PageRanks
        within rtol=1e-5; -> max abs deviation of the float programs."""
        import numpy as np

        devs = {}
        for key, result in got.items():
            if key in ("served", "served_programs"):
                continue
            (g, it), (w, wit) = result, want[key]
            exact = key.split("/")[0] in ("sssp", "bfs", "labelprop")
            if exact:
                ok = np.array_equal(g, w) and np.array_equal(it, wit)
            else:
                ok = (np.allclose(g, w, rtol=1e-5, atol=1e-7)
                      and np.array_equal(it, wit))
                devs[key] = float(np.max(np.abs(g - w)))
            if not ok:
                raise AssertionError(f"streamed {key} differs from resident "
                                     f"(supersteps {it} / {wit})")
        for prog, (g, it), (w, wit) in zip(got["served_programs"],
                                           got["served"], want["served"]):
            ok = (np.array_equal(g, w) if prog != "ppr"
                  else np.allclose(g, w, rtol=1e-5, atol=1e-7))
            if not ok or it != wit:
                raise AssertionError(f"a served {prog} row differs from the "
                                     "resident server's")
        return devs

    def stream(self):
        """Out-of-core streaming on the main graphs; see the module
        docstring."""
        import shutil

        import numpy as np
        import torch

        from repro_torch.core import Engine, StreamConfig
        from repro_torch.core import graph as G
        from repro_torch.kernels import push_fused

        steps, clock = {}, [time.perf_counter()]

        def step(name):
            now = time.perf_counter()
            steps[name] = round(now - clock[0], 3)
            clock[0] = now
            emit({"stream_step": name, "seconds": steps[name]})

        pgw, pgu, builds = self._stream_builds()
        step("builds")
        total = pgw.shard_source(windows=1).total_edge_bytes
        total_u = pgu.shard_source(windows=1).total_edge_bytes
        budget, budget_u = int(0.20 * total), int(0.20 * total_u)
        rng = np.random.default_rng(7)
        live = np.flatnonzero(self.gw.out_degrees > 0)
        sources = [0] + [int(s) for s in rng.choice(live, 15, replace=False)]
        seeds = [s if i % 3 else (s, int(live[i]), int(live[-i - 1]))
                 for i, s in enumerate(sources)]

        def timed(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        # resident grid(1,1) first: its results, seconds and memory peak
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res = Engine(pgw)
        want = self._stream_cases(res, sources, seeds)
        _, t_res = timed(lambda: res.run("sssp"))
        peak_res = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res_u = Engine(pgu)
        want_lp = res_u.run("labelprop")
        peak_res_u = torch.cuda.max_memory_allocated()
        chain = self._block_chain()
        pgc = G.partition(chain, 1, "grid(1,1)")
        want_chain = Engine(pgc).run("bfs", source=0)
        step("resident cases")
        del res, res_u
        for pg in (pgw, pgu, pgc):
            pg._dev.clear()  # no resident plane for a streamed engine to see
        torch.cuda.empty_cache()

        # streamed: the same runs under the 20% budget
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = Engine(pgw, residency="stream",
                     stream=StreamConfig(budget_bytes=budget))
        held = torch.cuda.memory_allocated() - base  # vertex planes, bands
        st = dict(eng.dispatch["stream"])
        if not (st["resident_edge_bytes"] <= budget < st["total_edge_bytes"]
                and st["edge_fraction_resident"] <= 0.25):
            raise AssertionError(f"stream sizing {st}")
        if any(k[0].startswith(("dense", "gate")) for k in pgw._dev):
            raise AssertionError("the streamed engine uploaded a resident "
                                 "layout")
        launches = {}
        push_fused.reset_launch_counts()
        got, it = eng.run("sssp")
        launches["sssp"] = dict(push_fused.launch_counts)
        fetched = eng.dispatch["stream"]["fetches"]
        if not launches["sssp"]["fused_push_min"] == fetched \
                == it * st["windows"]:
            raise AssertionError(f"streamed sssp: {launches['sssp']} for "
                                 f"{fetched} window folds")
        # a single-query run's working set: the two device slots and at
        # most 16 vertex planes of temporaries beside what the engine holds
        peak_single = torch.cuda.max_memory_allocated() - base
        single_bound = held + 2 * st["window_bytes"] \
            + 16 * pgw.num_chunks * pgw.chunk_size * 4
        step("streamed sssp, launches counted")
        got = self._stream_cases(eng, sources, seeds, launches)
        step("streamed cases")
        for prog in ("bfs", "pagerank", "pagerank_weighted"):
            combine = "min" if prog == "bfs" else "add"
            if launches[prog][f"fused_push_{combine}"] != \
                    got[prog][1] * st["windows"]:
                raise AssertionError(f"streamed {prog}: {launches[prog]} for "
                                     f"{got[prog][1]} supersteps")
        devs = self._stream_held(got, want)
        again = eng.run("pagerank")[0]
        if not np.array_equal(again, got["pagerank"][0]):
            raise AssertionError("two streamed pagerank runs differ")
        serial = {p: self._reference(p, self.gw, "main")[0]
                  for p in ("pagerank", "pagerank_weighted")}
        serial_err = {p: float(np.max(np.abs(got[p][0] - serial[p])))
                      for p in serial}
        if not all(e < 1e-3 for e in serial_err.values()):
            raise AssertionError(f"streamed pagerank vs serial {serial_err}")
        peak_str = torch.cuda.max_memory_allocated()
        if not peak_single <= single_bound:
            raise AssertionError(f"streamed peak {peak_single} B above "
                                 f"the engine's {held} + 2 windows + 16 "
                                 f"vertex planes ({single_bound})")
        if not peak_str < peak_res:
            raise AssertionError(f"streamed peak {peak_str} B not below the "
                                 f"resident {peak_res}")

        # seconds: resident, streamed, serialized; the gate
        (out_s, it_s), t_str = timed(lambda: eng.run("sssp"))
        pipelined = dict(eng.dispatch["stream"])
        eng0 = Engine(pgw, residency="stream",
                      stream=StreamConfig(budget_bytes=budget, prefetch=False))
        (out_0, it_0), t_ser = timed(lambda: eng0.run("sssp"))
        serialized = dict(eng0.dispatch["stream"])
        del eng0
        gated = {}
        for prog in ("sssp", "bfs"):
            g, it = eng.run(prog, gate="frontier")
            if not (np.array_equal(g, want[prog][0]) and it == want[prog][1]):
                raise AssertionError(f"gated streamed {prog} differs")
            gated[prog] = eng.dispatch["stream"]["fetch_skip_fraction"]
        if not (np.array_equal(out_0, want["sssp"][0])
                and it_0 == want["sssp"][1]):
            raise AssertionError("serialized streamed sssp differs")

        # the batched plane's edge bytes per query: B=16 against the same
        # 16 queries one at a time.  Run alone, query i fetches every
        # window in each of its own supersteps (q_it[i], equal to its B=1
        # count); two of them are run at B=1 to hold that to the
        # prefetcher's count, the rest take their q_it from the plane
        _, t16 = timed(lambda: eng.run_batch("sssp", sources=sources,
                                             batch=16))
        per_q16 = eng.dispatch["stream"]["fetched_bytes_per_query"]
        sweep = eng.dispatch["stream"]["fetched_bytes"] \
            / eng.dispatch["stream"]["supersteps"]
        q_it = want["sssp/B16"][1]
        b1 = []
        for i in (0, 1):
            _, t1 = timed(lambda: eng.run_batch("sssp", sources=[sources[i]],
                                                batch=1))
            d = eng.dispatch["stream"]
            if d["fetched_bytes"] != q_it[i] * sweep:
                raise AssertionError(f"B=1 query {i}: {d['fetched_bytes']} "
                                     f"B for {q_it[i]} supersteps")
            b1.append(t1)
        per_q1 = float(np.mean(q_it)) * sweep
        if not per_q16 <= per_q1 / 8:
            raise AssertionError(f"B=16 fetches {per_q16} B per query, the "
                                 f"same queries one at a time {per_q1}")
        step("gate, serialized, bytes per query")
        windows = self._window_kernels(eng, launches)
        step("windowed kernels")
        del eng
        torch.cuda.empty_cache()

        # labelprop on the symmetrized graph, and the gate on the chain
        torch.cuda.reset_peak_memory_stats()
        eng_u = Engine(pgu, residency="stream",
                       stream=StreamConfig(budget_bytes=budget_u))
        lp = eng_u.run("labelprop")
        peak_str_u = torch.cuda.max_memory_allocated()
        if not (np.array_equal(lp[0], want_lp[0]) and lp[1] == want_lp[1]):
            raise AssertionError("streamed labelprop differs")
        if not peak_str_u < peak_res_u:
            raise AssertionError(f"streamed labelprop peak {peak_str_u} B "
                                 f"not below the resident {peak_res_u}")
        st_u = dict(eng_u.dispatch["stream"])
        del eng_u
        ceng = Engine(pgc, residency="stream", stream=StreamConfig(windows=4))
        g, it = ceng.run("bfs", source=0, gate="frontier")
        chain_skip = ceng.dispatch["stream"]["fetch_skip_fraction"]
        if not (np.array_equal(g, want_chain[0]) and it == want_chain[1]
                and chain_skip >= 0.4):
            raise AssertionError(f"gated chain bfs: skip {chain_skip}")
        step("labelprop, chain")

        # the layout cache at scale: cold (build + persist), warm (mmap)
        cache = ROOT / "build" / "stream_cache"
        shutil.rmtree(cache, ignore_errors=True)
        try:
            prep = lambda: G.partition(
                self.gw, 1, "grid(1,1)", eager=False).shard_source(
                    budget_bytes=budget, cache_dir=str(cache))
            _, t_cold = timed(prep)  # relabel, build on the card, persist
            sb, t_warm = timed(prep)  # relabel, memory-map
            if sb.origin != "disk":
                raise AssertionError("the warm layout cache missed")
            warm = Engine(G.partition(self.gw, 1, "grid(1,1)", eager=False),
                          residency="stream", stream=StreamConfig(
                              budget_bytes=budget, cache_dir=str(cache)))
            if warm.dispatch["stream"]["origin"] != "disk":
                raise AssertionError("the warm layout cache missed")
            g, it = warm.run("sssp")
            if not (np.array_equal(g, want["sssp"][0])
                    and it == want["sssp"][1]):
                raise AssertionError("warm-cache streamed sssp differs")
            del warm
        finally:
            shutil.rmtree(cache, ignore_errors=True)
        step("layout cache")

        def rates(d):
            keep = ("copy_s", "stall_s", "overlap_efficiency", "h2d_s",
                    "h2d_bytes", "fetched_bytes", "fetches",
                    "edge_bandwidth_bytes_per_s")
            out = {k: d[k] for k in keep}
            out["h2d_bytes_per_s"] = (d["h2d_bytes"] / d["h2d_s"]
                                      if d["h2d_s"] else 0.0)
            return out

        return {
            "builds": builds, "sizing": st, "labelprop_sizing": st_u,
            "supersteps": it_s,
            "resident_s": t_res, "streamed_s": t_str, "serialized_s": t_ser,
            "superstep_resident_s": t_res / it_s,
            "superstep_streamed_s": t_str / it_s,
            "superstep_serialized_s": t_ser / it_0,
            "pipelined": rates(pipelined), "serialized": rates(serialized),
            "gate_fetch_skip_fraction": gated,
            "chain_fetch_skip_fraction": chain_skip,
            "bytes_per_query": {"B1_mean_of_16": per_q1, "B16": per_q16,
                                "ratio": per_q16 / per_q1,
                                "query_supersteps": [int(x) for x in q_it]},
            "queries_per_s": {"B1": 1 / float(np.mean(b1)),
                              "B16": 16 / t16},
            "step_s": steps,
            "cache_cold_s": t_cold, "cache_warm_s": t_warm,
            "peak_device_bytes": {
                "resident": peak_res, "streamed": peak_str,
                "streamed_single_over_base": peak_single,
                "single_bound": single_bound, "engine_held": held,
                "resident_labelprop": peak_res_u,
                "streamed_labelprop": peak_str_u},
            "launches": {p: {k: n for k, n in c.items() if n}
                         for p, c in launches.items()},
            "max_abs_dev_vs_resident": devs,
            "max_abs_err_vs_serial": serial_err,
            "windowed_kernels": windows,
        }

    def _window_kernels(self, eng, launches):
        """The fused min and the fused add on one window of the streamed
        sssp/pagerank table (a middle window, from a pinned staging slot),
        seeded with a non-identity init, with the window's rectangle gated
        off and on: each held against ``fused_push_plain`` with the same
        init and gate, then timed (gate on and off in turns) beside the
        plain version and the bound on the window's bytes (the init read
        besides).  Each goes on the kernels line as ``<kernel>/window``."""
        import torch

        from repro_torch.kernels import push_fused
        from repro_torch.kernels.blocks import BLOCK_S, BLOCK_V

        sb = eng._source
        k = min(1, sb.num_windows - 1)
        staging = sb.make_staging(pin_memory=True)
        sb.read_window(k, staging)
        wd = {n: t.to("cuda") for n, t in
              sb.staged_views(staging["buffer"]).items()}
        band = eng._win_bands[k]
        P = eng._C
        V = eng._K + (-eng._K) % BLOCK_V  # the padded widths ops.push passes
        S = eng._grid_meta[1] * eng._grid_meta[2]
        S += (-S) % BLOCK_S
        gen = torch.Generator(device="cuda").manual_seed(11)
        out = {}
        for combine, weighted, prog in (("min", True, "sssp"),
                                        ("add", False, "pagerank")):
            if combine == "min":
                vals = torch.rand((P, V), generator=gen, device="cuda") * 100
                vals[:, ::3] = push_fused.SENTINEL_F32  # a third unreached
                init = torch.rand((P, S), generator=gen, device="cuda") * 100
                init[:, 1::3] = push_fused.SENTINEL_F32
            else:
                vals = torch.rand((P, V), generator=gen, device="cuda")
                init = torch.rand((P, S), generator=gen, device="cuda")
            w = wd["gr_edge_weight"] if weighted else None
            name = f"fused_push_{combine}/window"

            def call(ra, fn=push_fused.fused_push):
                return fn(band, wd["gr_src_local"], wd["gr_dst_col"],
                          wd["gr_edge_valid"], w, vals, S, combine=combine,
                          init=init, row_active=ra)

            on = torch.ones(P, dtype=torch.int32, device="cuda")
            off = torch.zeros(P, dtype=torch.int32, device="cuda")
            errs = []
            for ra in (on, off):
                got, want = call(ra), call(ra, push_fused.fused_push_plain)
                torch.cuda.synchronize()
                errs.append(self.compare(got, want, combine, name))
            if not torch.equal(call(off), init):
                raise AssertionError(f"{name}: a gated rectangle lost init")
            if not torch.equal(call(on), call(on)) or (
                    combine == "min" and not torch.equal(call(on),
                                                         call(None))):
                raise AssertionError(f"{name}: repeated calls differ")
            m1, g1 = self.cuda_ms(lambda: call(on), 20), \
                self.cuda_ms(lambda: call(off), 20)
            g2, m2 = self.cuda_ms(lambda: call(off), 20), \
                self.cuda_ms(lambda: call(on), 20)
            plain_ms = self.cuda_ms(
                lambda: call(on, push_fused.fused_push_plain), 3)
            live = int((band[:, 1] >= 0).sum())
            per_edge = 12 + (4 if weighted else 0)
            nbytes = (band.numel() * 4 + live * 256 * per_edge
                      + vals.numel() * 4 + 2 * init.numel() * 4)
            ops = 2 * int(wd["gr_edge_valid"].sum())
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           ops / FP32_OPS_PER_S) * 1e3
            n = launches[prog][f"fused_push_{combine}"]
            out[name] = {"window": k, "edges": int(wd["gr_edge_valid"].sum()),
                         "ms": min(m1, m2), "gated_off_ms": min(g1, g2),
                         "turns_ms": {"on": [m1, m2], "off": [g1, g2]},
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bytes": nbytes, "max_abs_err": max(errs),
                         "launches": n}
            self.kernel_rows[name] = {
                "name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/push_fused.cu",
                "replaces": ("src/repro/kernels/push_fused.py:104"
                             if combine == "min"
                             else "src/repro/kernels/push_fused.py:54"),
                "launches": n, "max_abs_err": max(errs), "ms": min(m1, m2),
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S
                >= ops / FP32_OPS_PER_S else "operations",
                "library_ms": None,
                "timed_call": f"{prog} window {k} of {sb.num_windows}, "
                              "grid(1,1), init-seeded, rectangle active "
                              "(gated off: gated_off_ms)",
                "gated_off_ms": min(g1, g2)}
        del staging, wd
        return out

    def quickstart(self):
        """The port's quickstart twin on the card, at its default scale."""
        from repro_torch import quickstart

        checks = quickstart.main([])
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"quickstart checks failed: {failed}")
        return {"checks": checks}


PHASES = ("device", "build", "kernels", "graph", "main", "reproducible",
          "batch", "serve", "grid", "replan", "async", "stream", "cost",
          "staged_main", "profile", "kernel_time", "kernels_main", "chares",
          "push_choice", "quickstart", "lm", "train")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="log2 vertices of the main-path graph")
    ap.add_argument("--chare-scale", type=int, default=18,
                    help="log2 vertices of the chare-axis graph")
    ap.add_argument("--chares", type=int, default=8)
    ap.add_argument("--cost-scale", type=int, default=16,
                    help="log2 vertices of the paper graphs of phase cost")
    args = ap.parse_args(argv)
    if not (PORT / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PORT} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(args)
    try:
        for name in PHASES:
            smoke.phase(name, getattr(smoke, {"async": "async_modes"}.get(
                name, name)))
    except Exception:  # report the failing phase, print no ok line
        traceback.print_exc()
        return 1
    emit({"kernels": list(smoke.kernel_rows.values())})
    print(smoke.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": smoke.kind,
                                 "count": __import__("torch").cuda
                                 .device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
