#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--scale 22] [--chare-scale 18] [--chares 8]

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
             ops.push() over the fused matrix, and its int saturation
  graph      the soc-LiveJournal1 stand-in (RMAT, 2^scale vertices, 14
             edges per vertex) and its partitions, built on the host
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
             ppr_iters=8; slo_factor=1.5) with the reference's two curve
             assertions, which must hold; throughput_table for bfs and
             PPR at B=16 with a budget of 8 supersteps (PPR beside the
             reference's 3x bar, a finding, not a check); and the CLI,
             python -m repro_torch.launch.serve --graph --scale 20
             --queries 64 --batch 8 --policy deadline --programs
             bfs,personalized_pagerank
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
             beforehand
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

Then one JSON line with every kernel's numbers (launches from the main
path for the fused pair, from staged_main for the staged four), the
``nvidia-smi`` name and power limit, and as the last line ``{"ok": true,
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
import pathlib
import subprocess
import sys
import time
import traceback

ROOT = pathlib.Path(__file__).resolve().parent
PORT = ROOT / "src" / "repro_torch"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, float32 outside tensor cores
ADD_RTOL = 1e-5


def emit(obj):
    print(json.dumps(obj), flush=True)


class Smoke:
    def __init__(self, args):
        self.args = args
        self.kernel_rows = {}
        self.refs = {}  # (graph key, program) -> serial reference

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
    def compare(got, want, combine, what):
        """Min and int sums bit-equal; float sums within the stated
        tolerance.  Returns the max abs error."""
        import torch

        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{what}: {tuple(got.shape)}/{got.dtype} vs "
                                 f"{tuple(want.shape)}/{want.dtype}")
        if combine == "min" or not got.dtype.is_floating_point:
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{what}: {bad} elements differ")
            return 0.0
        err = (got.double() - want.double()).abs()
        scale = float(want.double().abs().max()) if want.numel() else 0.0
        tol = 1e-6 * scale + ADD_RTOL * want.double().abs()
        if bool((err > tol).any()):
            raise AssertionError(f"{what}: max abs err {float(err.max())} "
                                 f"beyond rtol={ADD_RTOL}, "
                                 f"atol=1e-6*{scale}")
        return float(err.max()) if err.numel() else 0.0

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
        return self.compare(got, want, combine, what)

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
                "unfused_cases": unfused}

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
        for pg in (self.pgw, self.pgu):
            pg.sd_band  # build the sd layout (the only one C=1 sortdest reads)
        t_part = time.perf_counter() - t0
        return {"vertices": g.num_vertices, "edges": g.num_edges,
                "undirected_edges": self.gu.num_edges,
                "edges_per_vertex": round(g.num_edges / g.num_vertices, 3),
                "rmat_s": round(t_gen, 3), "to_undirected_s": round(t_und, 3),
                "partition_s": round(t_part, 3),
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
            band = eng.arrays["band" if eng.strategy == "reduction"
                              else "sd_band"]
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
        lt = tables.latency_table(engine=eng, B=B, loads=(0.25, 1.0, 4.0),
                                  queries_per_load=8 * B, ppr_iters=8,
                                  slo_factor=1.5)
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
                "device_busy_share": busy_ms / wall_ms if busy_ms else None,
                "by_kernel": [{"name": k[:90], "device_ms": ms, "calls": n}
                              for k, ms, n in rows[:10]]}

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
        return {"calls": rows, "staged_calls": self._staged_time()}

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
            raise AssertionError(f"{what}: the sd layout is not seg-sorted")
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
            raise AssertionError(f"{what}: the sd layout is not seg-sorted")
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
    def _bound(a, vals, S, weighted):
        """Least time for one call: the bytes it must move (band table, the
        edge planes of the non-empty edge blocks, vals read once, out
        written once) over HBM bandwidth, or its operations (one transform
        and one combine per valid edge and column) over the float32 rate,
        whichever is larger."""
        band = a["sd_band"]
        live_blocks = int((band[:, 1] >= 0).sum())
        per_edge = 12 + (4 if weighted else 0)
        B = vals[0, 0].numel()
        nbytes = (band.numel() * 4 + live_blocks * 256 * per_edge
                  + vals.numel() * vals.element_size()
                  + vals.shape[0] * S * B * vals.element_size())
        ops = 2 * int(a["sd_edge_valid"].sum()) * B
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

    def quickstart(self):
        """The port's quickstart twin on the card, at its default scale."""
        from repro_torch import quickstart

        checks = quickstart.main([])
        failed = [k for k, ok in checks.items() if not ok]
        if failed:
            raise AssertionError(f"quickstart checks failed: {failed}")
        return {"checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="log2 vertices of the main-path graph")
    ap.add_argument("--chare-scale", type=int, default=18,
                    help="log2 vertices of the chare-axis graph")
    ap.add_argument("--chares", type=int, default=8)
    args = ap.parse_args(argv)
    if not (PORT / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {PORT} not found; run from a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    smoke = Smoke(args)
    try:
        for name in ("device", "build", "kernels", "graph", "main",
                     "reproducible", "batch", "serve", "staged_main",
                     "profile",
                     "kernel_time",
                     "kernels_main",
                     "chares", "push_choice", "quickstart"):
            smoke.phase(name, getattr(smoke, name))
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
