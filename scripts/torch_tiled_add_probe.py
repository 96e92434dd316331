#!/usr/bin/env python3
"""Where the tiled fused add's time goes, on one GPU (the PyTorch/CUDA port,
``src/repro_torch``).

    python3 scripts/torch_tiled_add_probe.py [--layouts rmat:18:8 er:22:8]

A layout is ``kind:scale:C``: the RMAT soc-LiveJournal1 stand-in (``rmat``)
or ``erdos_renyi(2^scale, 2^(scale+1))`` (``er``), partitioned over C
chares, its sd layout on the card.  For each layout and B in {1, 4} it
times three calls on the same operands, CUDA-event means over 20 calls in
turns: the tiled add as planned (a chunk's segment range split into pieces
of at most ``push_fused.TILE_PIECE_BLOCKS`` blocks, one CTA each), the
tiled add with one CTA per chunk (a plan made with the split turned off),
and the atomic add.  The two tiled calls must agree bit for bit and with
the plain version.  At B=1 it then times each CTA of the tile pass under
both plans: an instrumented copy of ``csrc/push_fused.cu``, built under
``build/probe/``, stamps ``%globaltimer`` at each CTA's start and end.
One JSON line per layout and B.  Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

MAX_CTAS = 1 << 20  # CTAs the instrumented build can stamp


def cuda_ms(fn, iters=20):
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


def probe_source():
    """csrc/push_fused.cu with a start and an end stamp per CTA of the tile
    pass, readable through ``probe_read``."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "push_fused.cu").read_text()
    edits = [
        ("namespace {\n",
         "namespace {\n__device__ unsigned long long g_t0[%d], g_t1[%d];\n"
         % (MAX_CTAS, MAX_CTAS)),
        # the first ``B = a.B`` is the tile pass's
        ("  const int B = a.B;\n",
         "  const int B = a.B;\n  unsigned long long t0;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t0));\n"),
        ("      __syncthreads();\n    }\n  }\n}\n"
         "\n// One CTA per (row, segment",
         "      __syncthreads();\n    }\n  }\n  if (threadIdx.x == 0) {\n"
         "    unsigned long long t1;\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t1));\n"
         "    g_t0[blockIdx.x] = t0;\n    g_t1[blockIdx.x] = t1;\n  }\n}\n"
         "\n// One CTA per (row, segment"),
    ]
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"push_fused.cu changed: no {old!r} to edit")
        src = src.replace(old, new, 1)
    src += """
extern "C" int probe_clear() {
  void* p = nullptr;
  cudaGetSymbolAddress(&p, g_t0);
  cudaMemset(p, 0, sizeof(g_t0));
  cudaGetSymbolAddress(&p, g_t1);
  return static_cast<int>(cudaMemset(p, 0, sizeof(g_t1)));
}
extern "C" int probe_read(unsigned long long* t0, unsigned long long* t1,
                          long long n) {
  cudaMemcpyFromSymbol(t0, g_t0, n * sizeof(unsigned long long));
  return static_cast<int>(
      cudaMemcpyFromSymbol(t1, g_t1, n * sizeof(unsigned long long)));
}
"""
    return src


def instrumented_library():
    """Build ``probe_source()`` under build/probe/."""
    from repro_torch.kernels import _build

    src = probe_source()
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "push_fused_probe.cu").write_text(src)
    lib = out / "libpush_fused_probe.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib),
                    str(out / "push_fused_probe.cu")], check=True)
    return lib


def use_library(path):
    """Make push_fused launch from ``path`` (None: its own build)."""
    from repro_torch.kernels import _build, push_fused

    push_fused._lib = None
    if path is None:
        push_fused._library()
        return None
    load = _build.load
    _build.load = lambda name: ctypes.CDLL(str(path))
    try:
        return push_fused._library()
    finally:
        _build.load = load


def cta_times(lib, plan, call):
    """Per-CTA durations (µs) of one tile pass, with each CTA's work."""
    import numpy as np
    import torch

    work = plan.work.cpu().numpy()
    NC = plan.chunk_blocks.shape[1]
    cb = plan.chunk_blocks.cpu().numpy().reshape(-1, 2)
    n = len(work)
    if n > MAX_CTAS:
        raise ValueError(f"{n} CTAs, the probe stamps {MAX_CTAS}")
    lib.probe_clear()
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    t0 = np.zeros(n, np.uint64)
    t1 = np.zeros(n, np.uint64)
    lib.probe_read(t0.ctypes.data_as(ctypes.c_void_p),
                   t1.ctypes.data_as(ctypes.c_void_p), ctypes.c_longlong(n))
    base = int(t0.min())
    start = (t0.astype(np.int64) - base) / 1e3
    dur = (t1.astype(np.int64) - t0.astype(np.int64)) / 1e3
    top = np.argsort(-dur)[:5]
    span = (t1.astype(np.int64) - base) / 1e3
    return {
        "ctas": n, "span_us": float(span.max()),
        "us_p50_p90_p99_max": [float(np.percentile(dur, q))
                               for q in (50, 90, 99, 100)],
        "slowest": [{"row": int(work[i, 0]) // NC,
                     "chunk": int(work[i, 0]) % NC,
                     "chunk_blocks": cb[work[i, 0]].tolist(),
                     "piece": work[i, 1:].tolist(),
                     "start_us": round(float(start[i]), 1),
                     "us": round(float(dur[i]), 1)} for i in top],
    }


def probe(kind, scale, C, lib):
    import torch

    from repro_torch.core import graph as G
    from repro_torch.kernels import push_fused as pf

    g = (G.erdos_renyi(1 << scale, 2 << scale, seed=1) if kind == "er"
         else G.load_dataset("soc-lj1-mini", scale_log2=scale, seed=1))
    pg = G.partition(g, C)
    a = pg.device_arrays("sd", "cuda")
    K = pg.chunk_size
    band = a["sd_band"]
    pieces = pf.TILE_PIECE_BLOCKS
    pf.TILE_PIECE_BLOCKS = 1 << 30
    try:
        whole = band.clone()  # its own table, so its own plan
        plan_whole = pf.tile_plan(whole)
    finally:
        pf.TILE_PIECE_BLOCKS = pieces
    plan = pf.tile_plan(band)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for B in (1, 4):
        vals = torch.rand((C, K) + ((B,) if B > 1 else ()), generator=gen,
                          device="cuda")
        edges = (a["sd_src_local"], a["sd_dst_global"], a["sd_edge_valid"],
                 None, vals, C * K)
        calls = {"pieces": lambda: pf.fused_push(band, *edges),
                 "whole": lambda: pf.fused_push(whole, *edges),
                 "atomic": lambda: pf.fused_push_atomic(band, *edges)}
        got, same = calls["pieces"](), calls["whole"]()
        want = pf.fused_push_plain(band, *edges)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), same.view(torch.int32)):
            raise AssertionError(f"{kind}{scale} C={C} B={B}: the pieces "
                                 "changed the bits")
        top = float(want.abs().max())
        err = float((got - want).abs().max())
        if err > 1e-5 * top + 1e-6 * top:
            raise AssertionError(f"{kind}{scale} C={C} B={B}: max abs err "
                                 f"{err} against the plain version")
        ms = {k: [] for k in calls}
        for k in ("pieces", "whole", "atomic", "atomic", "whole", "pieces"):
            ms[k].append(cuda_ms(calls[k]))
        row = {"layout": f"{kind}:{scale}:{C}", "edges": g.num_edges, "B": B,
               "ctas": {"pieces": plan.work.shape[0],
                        "whole": plan_whole.work.shape[0]},
               "ms": ms, "max_abs_err": err}
        if B == 1:
            inst = use_library(lib)
            row["cta_us"] = {
                "pieces": cta_times(inst, plan, calls["pieces"]),
                "whole": cta_times(inst, plan_whole, calls["whole"])}
            use_library(None)
        print(json.dumps(row), flush=True)
        del got, same, want
    del a, band, whole
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layouts", nargs="+",
                    default=["rmat:18:8", "rmat:18:4", "er:22:8",
                             "rmat:22:1"])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: the probe needs a GPU",
              file=sys.stderr)
        return 2
    lib = instrumented_library()
    for spec in args.layouts:
        kind, scale, C = spec.split(":")
        probe(kind, int(scale), int(C), lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
