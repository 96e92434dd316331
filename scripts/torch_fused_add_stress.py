#!/usr/bin/env python3
"""Repeat the first case of ``chip_smoke.py``'s phase ``kernels`` many times
on one GPU (the PyTorch/CUDA port, ``src/repro_torch``): the fused float add
(no weight, one column) over random edges on three chare rows (4,096 edges,
1,024 sources and segments), held to ``fused_push_plain`` on every call.

    python3 scripts/torch_fused_add_stress.py [--processes 12] \
        [--calls 3] [--loop 3000]

First ``--processes`` fresh processes each build and load the kernels and
check ``--calls`` draws (the very first launch of a process included), then
one process checks ``--loop`` draws.  Each draw runs the kernel twice and
the plain version once; a call whose result is more than 1e-4 from the
plain version's (sums of about two normal values a segment: the float
order alone moves them by about 1e-7) is reported with the first segments
that differ.  Prints one JSON line per stage.  Exits non-zero without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def check(draws, seed):
    """-> the mismatching calls among ``draws`` random draws."""
    import numpy as np
    import torch

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.push_fused import fused_push, fused_push_plain

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    for name in ("push_fused", "push_staged"):
        _build.build(name)
    dev = torch.device("cuda")
    C, E, V, S = 3, 4096, 1024, 1024
    bad = []
    for k in range(draws):
        rng = np.random.default_rng(seed * 100_000 + k)
        s, d, v = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
            rng.integers(0, V, (C, E)), rng.integers(0, S, (C, E)),
            rng.integers(0, 2, (C, E))))
        band = ops._bands_on_device(s, d, v, E // 256)
        gen = torch.Generator(device="cuda").manual_seed(k)
        vals = torch.randn((C, V), generator=gen, device="cuda")
        got = fused_push(band, s, d, v, None, vals, S, combine="add")
        want = fused_push_plain(band, s, d, v, None, vals, S, combine="add")
        again = fused_push(band, s, d, v, None, vals, S, combine="add")
        torch.cuda.synchronize()
        errs = [float((x - want).abs().max()) for x in (got, again)]
        if max(errs) > 1e-4:
            where = ((got - want).abs() > 1e-4).nonzero()[:5].tolist()
            bad.append({"draw": k, "max_abs_err": errs, "where": where,
                        "got": [float(got[i, j]) for i, j in where],
                        "want": [float(want[i, j]) for i, j in where]})
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=12)
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--loop", type=int, default=3000)
    ap.add_argument("--child", type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child is not None:
        print("RESULT " + json.dumps(check(args.calls, args.child)))
        return 0
    t0 = time.perf_counter()
    fresh = []
    for p in range(args.processes):
        out = subprocess.run(
            [sys.executable, __file__, "--child", str(p), "--calls",
             str(args.calls)], capture_output=True, text=True)
        lines = [x for x in out.stdout.splitlines() if x.startswith("RESULT")]
        if out.returncode or not lines:
            print(out.stderr[-2000:], file=sys.stderr)
            return 1
        fresh += json.loads(lines[0][len("RESULT "):])
    print(json.dumps({"stage": "fresh processes", "processes": args.processes,
                      "draws": args.processes * args.calls,
                      "kernel_calls": 2 * args.processes * args.calls,
                      "mismatches": fresh,
                      "seconds": time.perf_counter() - t0}), flush=True)
    t0 = time.perf_counter()
    loop = check(args.loop, args.processes)
    print(json.dumps({"stage": "one process", "draws": args.loop,
                      "kernel_calls": 2 * args.loop, "mismatches": loop,
                      "seconds": time.perf_counter() - t0}), flush=True)
    return 1 if fresh or loop else 0


if __name__ == "__main__":
    sys.exit(main())
