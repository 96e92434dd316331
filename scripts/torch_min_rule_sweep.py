#!/usr/bin/env python3
"""Which kernel the fused min should run on sparse sd layouts, on one GPU
(the PyTorch/CUDA port, ``src/repro_torch``).

    python3 scripts/torch_min_rule_sweep.py [--layouts rmat:18:8 er:22:8]

A layout is ``kind:scale:C``: the RMAT soc-LiveJournal1 stand-in (``rmat``)
or ``erdos_renyi(2^scale, 2^(scale+1))`` (``er``), weighted, partitioned
over C chares, its sd layout on the card.  For sssp-, bfs- and
labelprop-like operands at B=1 and B=4 it times, CUDA-event means over 20
calls in turns (each order run forwards and backwards, the better kept):

  planned  ``fused_push`` as ``push_fused.min_tiles`` plans the table
  tiled    every seg-sorted row on the tiled min (the rule's threshold 0)
  atomic   ``fused_push_atomic``: every row on the atomic kernel
  split    the rows with at least ``MIN_TILE_EDGES_PER_SEGMENT`` edges per
           segment of their chunks' ranges on the tiled kernel and the
           others on the atomic one (two launches, the second seeded with
           the first's result): what a rule per row would run

All four must give the plain version's bits.  One JSON line per layout and
call, with each row's edges per segment and the table's.  Exits non-zero
without CUDA.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


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


def densities(band, plan):
    """Edges per segment of the chunks' ranges: per row, and the table's."""
    import torch

    from repro_torch.kernels.blocks import BLOCK_E, BLOCK_S

    edges = (band[:, 3] >= 0).sum(dim=1).double() * BLOCK_E
    cb = plan.chunk_blocks.long()
    span = torch.where(cb[..., 1] >= cb[..., 0],
                       cb[..., 1] - cb[..., 0] + 1, 0).sum(dim=1) * BLOCK_S
    return (edges / span).tolist(), float(edges.sum() / span.sum())


def emptied(band, rows):
    """The band with ``rows``' edge blocks emptied (hi -1: skipped)."""
    out = band.clone()
    out[rows, 1] = -1
    out[rows, 3] = -1
    return out


def layout(spec):
    from repro_torch.core import graph as G

    kind, scale, chares = spec.split(":")
    scale, chares = int(scale), int(chares)
    g = (G.erdos_renyi(1 << scale, 1 << (scale + 1), seed=1) if kind == "er"
         else G.load_dataset("soc-lj1-mini", scale_log2=scale, seed=1))
    pg = G.partition(G.random_weights(g, seed=5), chares)
    return pg, pg.device_arrays("sd", "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layouts", nargs="+",
                    default=["rmat:18:8", "rmat:20:8", "er:22:8"])
    args = ap.parse_args(argv)
    import torch

    from repro_torch.kernels import push_fused as pf

    if not torch.cuda.is_available():
        print("torch_min_rule_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    rand = lambda *shape: torch.rand(shape, generator=gen, device="cuda")
    threshold = pf.MIN_TILE_EDGES_PER_SEGMENT
    for spec in args.layouts:
        pg, a = layout(spec)
        C, K = pg.num_chunks, pg.chunk_size
        band = a["sd_band"]
        plan = pf.tile_plan(band)
        per_row, table = densities(band, plan)
        dense = torch.tensor([d >= threshold for d in per_row],
                             device="cuda")
        pf.MIN_TILE_EDGES_PER_SEGMENT = 0.0  # plans that tile every row
        try:
            every, dense_only = band.clone(), emptied(band, ~dense)
            pf.tile_plan(every)
            pf.tile_plan(dense_only)
        finally:
            pf.MIN_TILE_EDGES_PER_SEGMENT = threshold
        sparse_only = emptied(band, dense)
        for prog, B in (("sssp", 1), ("bfs", 1), ("labelprop", 1),
                        ("sssp", 4), ("bfs", 4)):
            shape = (C, K) + ((B,) if B > 1 else ())
            if prog == "sssp":
                vals = torch.where(rand(*shape) < 0.5, rand(*shape) * 100,
                                   pf.SENTINEL_F32)
                w, unit = a["sd_edge_weight"], False
            elif prog == "bfs":
                vals = (rand(*shape) * 1e6).to(torch.int32)
                w, unit = None, True
            else:
                vals = torch.arange(C * K * B, device="cuda",
                                    dtype=torch.int32).reshape(shape)
                w, unit = None, False
            edges = (a["sd_src_local"], a["sd_dst_global"],
                     a["sd_edge_valid"], w, vals, C * K)
            kw = dict(combine="min", unit_weight=unit)

            def split():
                out = pf.fused_push(dense_only, *edges, **kw)
                return pf.fused_push_atomic(sparse_only, *edges, init=out,
                                            **kw)

            calls = {
                "planned": lambda: pf.fused_push(band, *edges, **kw),
                "tiled": lambda: pf.fused_push(every, *edges, **kw),
                "atomic": lambda: pf.fused_push_atomic(band, *edges, **kw),
                "split": split,
            }
            want = pf.fused_push_plain(band, *edges, **kw).view(torch.int32)
            turns = {}
            for name in list(calls) + list(calls)[::-1]:
                got = calls[name]()
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want):
                    raise AssertionError(f"{spec}/{prog}/B={B}: {name} "
                                         "differs from the plain version")
                turns.setdefault(name, []).append(cuda_ms(calls[name]))
            print(json.dumps({
                "layout": spec, "program": prog, "B": B,
                "ms": {k: min(t) for k, t in turns.items()},
                "planned_path": "tiled" if plan.min_tiled else "atomic",
                "edges_per_segment": {"table": table, "rows": per_row},
                "turns_ms": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
