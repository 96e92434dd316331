#!/usr/bin/env python3
"""The graph engine across the cards of one machine: ``chip_smoke.py``'s
phase ``mesh``, its part for two or more cards, alone.

    python3 scripts/torch_mesh_cards.py [--chare-scale 18] [--scale 22]

Builds the kernels, then spawns W = min(cards, 4) NCCL ranks, one per card
(``repro_torch.core.mesh.spawn``), on the chare-axis graph (2^chare-scale
vertices) at C=W: sortdest, reduction, pairs and basic and every grid shape
of W under both lowerings run pagerank, pagerank_weighted, sssp, bfs and
labelprop, each held to the one-device engine at C=W (min programs and
pairs bit for bit, the other adds within rtol=1e-5, equal supersteps) with
the collectives each superstep must issue; the median seconds of three
runs on the mesh and on one device, and rank 0's device time by kernel
over one sortdest pagerank and sssp run.  Then the adaptive modes on the
same graph (sssp replans, overlap plus the gate, streamed grids gated,
ungated and at B=8: bit for bit, equal gate and stream records), a served
load of bfs and personalized PageRank at B=8 (equal dispatch groups), and
the main graph (2^scale vertices) at C=W: pagerank, sssp and
overlap-plus-gate sssp, each against the one-device engine at C=W with
medians of three runs.  Prints one JSON line per phase, then the card's
name and power limit.  Exits non-zero with fewer than two cards.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chare-scale", type=int, default=18)
    ap.add_argument("--scale", type=int, default=22,
                    help="log2 vertices of the main graph")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("torch_mesh_cards: needs two or more CUDA devices",
              file=sys.stderr)
        return 2
    smoke = chip_smoke.Smoke(args)
    smoke.phase("device", smoke.device)
    smoke.phase("build", smoke.build)
    smoke.phase("mesh_cards", lambda: {"multi_card":
                                       smoke._mesh_multi_card()})
    print(smoke.smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
