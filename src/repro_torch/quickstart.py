"""Quickstart of the port: the paper's system in a minute.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--scale 12]

The twin of ``examples/quickstart.py``.  Builds a power-law graph, runs
PageRank through the actor engine with every communication variant and with
the scatter kernel as the local combine (``segment_fn``), then connected
components, SSSP and BFS, checks each against the serial COST baselines,
and prints the per-variant wire-byte model.  Runs on CUDA unless
``--device cpu`` is given.  ``main`` returns its checks, so a caller can
assert on them; run as a script it exits non-zero if one fails.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.core import (Engine, bfs_serial, components_oracle,
                              pagerank_serial, partition, random_weights,
                              rmat, sssp_serial, wire_model)
from repro_torch.core.engine import resolve_device
from repro_torch.kernels import ops

VARIANTS = ("reduction", "sortdest", "basic", "pairs")
PAGERANK_TOL = 1e-3  # against the serial baseline (DESIGN.md section 6)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--scale", type=int, default=12,
                    help="log2 vertices of the graph")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no card: raise before any work
    checks = {}

    # a scaled-down twitter_rv stand-in: power-law, E/V ~ 24
    g = rmat(args.scale, 24 * (1 << args.scale), seed=1)
    print(f"graph: |V|={g.num_vertices:,} |E|={g.num_edges:,}")

    # --- PageRank: serial baseline (COST Listing 1) vs actor variants ------
    ref = pagerank_serial(g, alpha=0.85, iters=20)
    pg = partition(g, 1)
    print("\nPageRank (20 iters), max |err| vs serial baseline:")
    for variant in VARIANTS:
        got = Engine(pg, strategy=variant, device=dev).pagerank(alpha=0.85,
                                                                iters=20)
        err = float(np.max(np.abs(got - ref)))
        checks[f"pagerank/{variant}"] = err < PAGERANK_TOL
        print(f"  {variant:10s} {err:.2e}")

    # --- with the scatter kernel as the local combine -----------------------
    eng = Engine(pg, strategy="sortdest", push_fn=None,
                 segment_fn=ops.make_segment_fn(), device=dev)
    err = float(np.max(np.abs(eng.pagerank(alpha=0.85, iters=20) - ref)))
    checks["pagerank/sortdest+segment_fn"] = err < PAGERANK_TOL
    print(f"  sortdest+scatter-kernel: {err:.2e}")

    # --- connected components ----------------------------------------------
    gu = g.to_undirected()
    labels, iters = Engine(partition(gu, 1), strategy="sortdest",
                           device=dev).labelprop()
    ok = bool(np.array_equal(labels, components_oracle(gu)))
    checks["labelprop"] = ok
    print(f"\nlabel propagation: {len(np.unique(labels))} components in "
          f"{iters} iters, matches union-find oracle: {ok}")

    # --- SSSP + BFS: the same engine, different vertex programs -------------
    gw = random_weights(g, seed=2)
    dist, it_s = Engine(partition(gw, 1), strategy="sortdest",
                        device=dev).sssp(source=0)
    want, want_it = sssp_serial(gw, source=0)
    exact = bool(np.array_equal(dist, want)) and it_s == want_it
    checks["sssp"] = exact
    print(f"sssp from 0: reaches {int(np.isfinite(dist).sum())}/"
          f"{gw.num_vertices} vertices in {it_s} iters, bit-exact vs serial "
          f"Bellman-Ford: {exact}")
    hops, it_b = Engine(pg, strategy="sortdest", device=dev).bfs(source=0)
    want, want_it = bfs_serial(g, source=0)
    exact = bool(np.array_equal(hops, want)) and it_b == want_it
    checks["bfs"] = exact
    reached = hops[hops < np.iinfo(np.int32).max]
    print(f"bfs  from 0: max depth {int(reached.max())} in {it_b} iters, "
          f"bit-exact vs serial BFS: {exact}")

    # --- the paper's argument, quantified: bytes on the wire ----------------
    print("\nwire bytes/device/iteration (paper section IV):")
    for pes in (16, 64, 256):
        row = wire_model(g, pes)
        print(f"  P={pes:3d}: " + "  ".join(f"{k}={v:,.0f}"
                                            for k, v in row.items()))
    print("sortdest (local combine + reduce-scatter) halves 'reduction' at "
          "every scale -- the paper's Table 2 ordering.")
    return checks


if __name__ == "__main__":
    result = main()
    failed = [k for k, ok in result.items() if not ok]
    if failed:
        print(f"failed checks: {failed}", file=sys.stderr)
    sys.exit(1 if failed else 0)
