"""PageRank: serial COST baseline (Listing 1) and engine entry point."""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.graph import Graph, partition


def pagerank_serial(graph: Graph, alpha: float = 0.85, iters: int = 20
                    ) -> np.ndarray:
    """Faithful port of the COST paper's Listing 1 (the single-thread
    baseline): push-style, f32, d computed from out-edges.

    Listing 1 leaves d=0 for sink vertices (whose b is then never read);
    we clip to 1 so b stays finite -- identical results, no benign NaNs.
    """
    n = graph.num_vertices
    a = np.zeros(n, dtype=np.float32)
    d = np.maximum(np.diff(graph.indptr), 1).astype(np.float32)
    src, dst = graph.src, graph.dst
    for _ in range(iters):
        b = alpha * a / d
        a = np.full(n, 1.0 - alpha, dtype=np.float32)
        # a[y] += b[x] over edges  (vectorized map_edges)
        a += np.bincount(dst, weights=b[src], minlength=n).astype(np.float32)
    return a


def pagerank_parallel(graph: Graph, num_pes: int, strategy: str = "sortdest",
                      alpha: float = 0.85, iters: int = 20,
                      segment_fn=None,
                      partitioner: str = "contiguous",
                      device=None, mesh=None) -> np.ndarray:
    pg = partition(graph, num_pes, partitioner=partitioner)
    eng = Engine(pg, strategy=strategy, segment_fn=segment_fn,
                 device=device, mesh=mesh)
    return eng.pagerank(alpha=alpha, iters=iters)
