"""Connected components via label propagation: serial baseline + parallel."""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import Engine
from repro_torch.core.graph import Graph, partition


def labelprop_serial(graph: Graph, max_iters: int = 10_000
                     ) -> tuple[np.ndarray, int]:
    """Serial min-label propagation (the COST baseline's algorithm): iterate
    l[y] = min(l[y], l[x]) over edges until a fixpoint.  ``graph`` should be
    undirected (the paper adds reverse edges first)."""
    n = graph.num_vertices
    labels = np.arange(n, dtype=np.int32)
    src, dst = graph.src, graph.dst
    for it in range(max_iters):
        new = labels.copy()
        np.minimum.at(new, dst, labels[src])
        if np.array_equal(new, labels):
            return labels, it + 1
        labels = new
    return labels, max_iters


def components_oracle(graph: Graph) -> np.ndarray:
    """Union-find ground truth (independent of label propagation)."""
    n = graph.num_vertices
    parent = np.arange(n)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for s, d in zip(graph.src, graph.dst):
        rs, rd = find(s), find(d)
        if rs != rd:
            parent[max(rs, rd)] = min(rs, rd)
    # canonical label: min vertex id in component
    out = np.empty(n, dtype=np.int32)
    for v in range(n):
        out[v] = find(v)
    return out


def labelprop_parallel(graph: Graph, num_pes: int, strategy: str = "sortdest",
                       segment_fn=None,
                       partitioner: str = "contiguous",
                       device=None, mesh=None) -> tuple[np.ndarray, int]:
    pg = partition(graph, num_pes, partitioner=partitioner)
    eng = Engine(pg, strategy=strategy, segment_fn=segment_fn,
                 device=device, mesh=mesh)
    return eng.labelprop()
