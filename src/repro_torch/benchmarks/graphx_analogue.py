"""The paper's GraphX baseline, reproduced in spirit (Figures 1-2), on torch.

The twin of ``benchmarks/graphx_analogue.py``.  GraphX cannot run offline
(JVM/Spark), so this reproduces the *system design* the paper blames for
its COST = inf: a Pregel-style dataflow engine that materializes an
edge-triplet join per superstep -- source attributes joined to every edge,
messages materialized edge-wide, then grouped by destination -- instead of
the actor engine's in-place per-chare aggregation.  Same algorithm, same
result; the overhead is the data movement the dataflow abstraction forces.
Writing it in plain torch ops (``index_select``, ``index_add_``,
``scatter_reduce_``) is its design: it is the "big data system" stand-in,
not the port of a kernel.

The comparison landscape:
    serial (Listing 1)  <-  the COST baseline
    actor engine        <-  repro_torch.core
    dataflow analogue   <-  this module

Both programs run on CUDA unless ``device`` names another, and return numpy
(the copy back waits for the device).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.cost import _time
from repro_torch.core.engine import resolve_device
from repro_torch.core.graph import Graph

_INT_MAX = torch.iinfo(torch.int32).max


def _edges(graph: Graph, device):
    src = torch.from_numpy(graph.src.astype(np.int64)).to(device)
    dst = torch.from_numpy(graph.dst.astype(np.int64)).to(device)
    return src, dst


def pagerank_dataflow(graph: Graph, alpha=0.85, iters=20, device=None):
    """Pregel-with-triplet-join PageRank (GraphX's aggregateMessages)."""
    device = resolve_device(device)
    n = graph.num_vertices
    src, dst = _edges(graph, device)
    deg = torch.from_numpy(np.maximum(np.diff(graph.indptr), 1)
                           .astype(np.float32)).to(device)
    ranks = torch.zeros(n, dtype=torch.float32, device=device)
    for _ in range(iters):
        # 1) join: vertex attrs -> every edge (the materialized triplets)
        triplet_src_rank = ranks.index_select(0, src)  # [E]
        triplet_src_deg = deg.index_select(0, src)  # [E] (re-joined)
        # 2) message per edge, materialized edge-wide
        msgs = alpha * triplet_src_rank / triplet_src_deg
        # 3) group-by destination (shuffle)
        summed = torch.zeros(n, dtype=torch.float32, device=device)
        summed.index_add_(0, dst, msgs)
        ranks = (1 - alpha) + summed
    return ranks.cpu().numpy()


def labelprop_dataflow(graph: Graph, max_iters=10_000, device=None):
    """Min-label propagation as a triplet join and a group-by min; returns
    (labels, supersteps)."""
    device = resolve_device(device)
    n = graph.num_vertices
    src, dst = _edges(graph, device)
    labels = torch.arange(n, dtype=torch.int32, device=device)
    for it in range(max_iters):
        msgs = labels.index_select(0, src)  # triplet join
        grouped = torch.full((n,), _INT_MAX, dtype=torch.int32,
                             device=device)
        grouped.scatter_reduce_(0, dst, msgs, reduce="amin")
        new = torch.minimum(labels, grouped)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            return labels.cpu().numpy(), it + 1
    return labels.cpu().numpy(), max_iters


def bench(fn, repeats=3, device=None):
    """Best of ``repeats`` host-clock seconds of ``fn`` after one untimed
    call (the paper times compute only), the device synchronized around
    each."""
    fn()
    return _time(fn, resolve_device(device), repeats)
