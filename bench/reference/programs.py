"""Plain references of the vertex programs the cells run.

Straight from the definitions, in plain torch over the CSR arrays that
``bench/graphgen.py`` made: one gather and one scatter over every edge a
superstep, no layouts, no kernels, nothing of the program under test.

* ``pagerank`` / ``pagerank_weighted``: a <- (1 - alpha) + sum over in-edges
  of alpha * a(u) * w / W(u), from a = 0, for ``iters`` supersteps; W(u) is
  u's out-degree (unit weights) or its out-weight sum, 1 where u has no
  out-edges.
* ``personalized_pagerank``: the same push from a = 0 with the teleport
  (1 - alpha) / |S| at the seeds only, then the scores normalised to sum 1.
* ``bfs`` / ``sssp``: Jacobi relaxation to the fixpoint, d(v) <- min(d(v),
  min over in-edges of d(u) + w) (w = 1 for bfs, hop counts saturating at
  the int32 sentinel), counting supersteps as the engine does: the last,
  quiet one included.  Each superstep also records the vertices whose value
  changed in the one before (the seeds, first) and their out-edges: the
  least work that superstep needs.

``dtype`` sets the arithmetic: float64 for the PageRanks' truth, float32 for
the min programs (their exact semantics), and bfloat16 for the control.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

INT_SENTINEL = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class RefGraph:
    """The CSR arrays on one device, expanded to edge lists."""

    num_vertices: int
    src: torch.Tensor  # [E] int64
    dst: torch.Tensor  # [E] int64
    weight: torch.Tensor | None  # [E] float32, None when unweighted
    degree: torch.Tensor  # [V] int64 out-degrees

    @property
    def num_edges(self) -> int:
        return int(self.dst.shape[0])


def upload(indptr: np.ndarray, dst: np.ndarray, weight, device) -> RefGraph:
    indptr = torch.from_numpy(np.asarray(indptr, np.int64)).to(device)
    degree = indptr[1:] - indptr[:-1]
    V = int(degree.shape[0])
    src = torch.repeat_interleave(torch.arange(V, device=device), degree)
    w = (None if weight is None
         else torch.from_numpy(np.asarray(weight, np.float32)).to(device))
    return RefGraph(V, src, torch.from_numpy(np.asarray(dst, np.int64))
                    .to(device), w, degree)


def _norm(g: RefGraph, weighted: bool, dtype) -> torch.Tensor:
    """W(u): the out-weight sum (or out-degree), 1 for a vertex with none."""
    if weighted:
        W = torch.zeros(g.num_vertices, dtype=torch.float64,
                        device=g.src.device)
        W.index_add_(0, g.src, g.weight.to(torch.float64))
    else:
        W = g.degree.to(torch.float64)
    return torch.where(W > 0, W, 1.0).to(dtype)


def _push(g: RefGraph, b: torch.Tensor, w) -> torch.Tensor:
    """sum over in-edges of b(u) (* w): one gather and one scatter."""
    contrib = b.index_select(0, g.src)
    if w is not None:
        contrib = contrib * w
    out = torch.zeros_like(b)
    return out.index_add_(0, g.dst, contrib)


def pagerank(g: RefGraph, alpha: float = 0.85, iters: int = 20,
             weighted: bool = False, dtype=torch.float64) -> torch.Tensor:
    W = _norm(g, weighted, dtype)
    w = g.weight.to(dtype) if weighted else None
    a = torch.zeros(g.num_vertices, dtype=dtype, device=g.src.device)
    for _ in range(iters):
        a = (1.0 - alpha) + _push(g, alpha * a / W, w)
    return a


def personalized_pagerank(g: RefGraph, seeds, alpha: float = 0.85,
                          iters: int = 20, dtype=torch.float64
                          ) -> torch.Tensor:
    seeds = [int(seeds)] if np.isscalar(seeds) else [int(s) for s in seeds]
    W = _norm(g, False, dtype)
    t = torch.zeros(g.num_vertices, dtype=dtype, device=g.src.device)
    t[seeds] = 1.0 / len(seeds)
    a = torch.zeros_like(t)
    for _ in range(iters):
        a = (1.0 - alpha) * t + _push(g, alpha * a / W, None)
    s = a.sum()
    return a / s if s > 0 else a


@dataclasses.dataclass
class Traversal:
    """A min program's fixpoint and the least work of each superstep."""

    value: torch.Tensor  # [V]
    supersteps: int
    active_vertices: list  # per superstep: vertices that changed before it
    active_edges: list  # per superstep: their out-edges


def _fixpoint(g: RefGraph, value, identity, candidate, max_iters
              ) -> Traversal:
    """Relax ``value`` until a superstep changes nothing; ``candidate(value)``
    gives each edge's offer to its destination, in edge order."""
    changed = value != identity
    act_v, act_e = [], []
    for it in range(max_iters):
        act_v.append(int(changed.sum()))
        act_e.append(int(g.degree[changed].sum()))
        new = value.scatter_reduce(0, g.dst, candidate(value), "amin")
        changed = new != value
        value = new
        if not bool(changed.any()):
            return Traversal(value, it + 1, act_v, act_e)
    return Traversal(value, max_iters, act_v, act_e)


def bfs(g: RefGraph, source: int, max_iters: int = 10_000) -> Traversal:
    d = torch.full((g.num_vertices,), INT_SENTINEL, dtype=torch.int32,
                   device=g.src.device)
    d[int(source)] = 0
    return _fixpoint(
        g, d, INT_SENTINEL,
        lambda v: (torch.clamp(v, max=INT_SENTINEL - 1) + 1)
        .index_select(0, g.src), max_iters)


def sssp(g: RefGraph, source: int, max_iters: int = 10_000,
         dtype=torch.float32) -> Traversal:
    w = g.weight.to(dtype)
    d = torch.full((g.num_vertices,), float("inf"), dtype=dtype,
                   device=g.src.device)
    d[int(source)] = 0.0
    return _fixpoint(g, d, float("inf"),
                     lambda v: v.index_select(0, g.src) + w, max_iters)
