"""Vertex programs: the algorithm layer of the actor engine.

The twin of ``repro/core/programs.py``.  A ``VertexProgram`` is the
per-superstep contract:

    init(pg)            initial per-vertex state, [C, K] host array
    update(state, aux)  the value each vertex offers its out-edges
    edge_value(v, w)    per-edge transform of that value (None = identity);
                        with ``combiner`` this forms the semiring: PageRank
                        is (+, *), SSSP is (min, +), BFS is (min, +1)
    combiner            monoid folding edge contributions per destination
    apply(s, inc, aux)  next state from previous state + combined incoming
    fixed_iters         int -> fixed loop; None -> loop to quiescence with
                        frontier masking (quiesced vertices send the
                        combiner identity)

``update``/``edge_value``/``apply`` take torch tensors; ``init`` and the
serial references are numpy.  Ported programs: pagerank,
pagerank_weighted, labelprop, sssp, bfs.  ``personalized_pagerank`` and
``betweenness`` run on the batched plane (``Engine.run_batch``), which is
not ported yet (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.core import strategies as strat
from repro_torch.core.graph import Graph, PartitionedGraph

INT_SENTINEL = int(np.iinfo(np.int32).max)


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """One graph algorithm, expressed against the engine's superstep loop."""

    name: str
    key: tuple  # (name, sorted params)
    combiner: strat.Combiner
    init: Callable[[PartitionedGraph], np.ndarray]
    update: Callable  # (state [C, K], aux {name: [C, K]}) -> sent values
    edge_value: Callable | None  # (vals_at_src, weights) -> contribution
    apply: Callable  # (state, incoming, aux) -> new state
    # declarative twin of ``edge_value`` for the fused kernels: "weight"
    # means the canonical semiring transform over the layout's edge weights
    # (multiply for add, saturating add for min), "unit" the same with w=1
    # (BFS's hop count).  None + an edge_value means the transform is not
    # kernel-expressible and runs the plain staged path (CPU only).
    edge_semiring: str | None = None
    fixed_iters: int | None = None
    max_iters: int = 10_000


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """Registry entry: the factory plus everything harnesses need to run and
    validate the program without algorithm-specific branches."""

    name: str
    make: Callable[..., VertexProgram]
    serial: Callable  # (graph, **params) -> result or (result, iters)
    defaults: dict
    weighted: bool = False  # run on a weighted graph (stand-in weights)
    undirected: bool = False  # symmetrize the graph first
    exact: bool = False  # bitwise match vs serial (min programs)
    returns_iters: bool = False  # serial/parallel return (result, iters)
    table: str = "table2"  # benchmark table label

    def prepare_graph(self, g: Graph) -> Graph:
        if self.undirected:
            g = g.to_undirected()
        return g

    def run_serial(self, g: Graph, **params):
        """Serial reference result (iteration count stripped)."""
        out = self.serial(g, **{**self.defaults, **params})
        return out[0] if self.returns_iters else out

    def matches(self, got, ref) -> bool:
        got, ref = np.asarray(got), np.asarray(ref)
        if self.exact:
            return bool(np.array_equal(got, ref))
        return bool(np.max(np.abs(got - ref)) < 1e-3)


PROGRAMS: dict[str, ProgramSpec] = {}


def register(spec: ProgramSpec) -> ProgramSpec:
    if spec.name in PROGRAMS:
        raise ValueError(f"program {spec.name!r} already registered")
    PROGRAMS[spec.name] = spec
    return spec


def get_spec(name: str) -> ProgramSpec:
    if name not in PROGRAMS:
        raise ValueError(f"unknown program {name!r}; "
                         f"choose from {sorted(PROGRAMS)}")
    return PROGRAMS[name]


def registered_names() -> list[str]:
    return list(PROGRAMS)


def make_program(name: str, **params) -> VertexProgram:
    spec = get_spec(name)
    merged = {**spec.defaults, **params}
    unknown = set(merged) - set(spec.defaults)
    if unknown:
        raise TypeError(f"{name}: unknown params {sorted(unknown)}")
    return spec.make(**merged)


def run_parallel(graph: Graph, algorithm: str, num_pes: int = 1,
                 strategy: str = "sortdest", segment_fn=None, push_fn="auto",
                 partitioner: str = "contiguous", device=None, **params):
    """Partition + engine + run, in one call (tests and examples)."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import partition

    eng = Engine(partition(graph, num_pes, partitioner=partitioner),
                 strategy=strategy, push_fn=push_fn, segment_fn=segment_fn,
                 device=device)
    return eng.run(algorithm, **params)


def _cache_key(name: str, params: dict) -> tuple:
    return (name,) + tuple(sorted(params.items()))


def _f32(x):
    return x.to(torch.float32)


def _index_state(pg: PartitionedGraph, fill, dtype, source: int | None = None):
    """[C, K] state filled with ``fill``; ``source`` (an *original* vertex id,
    translated through the partitioner's relabel) set to 0."""
    n = pg.num_chunks * pg.chunk_size
    s = np.full(n, fill, dtype=dtype)
    if source is not None:
        if not 0 <= source < pg.graph.num_vertices:
            raise ValueError(f"source {source} out of range")
        s[pg.local_to_global == source] = 0
    return s.reshape(pg.num_chunks, pg.chunk_size)


# ---------------------------------------------------------------------------
# PageRank (paper Listing 2) and its weight-normalized variant
# ---------------------------------------------------------------------------


def _make_pagerank(alpha: float = 0.85, iters: int = 20) -> VertexProgram:
    return VertexProgram(
        name="pagerank",
        key=_cache_key("pagerank", dict(alpha=alpha, iters=iters)),
        combiner=strat.ADD,
        init=lambda pg: np.zeros((pg.num_chunks, pg.chunk_size), np.float32),
        update=lambda a, aux: alpha * a / _f32(aux["out_degree"]),
        edge_value=None,
        apply=lambda a, inc, aux: (1.0 - alpha + inc) * _f32(aux["vertex_valid"]),
        fixed_iters=iters,
    )


def _make_pagerank_weighted(alpha: float = 0.85, iters: int = 20) -> VertexProgram:
    """Weight-normalized push: a <- (1-alpha) + sum_in alpha * a * w / W(src)."""
    return VertexProgram(
        name="pagerank_weighted",
        key=_cache_key("pagerank_weighted", dict(alpha=alpha, iters=iters)),
        combiner=strat.ADD,
        init=lambda pg: np.zeros((pg.num_chunks, pg.chunk_size), np.float32),
        update=lambda a, aux: alpha * a / aux["out_weight"],
        edge_value=lambda v, w: v * w,
        edge_semiring="weight",
        apply=lambda a, inc, aux: (1.0 - alpha + inc) * _f32(aux["vertex_valid"]),
        fixed_iters=iters,
    )


def pagerank_weighted_serial(graph: Graph, alpha: float = 0.85,
                             iters: int = 20) -> np.ndarray:
    """Serial COST baseline for weighted PageRank (Listing 1 with the degree
    normalization replaced by the out-weight sum).  With unit weights this is
    exactly ``pagerank_serial``."""
    n = graph.num_vertices
    src, dst, w = graph.src, graph.dst, graph.edge_weights
    wsum = np.bincount(src, weights=w, minlength=n).astype(np.float32)
    W = np.where(wsum > 0, wsum, 1.0).astype(np.float32)
    a = np.zeros(n, dtype=np.float32)
    for _ in range(iters):
        b = alpha * a / W
        a = np.full(n, 1.0 - alpha, dtype=np.float32)
        a += np.bincount(dst, weights=b[src] * w, minlength=n).astype(np.float32)
    return a


# ---------------------------------------------------------------------------
# Label propagation (connected components)
# ---------------------------------------------------------------------------


def _make_labelprop(max_iters: int = 10_000) -> VertexProgram:
    def init(pg):
        # labels are ORIGINAL vertex ids (not padded ids), so the converged
        # min-label per component matches the serial reference bit-for-bit
        # under any partitioner permutation
        base = pg.local_to_global.reshape(pg.num_chunks, pg.chunk_size)
        return np.where(base >= 0, base, INT_SENTINEL).astype(np.int32)

    return VertexProgram(
        name="labelprop",
        key=_cache_key("labelprop", dict(max_iters=max_iters)),
        combiner=strat.MIN,
        init=init,
        update=lambda l, aux: l,
        edge_value=None,
        apply=lambda l, inc, aux: torch.minimum(l, inc),
        fixed_iters=None,
        max_iters=max_iters,
    )


# ---------------------------------------------------------------------------
# SSSP: min-plus over weighted edges
# ---------------------------------------------------------------------------


def _make_sssp(source: int = 0, max_iters: int = 10_000) -> VertexProgram:
    return VertexProgram(
        name="sssp",
        key=_cache_key("sssp", dict(source=source, max_iters=max_iters)),
        combiner=strat.FMIN,
        init=lambda pg: _index_state(pg, np.inf, np.float32, source),
        update=lambda d, aux: d,
        edge_value=lambda v, w: v + w,
        edge_semiring="weight",
        apply=lambda d, inc, aux: torch.minimum(d, inc),
        fixed_iters=None,
        max_iters=max_iters,
    )


def sssp_serial(graph: Graph, source: int = 0, max_iters: int = 10_000
                ) -> tuple[np.ndarray, int]:
    """Serial Bellman-Ford-style relaxation to fixpoint (Jacobi order, same
    superstep semantics as the engine; unreached vertices stay +inf)."""
    n = graph.num_vertices
    dist = np.full(n, np.inf, dtype=np.float32)
    dist[source] = 0.0
    src, dst, w = graph.src, graph.dst, graph.edge_weights
    for it in range(max_iters):
        new = dist.copy()
        np.minimum.at(new, dst, dist[src] + w)
        if np.array_equal(new, dist):
            return dist, it + 1
        dist = new
    return dist, max_iters


# ---------------------------------------------------------------------------
# BFS: reachability depth (min over hop counts)
# ---------------------------------------------------------------------------


def _bfs_hop(v, w):
    # saturating +1: unreached vertices (sentinel) must not wrap around
    return torch.clamp(v, max=INT_SENTINEL - 1) + 1


def _make_bfs(source: int = 0, max_iters: int = 10_000) -> VertexProgram:
    return VertexProgram(
        name="bfs",
        key=_cache_key("bfs", dict(source=source, max_iters=max_iters)),
        combiner=strat.MIN,
        init=lambda pg: _index_state(pg, INT_SENTINEL, np.int32, source),
        update=lambda d, aux: d,
        edge_value=_bfs_hop,  # +1 per hop, weights ignored
        edge_semiring="unit",
        apply=lambda d, inc, aux: torch.minimum(d, inc),
        fixed_iters=None,
        max_iters=max_iters,
    )


def bfs_serial(graph: Graph, source: int = 0, max_iters: int = 10_000
               ) -> tuple[np.ndarray, int]:
    """Serial BFS depth via min-plus rounds; unreached vertices keep the
    int32 sentinel (matching the engine's MIN identity)."""
    n = graph.num_vertices
    dist = np.full(n, INT_SENTINEL, dtype=np.int32)
    dist[source] = 0
    src, dst = graph.src, graph.dst
    for it in range(max_iters):
        new = dist.copy()
        hop = np.minimum(dist, INT_SENTINEL - 1) + 1
        np.minimum.at(new, dst, hop[src])
        if np.array_equal(new, dist):
            return dist, it + 1
        dist = new
    return dist, max_iters


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


def _pagerank_serial(graph, alpha=0.85, iters=20):
    from repro_torch.core.pagerank import pagerank_serial
    return pagerank_serial(graph, alpha, iters)


def _labelprop_serial(graph, max_iters=10_000):
    from repro_torch.core.labelprop import labelprop_serial
    return labelprop_serial(graph, max_iters)


register(ProgramSpec(
    name="pagerank", make=_make_pagerank, serial=_pagerank_serial,
    defaults=dict(alpha=0.85, iters=20), table="table2"))
register(ProgramSpec(
    name="labelprop", make=_make_labelprop, serial=_labelprop_serial,
    defaults=dict(max_iters=10_000), undirected=True, exact=True,
    returns_iters=True, table="table3"))
register(ProgramSpec(
    name="sssp", make=_make_sssp, serial=sssp_serial,
    defaults=dict(source=0, max_iters=10_000), weighted=True, exact=True,
    returns_iters=True, table="table4"))
register(ProgramSpec(
    name="bfs", make=_make_bfs, serial=bfs_serial,
    defaults=dict(source=0, max_iters=10_000), exact=True,
    returns_iters=True, table="table5"))
register(ProgramSpec(
    name="pagerank_weighted", make=_make_pagerank_weighted,
    serial=pagerank_weighted_serial, defaults=dict(alpha=0.85, iters=20),
    weighted=True, table="table6"))
