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
serial references are numpy.  The batched extensions (``init_batch``,
``query_plane``, ``finalize_batch``, ``finalize``) build and read torch
tensors on the engine's device, so no ``[n, B]`` plane crosses to the host
until the result does.  Programs: pagerank, pagerank_weighted, labelprop,
sssp, bfs, and on the batched plane (``Engine.run_batch``)
personalized_pagerank and betweenness.
"""

from __future__ import annotations

import dataclasses
import weakref
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
    # --- batched multi-query extensions (DESIGN.md section 11) ---
    # init_batch(pg, seed_sets, device) -> [C, K, B] state plane on
    # ``device``, one query column per seed set; programs without it cannot
    # run under Engine.run_batch.
    init_batch: Callable | None = None
    # default seed list for programs that are *inherently* multi-source
    # (betweenness pivots); Engine.run routes such programs through the
    # batched plane + finalize automatically.
    sources: tuple | None = None
    # finalize(graph, seed_sets, plane [n, V]) -> final result, a tensor on
    # the plane's device: post-processing of the converged per-query planes
    # (e.g. the Brandes accumulation turning BFS depths into centrality).
    finalize: Callable | None = None
    # query_plane(pg, seed_sets, device) -> [C, K, B] per-query per-vertex
    # read-only operand (personalized PageRank's teleport vectors), exposed
    # to update/apply as ``aux["qplane"]``.
    query_plane: Callable | None = None
    # finalize_batch(graph, seed_sets, plane [n, V]) -> plane [n, V] on the
    # same device; applied by ``run_batch`` itself to every returned plane
    # (per-query row normalization), so direct run_batch callers and the
    # Engine.run routing see the same rows.
    finalize_batch: Callable | None = None


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
                 partitioner: str = "contiguous", replan=None,
                 sync: str = "barrier", gate=None, device=None, **params):
    """Partition + engine + run, in one call (tests and examples)."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import partition

    eng = Engine(partition(graph, num_pes, partitioner=partitioner),
                 strategy=strategy, push_fn=push_fn, segment_fn=segment_fn,
                 device=device)
    return eng.run(algorithm, replan=replan, sync=sync, gate=gate, **params)


def _cache_key(name: str, params: dict) -> tuple:
    return (name,) + tuple(sorted(params.items()))


def _f32(x):
    return x.to(torch.float32)


def seed_sets(sources) -> tuple[tuple[int, ...], ...]:
    """Normalize a multi-query ``sources`` argument to a tuple of seed-id
    tuples: each entry is either a single original vertex id or an iterable
    of ids (a seed set); one query column per entry."""
    if sources is None:
        raise ValueError("run_batch needs sources (one per query)")
    if isinstance(sources, (int, np.integer)):
        sources = [sources]
    sets = []
    for s in sources:
        if isinstance(s, (int, np.integer)):
            sets.append((int(s),))
        else:
            t = tuple(int(v) for v in s)
            if not t:
                raise ValueError("empty seed set")
            sets.append(t)
    if not sets:
        raise ValueError("sources is empty")
    return tuple(sets)


def _seed_hits(pg: PartitionedGraph, sets, device) -> torch.Tensor:
    """``[C*K, B]`` bool on ``device``: the padded slots that hold a seed of
    query b.  Seeds are found through ``local_to_global``, as the reference
    does, so a layout that replicates a vertex would seed every replica."""
    n = pg.graph.num_vertices
    for seeds in sets:
        for v in seeds:
            if not 0 <= v < n:
                raise ValueError(f"source {v} out of range")
    l2g = pg.device_relabel(device)["local_to_global"]
    flat = torch.tensor([v for seeds in sets for v in seeds],
                        dtype=l2g.dtype, device=device)  # one small upload
    cols, start = [], 0
    for seeds in sets:
        cols.append(torch.isin(l2g, flat[start:start + len(seeds)]))
        start += len(seeds)
    return torch.stack(cols, dim=1)


_TORCH_DTYPE = {np.float32: torch.float32, np.int32: torch.int32}


def _index_state(pg: PartitionedGraph, fill, dtype, source: int | None = None,
                 sources=None, device=None):
    """[C, K] state filled with ``fill``; ``source`` (an *original* vertex id,
    translated through the partitioner's relabel) set to 0.

    ``sources`` (a sequence of seed sets from ``seed_sets``) builds the
    batched [C, K, B] plane instead, as a tensor on ``device``: column b
    seeds query b's set.
    """
    if sources is not None:
        hit = _seed_hits(pg, sources, device)
        plane = torch.full(hit.shape, fill, dtype=_TORCH_DTYPE[dtype],
                           device=device).masked_fill_(hit, 0)
        return plane.reshape(pg.num_chunks, pg.chunk_size, len(sources))
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


def _zeros_plane(pg, seeds, device):
    """Batched init for fixed-iter add-monoid programs: every query column
    starts from the same all-zero state (the seed dependence, if any, rides
    in the ``query_plane`` operand instead)."""
    return torch.zeros((pg.num_chunks, pg.chunk_size, len(seeds)),
                       dtype=torch.float32, device=device)


def _make_pagerank(alpha: float = 0.85, iters: int = 20) -> VertexProgram:
    return VertexProgram(
        name="pagerank",
        key=_cache_key("pagerank", dict(alpha=alpha, iters=iters)),
        combiner=strat.ADD,
        init=lambda pg: np.zeros((pg.num_chunks, pg.chunk_size), np.float32),
        init_batch=_zeros_plane,
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
        init_batch=_zeros_plane,
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
# Personalized PageRank: per-query teleport vectors on the batched plane
# ---------------------------------------------------------------------------


def _teleport_plane(pg: PartitionedGraph, sets, device) -> torch.Tensor:
    """[C, K, B] teleport operand on ``device``: column b carries 1/|S_b| at
    query b's seed vertices and 0 elsewhere.  Seeds land through
    ``local_to_global`` (like ``_index_state``); padding slots stay 0 and are
    additionally zeroed by ``vertex_valid`` in apply."""
    hit = _seed_hits(pg, sets, device)
    mass = torch.tensor([1.0 / len(seeds) for seeds in sets],
                        dtype=torch.float32, device=device)
    return torch.where(hit, mass, 0.0).reshape(pg.num_chunks, pg.chunk_size,
                                               len(sets))


def _ppr_normalize(graph: Graph, sets, plane: torch.Tensor) -> torch.Tensor:
    """Per-query row normalization on the plane's device: each query's
    scores sum to 1 (mass lost to dangling vertices is renormalized away,
    the standard PPR convention).  Each row is summed on its own in float64,
    so the sum hardly depends on how a reduction splits it."""
    plane = plane.to(torch.float32)
    sums = plane.sum(dim=-1, keepdim=True, dtype=torch.float64)
    return torch.where(sums > 0, plane / sums, plane).to(torch.float32)


def _make_personalized_pagerank(seeds=(0,), alpha: float = 0.85,
                                iters: int = 20) -> VertexProgram:
    """PPR toward one seed set: a <- (1-alpha) * t_S(v) + alpha * sum_in
    a(u)/deg(u), t_S uniform on S.  ``seeds`` is ONE seed set (the default
    single query); ``Engine.run`` routes it through the batched plane at
    B=1, and ``run_batch(sources=[set_1, ..., set_B])`` serves B seed sets
    off one edge sweep.  update/apply only ever run inside the batched
    loop, where the engine exposes the teleport plane as ``aux['qplane']``.
    """
    if isinstance(seeds, (int, np.integer)):
        seeds = (int(seeds),)
    seeds = tuple(int(v) for v in seeds)
    return VertexProgram(
        name="personalized_pagerank",
        key=_cache_key("personalized_pagerank",
                       dict(seeds=seeds, alpha=alpha, iters=iters)),
        combiner=strat.ADD,
        init=lambda pg: np.zeros((pg.num_chunks, pg.chunk_size), np.float32),
        init_batch=_zeros_plane,
        update=lambda a, aux: alpha * a / _f32(aux["out_degree"]),
        edge_value=None,
        apply=lambda a, inc, aux:
            ((1.0 - alpha) * aux["qplane"] + inc) * _f32(aux["vertex_valid"]),
        fixed_iters=iters,
        sources=(seeds,),
        query_plane=_teleport_plane,
        finalize=lambda graph, sets, plane:
            plane[0] if len(sets) == 1 else plane,
        finalize_batch=_ppr_normalize,
    )


def personalized_pagerank_serial(graph: Graph, seeds=(0,), alpha: float = 0.85,
                                 iters: int = 20) -> np.ndarray:
    """Serial COST baseline: same Jacobi iteration as the engine (float32,
    zero init, (1-alpha)*t + alpha-scaled degree-normalized push), then the
    per-query normalization."""
    if isinstance(seeds, (int, np.integer)):
        seeds = (seeds,)
    seeds = tuple(int(v) for v in seeds)
    n = graph.num_vertices
    src, dst = graph.src, graph.dst
    deg = np.bincount(src, minlength=n).astype(np.float32)
    D = np.where(deg > 0, deg, 1.0).astype(np.float32)
    t = np.zeros(n, np.float32)
    t[list(seeds)] = np.float32(1.0 / len(seeds))
    a = np.zeros(n, np.float32)
    for _ in range(iters):
        b = np.float32(alpha) * a / D
        a = np.float32(1.0 - alpha) * t
        a += np.bincount(dst, weights=b[src], minlength=n).astype(np.float32)
    s = a.sum()
    return (a / s if s > 0 else a).astype(np.float32)


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
        init_batch=lambda pg, seeds, device: _index_state(
            pg, np.inf, np.float32, sources=seeds, device=device),
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
        init_batch=lambda pg, seeds, device: _index_state(
            pg, INT_SENTINEL, np.int32, sources=seeds, device=device),
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
# Approximate betweenness: multi-source BFS on the batched plane + Brandes
# accumulation at finalize
# ---------------------------------------------------------------------------

_coo: dict = {}  # (id(graph), device) -> (weak ref to graph, (src, dst))


def _device_coo(graph: Graph, device) -> tuple:
    """The graph's COO endpoints (original ids, int64) on ``device``,
    uploaded once and kept for as long as the graph lives."""
    key = (id(graph), str(torch.device(device)))
    hit = _coo.get(key)
    if hit is not None and hit[0]() is graph:
        return hit[1]
    edges = tuple(torch.from_numpy(np.asarray(a, np.int64)).to(device)
                  for a in (graph.src, graph.dst))
    _coo[key] = (weakref.ref(graph, lambda _, k=key: _coo.pop(k, None)),
                 edges)
    return edges


def _betweenness_from_depths(graph: Graph, sets, depths) -> torch.Tensor:
    """Brandes accumulation from per-pivot BFS depth rows, in float64 torch
    ops on the depth plane's device.

    ``depths`` is the [n_pivots, V] plane the batched engine produces
    (INT_SENTINEL = unreached).  For each pivot: the forward sweep counts
    shortest paths (sigma) level by level over the BFS DAG, the backward
    sweep accumulates dependencies (delta), each level one ``index_add_``
    over its DAG edges; scores are scaled by V / n_pivots to estimate the
    all-sources sum (Brandes++ style pivot sampling).  On the card the adds
    are float64 atomics in no fixed order.
    """
    depths = torch.as_tensor(depths)
    dev = depths.device
    src, dst = _device_coo(graph, dev)
    n = graph.num_vertices
    f64 = dict(dtype=torch.float64, device=dev)
    scores = torch.zeros(n, **f64)
    for seeds, row in zip(sets, depths):
        d = torch.where(row >= INT_SENTINEL, -1, row)
        ds, dd = d[src], d[dst]
        maxlvl = int(d.max())
        sigma = torch.zeros(n, **f64)
        sigma[list(seeds)] = 1.0
        for lvl in range(maxlvl):
            dag = (ds == lvl) & (dd == lvl + 1)
            es, ed = src[dag], dst[dag]
            sigma.index_add_(0, ed, sigma[es])
        delta = torch.zeros(n, **f64)
        for lvl in range(maxlvl, 0, -1):
            dag = (ds == lvl - 1) & (dd == lvl)
            es, ed = src[dag], dst[dag]
            below = sigma[ed]
            ratio = torch.where(below > 0, sigma[es] / below, 0.0)
            contrib = torch.zeros(n, **f64)
            contrib.index_add_(0, es, ratio * (1.0 + delta[ed]))
            delta += contrib
        delta[d == 0] = 0.0
        scores += delta
    return scores * (n / max(len(sets), 1))


def _make_betweenness(pivots=(0, 1, 2, 3), max_iters: int = 10_000
                      ) -> VertexProgram:
    """Approximate betweenness centrality: B-pivot BFS in one batched sweep
    (the [C, K, B] plane), then the Brandes forward/backward accumulation on
    the device from the converged depth rows."""
    pivots = tuple(int(p) for p in pivots)
    return VertexProgram(
        name="betweenness",
        key=_cache_key("betweenness",
                       dict(pivots=pivots, max_iters=max_iters)),
        combiner=strat.MIN,
        init=lambda pg: _index_state(pg, INT_SENTINEL, np.int32, pivots[0]),
        init_batch=lambda pg, seeds, device: _index_state(
            pg, INT_SENTINEL, np.int32, sources=seeds, device=device),
        update=lambda d, aux: d,
        edge_value=_bfs_hop,
        edge_semiring="unit",
        apply=lambda d, inc, aux: torch.minimum(d, inc),
        fixed_iters=None,
        max_iters=max_iters,
        sources=pivots,
        finalize=_betweenness_from_depths,
    )


def betweenness_serial(graph: Graph, pivots=(0, 1, 2, 3),
                       max_iters: int = 10_000) -> tuple[np.ndarray, int]:
    """Serial COST baseline: per-pivot Brandes in ``kernels.ref`` (its own
    BFS -- fully independent of the engine's depth plane)."""
    from repro_torch.kernels.ref import betweenness_ref
    return betweenness_ref(graph, tuple(int(p) for p in pivots))


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
register(ProgramSpec(
    name="betweenness", make=_make_betweenness, serial=betweenness_serial,
    defaults=dict(pivots=(0, 1, 2, 3), max_iters=10_000),
    returns_iters=True, table="table7"))
register(ProgramSpec(
    name="personalized_pagerank", make=_make_personalized_pagerank,
    serial=personalized_pagerank_serial,
    defaults=dict(seeds=(0,), alpha=0.85, iters=20), table="table8"))
