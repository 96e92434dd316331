"""Pluggable vertex->chare placement policies (the partitioning layer).

The port's copy of the 1-D half of ``repro/core/partitioners.py``: a
partitioner maps a ``Graph`` and a chare count to a ``PartitionPlan`` -- a
vertex permutation plus per-chunk bounds -- and ``graph.partition``
materializes the plan into a ``PartitionedGraph`` whose relabel arrays let
the engine translate between original ("global") vertex ids at the API
boundary and permuted ("local") ids inside the chare arrays.  Plans equal
the reference's for the same graph, so the layouts built from them do too.

Built-in policies:

    contiguous     equal *vertex* chunks in id order (the paper's layout)
    edge_balanced  contiguous cut points chosen so each chare owns ~E/P edges
                   (cumulative edge *weight* when the graph is weighted)
    striped        round-robin placement (vertex v -> chare v mod P)
    degree_sorted  descending-degree snake deal, spreading hubs across chares

The 2-D ``grid(R,C)`` family is not ported yet (ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import numpy as np

if TYPE_CHECKING:  # avoid a runtime cycle: graph.py imports this module
    from repro_torch.core.graph import Graph, PartitionedGraph


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Placement of V vertices into C chares.

    ``order`` lists original vertex ids in placement order; chunk c owns
    ``order[start_c : start_c + chunk_counts[c]]`` at local slots 0..count-1,
    where ``start_c = sum(chunk_counts[:c])``.  The padded chunk size (the
    common rectangle height) is ``max(chunk_counts)``; a vertex's *padded id*
    is ``chunk * chunk_size + slot``.
    """

    num_chunks: int
    order: np.ndarray  # [V] int64, a permutation of arange(V)
    chunk_counts: np.ndarray  # [C] int64, sums to V

    @property
    def num_vertices(self) -> int:
        return int(self.order.shape[0])

    @property
    def chunk_size(self) -> int:
        return max(int(self.chunk_counts.max()), 1) if self.num_chunks else 1

    @property
    def vertex_chunk(self) -> np.ndarray:
        """[V] chunk owning each original vertex id."""
        chunk_of_rank = np.repeat(
            np.arange(self.num_chunks, dtype=np.int64), self.chunk_counts)
        out = np.empty(self.num_vertices, dtype=np.int64)
        out[self.order] = chunk_of_rank
        return out

    def _rank_positions(self) -> np.ndarray:
        """[V] padded id of each placement rank r (rank r is ``order[r]``)."""
        C, K, V = self.num_chunks, self.chunk_size, self.num_vertices
        starts = np.zeros(C, dtype=np.int64)
        np.cumsum(self.chunk_counts[:-1], out=starts[1:])
        chunk_of_rank = np.repeat(np.arange(C, dtype=np.int64),
                                  self.chunk_counts)
        slot = np.arange(V, dtype=np.int64) - starts[chunk_of_rank]
        return chunk_of_rank * K + slot

    def relabel(self) -> tuple[np.ndarray, np.ndarray]:
        """-> (global_to_local [V], local_to_global [C*K]).

        ``global_to_local[v]`` is v's padded id; ``local_to_global[p]`` is the
        original id at padded slot p, or -1 for padding.
        """
        C, K, V = self.num_chunks, self.chunk_size, self.num_vertices
        pos = self._rank_positions()
        g2l = np.empty(V, dtype=np.int64)
        g2l[self.order] = pos
        l2g = np.full(C * K, -1, dtype=np.int64)
        l2g[pos] = self.order
        return g2l, l2g

    def edges_per_chunk(self, graph: "Graph") -> np.ndarray:
        """[C] out-edges owned by each chunk under this placement."""
        vc = self.vertex_chunk
        return np.bincount(vc, weights=graph.out_degrees,
                           minlength=self.num_chunks).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class PartitionerSpec:
    """Registry entry: the planning function plus a one-line 'when it wins'."""

    name: str
    plan: Callable[["Graph", int], PartitionPlan]
    wins: str  # when to prefer this policy (surfaces in docs/tables)


PARTITIONERS: dict[str, PartitionerSpec] = {}


def register_partitioner(spec: PartitionerSpec) -> PartitionerSpec:
    if spec.name in PARTITIONERS:
        raise ValueError(f"partitioner {spec.name!r} already registered")
    PARTITIONERS[spec.name] = spec
    return spec


def get_partitioner(name: str) -> PartitionerSpec:
    if name in PARTITIONERS:
        return PARTITIONERS[name]
    if name.startswith("grid("):
        raise NotImplementedError(
            f"{name}: grid(R,C) partitions are not ported yet "
            "(ROADMAP queue 1, item 6)")
    raise ValueError(f"unknown partitioner {name!r}; "
                     f"choose from {sorted(PARTITIONERS)}")


def partitioner_names() -> list[str]:
    return list(PARTITIONERS)


def policy_label(base: str, partitioner: str) -> str:
    """Display label for a (strategy/impl, partitioner) cell: the bare name
    for the default policy, ``base+partitioner`` otherwise."""
    return base if partitioner == "contiguous" else f"{base}+{partitioner}"


def make_plan(graph: "Graph", num_chunks: int,
              partitioner: str = "contiguous") -> PartitionPlan:
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    plan = get_partitioner(partitioner).plan(graph, num_chunks)
    if int(plan.chunk_counts.sum()) != graph.num_vertices:
        raise AssertionError(f"{partitioner}: chunk_counts sum "
                             f"{plan.chunk_counts.sum()} != V")
    return plan


# ---------------------------------------------------------------------------
# Built-in policies
# ---------------------------------------------------------------------------


def _contiguous(graph: "Graph", C: int) -> PartitionPlan:
    n = graph.num_vertices
    K = -(-n // C) if n else 1  # ceil
    counts = np.clip(n - K * np.arange(C, dtype=np.int64), 0, K)
    return PartitionPlan(C, np.arange(n, dtype=np.int64), counts)


def _edge_balanced(graph: "Graph", C: int) -> PartitionPlan:
    """Contiguous cut points at ~E/C cumulative out-edge *load* per chunk.

    Unweighted graphs balance out-degree; weighted graphs balance cumulative
    out-edge WEIGHT, falling back to degrees when the weights sum to zero.
    Falls back to the contiguous split on edgeless graphs.
    """
    n, E = graph.num_vertices, graph.num_edges
    if E == 0:
        return _contiguous(graph, C)
    load = graph.out_degrees.astype(np.float64)
    if graph.weight is not None:
        wsum = np.bincount(graph.src, weights=graph.weight, minlength=n)
        if wsum.sum() > 0:
            load = wsum
    cum = np.cumsum(load)
    targets = np.arange(1, C, dtype=np.float64) * (cum[-1] / C)
    cuts = np.searchsorted(cum, targets, side="left") + 1
    cuts = np.minimum(cuts, n)
    bounds = np.concatenate(([0], cuts, [n]))
    counts = np.maximum(np.diff(bounds), 0)
    return PartitionPlan(C, np.arange(n, dtype=np.int64), counts)


def _striped(graph: "Graph", C: int) -> PartitionPlan:
    """Round-robin (hash-like) placement: vertex v -> chare v mod C."""
    n = graph.num_vertices
    chunk = np.arange(n, dtype=np.int64) % C
    order = np.argsort(chunk, kind="stable")
    counts = np.bincount(chunk, minlength=C).astype(np.int64)
    return PartitionPlan(C, order, counts)


def _degree_sorted(graph: "Graph", C: int) -> PartitionPlan:
    """Descending-degree snake deal: the C heaviest vertices land on C
    distinct chares, the next C fill them in reverse, and so on."""
    n = graph.num_vertices
    by_degree = np.argsort(-graph.out_degrees.astype(np.int64), kind="stable")
    rank = np.arange(n, dtype=np.int64)
    fwd = rank % C
    chunk = np.where((rank // C) % 2 == 0, fwd, C - 1 - fwd)
    order = by_degree[np.argsort(chunk, kind="stable")]
    counts = np.bincount(chunk, minlength=C).astype(np.int64)
    return PartitionPlan(C, order, counts)


register_partitioner(PartitionerSpec(
    "contiguous", _contiguous,
    wins="id-locality graphs / the paper's baseline layout"))
register_partitioner(PartitionerSpec(
    "edge_balanced", _edge_balanced,
    wins="power-law graphs where per-chare edge work dominates"))
register_partitioner(PartitionerSpec(
    "striped", _striped,
    wins="adversarially ordered ids; destroys locality but is seed-free"))
register_partitioner(PartitionerSpec(
    "degree_sorted", _degree_sorted,
    wins="hub-heavy graphs needing both edge and vertex balance"))


# ---------------------------------------------------------------------------
# Imbalance accounting
# ---------------------------------------------------------------------------


def partition_stats(pg: "PartitionedGraph", frontier=None) -> dict:
    """Per-chare load + padding metrics for one materialized 1-D partition.

    ``edge_imbalance`` is max/mean per-chare edges (1.0 = perfectly even);
    ``*_padding_waste`` is the fraction of the padded rectangle that is
    padding.  ``frontier`` (optional ``[C, K]`` 0/1) adds the *active* load
    view: ``frontier_edges`` counts each chare's out-edges whose source is in
    the frontier, and ``frontier_edge_imbalance`` is their max/mean.
    """
    C, K = pg.num_chunks, pg.chunk_size
    edges = pg.edge_valid.sum(axis=1).astype(np.int64)
    verts = pg.vertex_valid.sum(axis=1).astype(np.int64)
    E, V = pg.graph.num_edges, pg.graph.num_vertices
    emax = int(pg.edge_valid.shape[1])
    mean_e = E / C if C else 0.0
    mean_v = verts.sum() / C if C else 0.0
    front = {}
    if frontier is not None:
        mask = np.asarray(frontier).reshape(C, K) != 0
        # true out-degrees (pg.out_degree clips degree-0 vertices to 1 for
        # the PageRank divide) gathered through the relabel
        l2g = pg.local_to_global
        deg = np.zeros(C * K, dtype=np.int64)
        live = l2g >= 0
        deg[live] = pg.graph.out_degrees[l2g[live]]
        fe = np.where(mask, deg.reshape(C, K), 0).sum(axis=1)
        total = int(fe.sum())
        front = {
            "frontier_edges": fe,
            "frontier_edge_imbalance":
                float(fe.max() * C / total) if total else 1.0,
        }
    return {
        **front,
        "partitioner": pg.partitioner,
        "edges_per_chare": edges,
        "vertices_per_chare": verts,
        "max_edges": int(edges.max()) if C else 0,
        "mean_edges": mean_e,
        "edge_imbalance": float(edges.max() / mean_e) if E else 1.0,
        "max_vertices": int(verts.max()) if C else 0,
        "vertex_imbalance": float(verts.max() / mean_v) if V else 1.0,
        "vertex_padding_waste": float(1.0 - verts.sum() / (C * K))
                                if C * K else 0.0,
        "edge_padding_waste": 1.0 - E / (C * emax) if E else 0.0,
    }
