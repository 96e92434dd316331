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

Beyond the 1-D registry there is a *family* of 2-D policies: ``grid(R,C)``
buckets edges into (src-row-chunk, dst-col-chunk) rectangles, yielding a
``GridPlan`` instead of a ``PartitionPlan``.  ``grid(R,C,<policy>)`` applies
one registered 1-D policy to BOTH axes and ``grid(R,C,<row>,<col>)`` picks
them per axis (default ``contiguous``).  Family names parse in
``get_partitioner`` and never appear in ``partitioner_names()`` (the static
1-D registry).
"""

from __future__ import annotations

import dataclasses
import re
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

    def same_as(self, other) -> bool:
        """Placement equality (dataclass ``==`` is ambiguous on arrays)."""
        if not isinstance(other, PartitionPlan):
            return False  # a GridPlan is never the same placement
        return (self.num_chunks == other.num_chunks
                and np.array_equal(self.order, other.order)
                and np.array_equal(self.chunk_counts, other.chunk_counts))

    # -- composition algebra (the replan state move) ------------------------

    def compose(self, other: "PartitionPlan") -> "PartitionPlan":
        """Sequential application: ``self`` then ``other``.

        ``other`` is a plan over THIS plan's placement ranks (its ``order``
        entries name ranks of ``self``); the composed plan places the
        corresponding original ids where ``other`` sends their ranks, so a
        replan applies plan B's ``g2l`` on top of plan A's without
        translating chare state back to original ids.  Composing with the
        ``contiguous`` plan of the same shape on either side is a no-op;
        composition is associative.
        """
        if other.num_vertices != self.num_vertices:
            raise ValueError(
                f"cannot compose plans over {self.num_vertices} and "
                f"{other.num_vertices} vertices")
        return PartitionPlan(other.num_chunks, self.order[other.order],
                             other.chunk_counts.copy())

    def rebase(self, old: "PartitionPlan") -> "PartitionPlan":
        """This plan expressed on top of ``old``'s placement: the delta
        plan over ``old``'s ranks with ``old.compose(delta).same_as(self)``."""
        if old.num_vertices != self.num_vertices:
            raise ValueError("rebase requires plans over the same vertex set")
        inv = np.empty(old.num_vertices, dtype=np.int64)
        inv[old.order] = np.arange(old.num_vertices, dtype=np.int64)
        return PartitionPlan(self.num_chunks, inv[self.order],
                             self.chunk_counts.copy())

    def padded_map_from(self, old: "PartitionPlan") -> np.ndarray:
        """``[C_old * K_old]`` old padded id -> new padded id (-1 at
        padding): plan B's ``g2l`` applied on top of plan A's ``l2g``,
        built in rank space (``rebase`` and the two rank -> padded-slot
        tables), so original vertex ids never materialize."""
        delta = self.rebase(old)
        old_pos = old._rank_positions()
        new_pos = self._rank_positions()
        m = np.full(old.num_chunks * old.chunk_size, -1, dtype=np.int64)
        m[old_pos[delta.order]] = new_pos
        return m

    def edges_per_chunk(self, graph: "Graph") -> np.ndarray:
        """[C] out-edges owned by each chunk under this placement."""
        vc = self.vertex_chunk
        return np.bincount(vc, weights=graph.out_degrees,
                           minlength=self.num_chunks).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """2-D placement: edges bucketed into ``rows x cols`` rectangles.

    ``row`` places the V vertices into R *source* chunks and ``col`` into C
    *destination* chunks; rectangle ``(r, c)`` (flat id ``r*cols + c``, one
    per chare) owns exactly the edges whose source lies in row chunk r and
    whose destination lies in col chunk c -- so every edge lands in exactly
    one rectangle and ``rect_counts`` sums to E.  Vertex *state* lives in
    the row layout, replicated across the C rectangles of its row (the 2-D
    SpMV convention: the input vector is broadcast along grid rows, partial
    outputs are combined along grid columns).

    ``rect_starts``/``rect_counts`` are the per-rectangle edge bounds: in
    the rectangle-sorted edge order, rectangle k owns edges
    ``[rect_starts[k], rect_starts[k] + rect_counts[k])`` and the bounds
    tile ``[0, E)``.
    """

    rows: int
    cols: int
    row: PartitionPlan
    col: PartitionPlan
    rect_counts: np.ndarray  # [rows*cols] int64 edges per rectangle

    @property
    def num_chunks(self) -> int:
        """Chares: one per rectangle."""
        return self.rows * self.cols

    @property
    def num_vertices(self) -> int:
        return self.row.num_vertices

    @property
    def chunk_size(self) -> int:
        """State width per chare == the padded row-chunk height."""
        return self.row.chunk_size

    @property
    def col_chunk_size(self) -> int:
        return self.col.chunk_size

    @property
    def rect_starts(self) -> np.ndarray:
        """[rows*cols] start of each rectangle's edge slice; with
        ``rect_counts`` these tile ``[0, E)``."""
        from repro_torch.kernels import blocks

        return blocks.rect_bounds(self.rect_counts)[0]

    def same_as(self, other) -> bool:
        return (isinstance(other, GridPlan)
                and self.rows == other.rows and self.cols == other.cols
                and self.row.same_as(other.row)
                and self.col.same_as(other.col))

    def edges_per_chunk(self, graph: "Graph") -> np.ndarray:
        """[rows*cols] edges owned by each rectangle."""
        return self.rect_counts.copy()


def row_plan_of(plan) -> PartitionPlan:
    """The 1-D plan that carries vertex *state*: the plan itself for 1-D,
    the row map for grids."""
    return plan.row if isinstance(plan, GridPlan) else plan


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


# ``grid(R,C)`` / ``grid(R,C,row_policy,col_policy)`` -- the 2-D family.
# Parsed on lookup (the shape is part of the name) and cached; the static
# registry keeps only the 1-D policies.
_GRID_RE = re.compile(r"^grid\((\d+)\s*[,x]\s*(\d+)"
                      r"(?:\s*,\s*(\w+))?(?:\s*,\s*(\w+))?\)$")
_GRID_SPECS: dict[str, PartitionerSpec] = {}


def grid_shape(name: str) -> tuple[int, int] | None:
    """(rows, cols) when ``name`` is a grid-family spec, else None."""
    m = _GRID_RE.match(name)
    return (int(m.group(1)), int(m.group(2))) if m else None


def _grid_spec(name: str, m: "re.Match") -> PartitionerSpec:
    R, C = int(m.group(1)), int(m.group(2))
    row_policy = m.group(3) or "contiguous"
    col_policy = m.group(4) or row_policy
    if R < 1 or C < 1:
        raise ValueError(f"{name}: grid shape must be >= 1x1")
    for p in (row_policy, col_policy):
        if p not in PARTITIONERS:
            raise ValueError(f"{name}: unknown 1-D policy {p!r}; "
                             f"choose from {sorted(PARTITIONERS)}")

    def plan(graph: "Graph", num_chunks: int) -> GridPlan:
        if num_chunks != R * C:
            raise ValueError(
                f"{name} needs num_chunks == {R * C} (one chare per "
                f"rectangle), got {num_chunks}")
        row = PARTITIONERS[row_policy].plan(graph, R)
        col = PARTITIONERS[col_policy].plan(graph, C)
        from repro_torch.kernels import blocks

        rect = blocks.edge_rectangles(row.vertex_chunk[graph.src],
                                      col.vertex_chunk[graph.dst], C)
        counts = np.bincount(rect, minlength=R * C).astype(np.int64)
        return GridPlan(R, C, row, col, counts)

    return PartitionerSpec(
        name, plan,
        wins="high PE counts: wire scales with V/sqrt(P), not cut edges")


def get_partitioner(name: str) -> PartitionerSpec:
    if name in PARTITIONERS:
        return PARTITIONERS[name]
    m = _GRID_RE.match(name)
    if m is not None:
        if name not in _GRID_SPECS:
            _GRID_SPECS[name] = _grid_spec(name, m)
        return _GRID_SPECS[name]
    raise ValueError(f"unknown partitioner {name!r}; "
                     f"choose from {sorted(PARTITIONERS)} or 'grid(R,C)'")


def partitioner_names() -> list[str]:
    return list(PARTITIONERS)


def policy_label(base: str, partitioner: str) -> str:
    """Display label for a (strategy/impl, partitioner) cell: the bare name
    for the default policy, ``base+partitioner`` otherwise."""
    return base if partitioner == "contiguous" else f"{base}+{partitioner}"


def make_plan(graph: "Graph", num_chunks: int,
              partitioner: str = "contiguous"):
    """-> ``PartitionPlan`` (1-D policies) or ``GridPlan`` (grid family)."""
    if num_chunks < 1:
        raise ValueError(f"num_chunks must be >= 1, got {num_chunks}")
    plan = get_partitioner(partitioner).plan(graph, num_chunks)
    if isinstance(plan, GridPlan):
        for axis, p in (("row", plan.row), ("col", plan.col)):
            if int(p.chunk_counts.sum()) != graph.num_vertices:
                raise AssertionError(f"{partitioner}: {axis} chunk_counts "
                                     f"sum {p.chunk_counts.sum()} != V")
        if int(plan.rect_counts.sum()) != graph.num_edges:
            raise AssertionError(f"{partitioner}: rect_counts sum "
                                 f"{plan.rect_counts.sum()} != E")
    elif int(plan.chunk_counts.sum()) != graph.num_vertices:
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
    """Per-chare load + padding metrics for one materialized partition.

    ``edge_imbalance`` is max/mean per-chare edges (1.0 = perfectly even);
    ``*_padding_waste`` is the fraction of the padded rectangle that is
    padding.  ``frontier`` (optional ``[C, K]`` 0/1) adds the *active* load
    view: ``frontier_edges`` counts each chare's out-edges whose source is in
    the frontier, and ``frontier_edge_imbalance`` is their max/mean.

    Grid partitions report the same keys with "chare" meaning "rectangle"
    (plus ``grid_shape``): ``edges_per_chare`` are per-rectangle edge
    counts, ``vertices_per_chare`` the (row-replicated) state widths, and
    the frontier view charges each rectangle only the frontier edges that
    land IN it (``rect_degree``), not the source's whole out-degree.
    """
    C, K = pg.num_chunks, pg.chunk_size
    edges = pg.edge_valid.sum(axis=1).astype(np.int64)
    verts = pg.vertex_valid.sum(axis=1).astype(np.int64)
    E, V = pg.graph.num_edges, pg.graph.num_vertices
    emax = int(pg.edge_valid.shape[1])
    mean_e = E / C if C else 0.0
    # verts.sum() == V for 1-D placements; grids replicate each row chunk
    # across their C columns, so the per-chare mean is the replicated one
    mean_v = verts.sum() / C if C else 0.0
    front = {}
    if frontier is not None:
        mask = np.asarray(frontier).reshape(C, K) != 0
        if pg.is_grid:
            # per-rectangle degrees: a frontier source costs rectangle (r,c)
            # only the edges it has *in that rectangle's column*
            deg2d = pg.rect_degree
        else:
            # true out-degrees (pg.out_degree clips degree-0 vertices to 1
            # for the PageRank divide) gathered through the relabel
            l2g = pg.local_to_global
            deg = np.zeros(C * K, dtype=np.int64)
            live = l2g >= 0
            deg[live] = pg.graph.out_degrees[l2g[live]]
            deg2d = deg.reshape(C, K)
        fe = np.where(mask, deg2d, 0).sum(axis=1)
        total = int(fe.sum())
        front = {
            "frontier_edges": fe,
            "frontier_edge_imbalance":
                float(fe.max() * C / total) if total else 1.0,
        }
    grid = {"grid_shape": pg.grid_shape} if pg.is_grid else {}
    return {
        **front,
        **grid,
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
