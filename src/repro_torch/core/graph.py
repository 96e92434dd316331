"""Graph representation and chare-style partitioning (1-D and 2-D grids).

The port's copy of the host half of ``repro/core/graph.py``.  The paper
assigns contiguous chunks of vertices to actors (chares); each chare stores
its local vertices in index order plus the destinations of their outgoing
edges.  ``Graph`` is the global CSR; ``PartitionedGraph`` is the chare
decomposition with padded, rectangular ``[C, ...]`` per-chunk arrays.  The
layout build (a stable sort into the tile-bucket order, the rectangle pack
and the band table) produces arrays equal to the reference's for the same
graph, partitioner and chare count: on the host in numpy, or, for graphs
from 2^21 edges where a card is present, on the device in torch
(``REPRO_DEVICE_BUILD=device|host|auto``), bit for bit the same.
``device_arrays`` / ``device_aux`` / ``device_pairwise`` upload the layouts
as torch tensors.  Out-of-core runs never upload the edge planes: a
``ShardSource`` (``PartitionedGraph.shard_source``) serves them one edge
window at a time, from host memory or memory-mapped from the disk layout
cache (``repro_torch.checkpoint``).

Real datasets from the paper (soc-LiveJournal1, twitter_rv, uk-2007-05) are
not available offline; ``load_dataset`` provides scaled RMAT stand-ins with
the same edge/vertex ratios (14x, 24x, 35x).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.core import partitioners as part_mod
from repro_torch.kernels import blocks, push_fused

INT = np.int32
WEIGHT = np.float32


@dataclasses.dataclass(frozen=True)
class Graph:
    """Global CSR graph: ``dst[indptr[v]:indptr[v+1]]`` are v's out-neighbors.

    ``weight`` (optional) is aligned with ``dst``: ``weight[e]`` is the weight
    of edge e in CSR order.  ``None`` means unweighted; consumers that need
    weights use ``edge_weights`` which substitutes ones.
    """

    num_vertices: int
    indptr: np.ndarray  # [V+1] int64
    dst: np.ndarray  # [E] int32
    directed: bool = True
    weight: np.ndarray | None = None  # [E] float32 or None

    @property
    def num_edges(self) -> int:
        return int(self.dst.shape[0])

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr).astype(INT)

    @property
    def src(self) -> np.ndarray:
        """COO source array, derived from indptr."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=INT), self.out_degrees
        )

    @property
    def edge_weights(self) -> np.ndarray:
        """Weights in CSR edge order; ones when unweighted."""
        if self.weight is None:
            return np.ones(self.num_edges, dtype=WEIGHT)
        return self.weight

    def with_weight(self, weight: np.ndarray) -> "Graph":
        """Attach a per-edge weight array (CSR edge order)."""
        weight = np.asarray(weight, dtype=WEIGHT)
        if weight.shape != (self.num_edges,):
            raise ValueError(f"weight shape {weight.shape} != ({self.num_edges},)")
        return dataclasses.replace(self, weight=weight)

    def to_undirected(self) -> "Graph":
        """Add reverse edges (dedup), as the paper does for label propagation.

        For weighted graphs the dedup keeps the *minimum* weight per
        (u, v) pair -- the convention that preserves shortest paths.
        """
        src, dst = self.src, self.dst
        fwd = src.astype(np.int64) * self.num_vertices + dst
        rev = dst.astype(np.int64) * self.num_vertices + src
        if self.weight is None:
            # sort + drop repeats: the keys np.unique returns; np.unique of
            # numpy 2.3 took ~40x as long as this on 117M int64 keys
            keys = np.sort(np.concatenate([fwd, rev]))
            first = np.ones(len(keys), dtype=bool)
            first[1:] = keys[1:] != keys[:-1]
            keys = keys[first]
            w = None
        else:
            both = np.concatenate([fwd, rev])
            wboth = np.concatenate([self.weight, self.weight])
            order = np.argsort(both, kind="stable")
            both, wboth = both[order], wboth[order]
            first = np.ones(len(both), dtype=bool)
            first[1:] = both[1:] != both[:-1]
            keys = both[first]
            w = np.minimum.reduceat(wboth, np.flatnonzero(first))
        u = (keys // self.num_vertices).astype(INT)
        v = (keys % self.num_vertices).astype(INT)
        return from_edges(self.num_vertices, u, v, directed=False, weight=w)


def from_edges(n: int, src: np.ndarray, dst: np.ndarray, directed=True,
               weight: np.ndarray | None = None) -> Graph:
    """Build CSR from a COO edge list (sorts by src, keeps duplicates)."""
    src = np.asarray(src, dtype=INT)
    dst = np.asarray(dst, dtype=INT)
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    if weight is not None:
        weight = np.asarray(weight, dtype=WEIGHT)[order]
    counts = np.bincount(src, minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return Graph(num_vertices=n, indptr=indptr, dst=dst, directed=directed,
                 weight=weight)


def graph_from_reference(num_vertices: int, indptr: np.ndarray,
                         dst: np.ndarray, weight: np.ndarray | None = None,
                         directed: bool = True) -> Graph:
    """A port ``Graph`` from the numpy arrays of a reference ``Graph``
    (``repro.core.graph.Graph``): the CSR arrays are taken as they are, in
    the reference's dtypes, so every layout built from the result equals the
    reference's."""
    indptr = np.asarray(indptr, dtype=np.int64)
    dst = np.asarray(dst, dtype=INT)
    if indptr.shape != (num_vertices + 1,) or int(indptr[-1]) != len(dst):
        raise ValueError("indptr must be [V+1] and end at the edge count")
    if weight is not None:
        weight = np.asarray(weight, dtype=WEIGHT)
    return Graph(num_vertices=int(num_vertices), indptr=indptr, dst=dst,
                 directed=bool(directed), weight=weight)


def random_weights(graph: Graph, seed: int = 0, low: float = 1.0,
                   high: float = 10.0) -> Graph:
    """Attach uniform random weights in [low, high) -- the stand-in for the
    paper datasets' (absent) edge metadata in weighted scenarios."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(low, high, size=graph.num_edges).astype(WEIGHT)
    return graph.with_weight(w)


def _device_key(device) -> str:
    return str(torch.device(device))


def _upload(a: np.ndarray, device, rows=None) -> torch.Tensor:
    """``a`` on ``device``; ``rows`` (``(lo, hi)``, optional) uploads only
    those chare rows of its leading axis."""
    if rows is not None:
        a = a[rows[0]:rows[1]]
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _pad_edges(a: np.ndarray, fill) -> np.ndarray:
    """Widen a ``[C, Emax]`` edge plane to whole BLOCK_E edge blocks."""
    pad = blocks.num_edge_blocks(a.shape[1]) * blocks.BLOCK_E - a.shape[1]
    if pad == 0:
        return a
    return np.pad(a, ((0, 0), (0, pad)), constant_values=fill)


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Chare decomposition: ``num_chunks`` vertex chunks placed by a
    partitioner policy (contiguous id chunks by default).

    All per-chunk arrays live in *padded id* space -- the permutation chosen
    by the partitioner, laid out as ``chunk * chunk_size + slot`` -- and are
    padded to a common rectangle, one row per chare.  ``global_to_local`` /
    ``local_to_global`` translate between original vertex ids (what callers
    and programs' serial references see) and padded ids (what the chare
    arrays index); for the default ``contiguous`` policy the relabel is the
    identity.

    Basic layout (edges in local-source order, as in the paper's basic
    variant): ``src_local`` / ``dst_global`` / ``edge_valid`` /
    ``edge_weight``, each ``[C, Emax]``, plus the ``band`` table.

    Sort-destination layout (the paper's best variant): the same edges
    ordered by the key ``(owner, destination segment block, source vertex
    block)`` -- block-granular, then CSR order within a bucket: ``sd_src_local``
    / ``sd_dst_global`` / ``sd_edge_valid`` / ``sd_edge_weight`` and
    ``sd_band``.

    ``band`` / ``sd_band`` ([C, 4, NB] int32, rows src_lo/src_hi/seg_lo/seg_hi
    from ``blocks.edge_bands``) record which tiles each BLOCK_E edge block
    touches; empty blocks are (0, -1, 0, -1).  ``out_weight`` is the
    per-vertex sum of outgoing weights (1 where the vertex has no out-edges,
    mirroring the ``out_degree`` div-0 clip).

    The edge layouts are built on first access from the shared
    relabeled-edge base and then cached; ``partition`` forces both.

    2-D grid partitions (``GridPlan`` placements) reuse the same container
    with "chare" meaning "edge rectangle": one chare per rectangle
    ``(r, c)`` of an R x C grid, per-vertex planes row-replicated (chare
    ``r*C + c`` carries row chunk r's state), and a single ``grid`` edge
    layout in place of basic/sortdest:
      * ``gr_src_local``  [R*C, Emax] row-local source index of each edge
      * ``gr_dst_col``    [R*C, Emax] *column-padded* destination id
      * ``gr_edge_valid`` / ``gr_edge_weight`` aligned planes
      * ``gr_band``       [R*C, 4, NB] band table (same radix build)
      * ``gr_row_to_col`` [R*C, K] row slot -> column-padded id (-1 padding),
        the gather map that brings column-combined results back to row state
    """

    graph: Graph
    num_chunks: int
    chunk_size: int  # padded vertices per chunk
    vertex_valid: np.ndarray  # [C, chunk_size] 0/1
    out_degree: np.ndarray  # [C, chunk_size] int32 (>=1 to avoid div0; masked)
    out_weight: np.ndarray  # [C, chunk_size] float32 (>=1 where no out-edges)
    edge_valid: np.ndarray  # [C, Emax] 0/1 padding mask (shared by layouts)
    partitioner: str = "contiguous"
    global_to_local: np.ndarray | None = None  # [V] original id -> padded id
    local_to_global: np.ndarray | None = None  # [C*K] padded id -> original/-1
    plan: object = None  # the PartitionPlan this layout materializes
    # relabeled-edge base (_EdgeBase) both layout builds consume
    _base: object = dataclasses.field(default=None, repr=False, compare=False)
    # layout cache: "basic"/"sd" -> (src, dst, w, band)
    _lazy: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)
    # device-upload cache keyed (what, device): engines built on the same
    # partition share one resident copy of every layout buffer
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)
    # plan-independent prep products (COO endpoints, degree and weight sums)
    _prep: object = dataclasses.field(default=None, repr=False, compare=False)
    # which build made each layout: "host" (numpy), "cuda" or "cpu" (the
    # torch build on that device), "disk" (a layout cache hit)
    layout_builds: dict = dataclasses.field(default_factory=dict, repr=False,
                                            compare=False)
    # grid-only metadata (_GridMeta: shape, column geometry, row->col map);
    # None for 1-D placements
    _grid: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def padded_vertices(self) -> int:
        return self.num_chunks * self.chunk_size

    def chunk_of(self, v: np.ndarray) -> np.ndarray:
        """Owning chunk of a *padded* id (use ``global_to_local`` first for
        original ids)."""
        return v // self.chunk_size

    # -- 2-D grid views ------------------------------------------------------

    @property
    def is_grid(self) -> bool:
        return self._grid is not None

    @property
    def grid_shape(self) -> tuple | None:
        """(rows, cols) for grid partitions, None for 1-D placements."""
        return (self._grid.rows, self._grid.cols) if self.is_grid else None

    @property
    def col_chunk_size(self) -> int:
        """Padded height of one destination (column) chunk."""
        if not self.is_grid:
            raise ValueError("col_chunk_size is a grid-partition property")
        return self._grid.col_chunk_size

    # -- edge layouts --------------------------------------------------------

    def _layout(self, which: str) -> tuple:
        """Build-or-fetch one edge layout: the stable sort into the (owner,
        tile-bucket) order, the rectangle pack, and the band table -- on the
        host (bounded radix sort) or on a device (``_build_layout_device``,
        where ``_device_build_enabled`` names one), recorded in
        ``layout_builds``.  1-D placements expose ``basic``/``sd``; grid
        placements the single ``grid`` layout (owners are edge rectangles,
        destinations column-padded ids)."""
        if which not in self._lazy:
            if which not in ("basic", "sd", "grid"):
                raise ValueError(f"unknown layout {which!r}")
            if self.is_grid != (which == "grid"):
                raise ValueError(
                    f"layout {which!r} unavailable: "
                    + ("grid partitions expose only the 'grid' layout"
                       if self.is_grid else
                       "the 'grid' layout needs a grid(R,C) partition"))
            b = self._base
            C = self.num_chunks
            key_bound = C * b.nsb * b.nseg
            key_dtype = INT if key_bound <= 1 << 31 else np.int64
            owner_k = b.owner.astype(key_dtype)
            if which == "basic":
                # source block outermost (permuted CSR order, block-granular)
                key = (owner_k * b.nsb + b.src_blk) * b.nseg + b.seg_blk
            else:
                # destination segment block outermost (the paper's
                # dest-sorted send order, block-granular; the grid layout
                # scatters into its narrow column block, so the same order
                # keeps its bands tight)
                key = (owner_k * b.nseg + b.seg_blk) * b.nsb + b.src_blk
            device = (_device_build_enabled(len(key), C, b.emax)
                      if key_dtype is INT else None)
            if device is not None:
                s, d, w, band = _build_layout_device(b, key, C, device)
                self.layout_builds[which] = device.type
            else:
                order = _stable_argsort_bounded(key, key_bound)
                s, d, w = _pack_edges(order, b.src_local, b.dst, b.wgt,
                                      b.owner, b.per_chunk_e, C, b.emax)
                band = blocks.edge_bands_grouped(b.src_blk[order],
                                                 b.seg_blk[order],
                                                 b.per_chunk_e, b.emax)
                self.layout_builds[which] = "host"
            self._lazy[which] = (s, d, w, band)
        return self._lazy[which]

    @property
    def src_local(self) -> np.ndarray:
        return self._layout("basic")[0]

    @property
    def dst_global(self) -> np.ndarray:
        return self._layout("basic")[1]

    @property
    def edge_weight(self) -> np.ndarray:
        return self._layout("basic")[2]

    @property
    def band(self) -> np.ndarray:
        return self._layout("basic")[3]

    @property
    def sd_src_local(self) -> np.ndarray:
        return self._layout("sd")[0]

    @property
    def sd_dst_global(self) -> np.ndarray:
        return self._layout("sd")[1]

    @property
    def sd_edge_weight(self) -> np.ndarray:
        return self._layout("sd")[2]

    @property
    def sd_band(self) -> np.ndarray:
        return self._layout("sd")[3]

    @property
    def sd_edge_valid(self) -> np.ndarray:
        # one mask serves both layouts: row c has per_chunk_e[c] valid edges
        return self.edge_valid

    # -- grid (rectangle) layout accessors ----------------------------------

    @property
    def gr_src_local(self) -> np.ndarray:
        return self._layout("grid")[0]

    @property
    def gr_dst_col(self) -> np.ndarray:
        return self._layout("grid")[1]

    @property
    def gr_edge_weight(self) -> np.ndarray:
        return self._layout("grid")[2]

    @property
    def gr_band(self) -> np.ndarray:
        return self._layout("grid")[3]

    @property
    def gr_edge_valid(self) -> np.ndarray:
        # rectangle k has per_rect_e[k] valid edges
        if not self.is_grid:
            raise ValueError("gr_edge_valid is a grid-partition property")
        return self.edge_valid

    @property
    def gr_row_to_col(self) -> np.ndarray:
        """[R*C, K] row slot -> column-padded id of the same vertex (-1 at
        padding): the post-column-combine gather back into row state."""
        if not self.is_grid:
            raise ValueError("gr_row_to_col is a grid-partition property")
        return self._grid.row_to_col

    @property
    def rect_degree(self) -> np.ndarray:
        """[R*C, K] out-edges each row slot has IN each rectangle (a
        vertex's out-degree split across its row's rectangles by
        destination column); the per-rectangle frontier-load table
        ``partition_stats`` charges."""
        if not self.is_grid:
            raise ValueError("rect_degree is a grid-partition property")
        if "rect_degree" not in self._lazy:
            b = self._base
            P, K = self.num_chunks, self.chunk_size
            flat = b.owner.astype(np.int64) * K + b.src_local
            self._lazy["rect_degree"] = np.bincount(
                flat, minlength=P * K).astype(np.int64).reshape(P, K)
        return self._lazy["rect_degree"]

    def _rows(self, rows):
        """A device cache's row key: None for every chare row, so a mesh of
        one rank shares the whole upload."""
        return None if rows is None or tuple(rows) == (0, self.num_chunks) \
            else tuple(rows)

    def device_arrays(self, layout: str = "both", device="cuda",
                      rows=None) -> dict:
        """Device-resident layout tensors (edge planes + band table), uploaded
        once per (partition, layout, device, rows) and shared by every Engine
        built on it.  int32 planes stay int32, weights float32.  ``rows``
        (``(lo, hi)``; None: every chare) uploads those chare rows of each
        plane: a mesh rank's own row.

        The edge planes are widened to whole BLOCK_E edge blocks (padding
        edges invalid, source/destination 0, weight 1) -- the shape the band
        table already describes -- so the per-superstep push never has to
        copy them to pad.  On CUDA the band table's kernel paths and tile
        schedule (``push_fused.tile_plan``) are learned here, once.

        ``layout`` is ``"basic"``, ``"sd"``, ``"grid"`` (which also carries
        the ``[R*C, K]`` ``gr_row_to_col`` map) or ``"both"`` (a grid's one
        layout, or a 1-D placement's two).
        """
        if layout == "both":
            if self.is_grid:
                return self.device_arrays("grid", device, rows)
            return {**self.device_arrays("basic", device, rows),
                    **self.device_arrays("sd", device, rows)}
        edges, band = {
            "basic": (("src_local", "dst_global", "edge_valid",
                       "edge_weight"), "band"),
            "sd": (("sd_src_local", "sd_dst_global", "sd_edge_valid",
                    "sd_edge_weight"), "sd_band"),
            "grid": (("gr_src_local", "gr_dst_col", "gr_edge_valid",
                      "gr_edge_weight"), "gr_band"),
        }[layout]
        rows = self._rows(rows)
        key = (f"dense:{layout}", _device_key(device), rows)
        if key not in self._dev:
            arrs = {k: _upload(_pad_edges(getattr(self, k),
                                          1 if k.endswith("weight") else 0),
                               device, rows)
                    for k in edges}
            arrs[band] = _upload(getattr(self, band), device, rows)
            if layout == "grid":
                arrs["gr_row_to_col"] = _upload(self.gr_row_to_col, device,
                                                rows)
            if arrs[band].is_cuda:  # the kernel paths, learned before any run
                push_fused.tile_plan(arrs[band])
            self._dev[key] = arrs
        return self._dev[key]

    def device_pairwise(self, device="cuda", rows=None) -> dict:
        """Device-resident pairwise (edge-bucketed) layout for the basic
        variant: ``pb_*`` ``[C, C, Pmax]`` tensors, built and uploaded on
        first use per (device, rows), then shared.  ``pb_recv_dst``
        ``[C, C*Pmax]`` is ``pb_dst_local`` receiver-major (row k: every
        sender's pairs for chare k), the segment ids of basic's receive
        side.  ``rows`` as in ``device_arrays``: a sender's rows of the
        ``pb_*`` planes, a receiver's of ``pb_recv_dst``."""
        rows = self._rows(rows)
        key = ("pairwise", _device_key(device), rows)
        if key not in self._dev:
            pw = build_pairwise(self)
            arrs = {k: _upload(getattr(pw, k), device, rows)
                    for k in ("pb_src_local", "pb_dst_local", "pb_valid",
                              "pb_weight")}
            arrs["pb_recv_dst"] = _upload(np.ascontiguousarray(
                pw.pb_dst_local.transpose(1, 0, 2)).reshape(
                    self.num_chunks, -1), device, rows)
            self._dev[key] = arrs
        return self._dev[key]

    def device_aux(self, device="cuda", rows=None) -> dict:
        """Device-resident per-vertex auxiliaries (degree/weight/validity),
        of the chare ``rows`` when given."""
        rows = self._rows(rows)
        key = ("aux", _device_key(device), rows)
        if key not in self._dev:
            self._dev[key] = {
                k: _upload(getattr(self, k), device, rows)
                for k in ("out_degree", "out_weight", "vertex_valid")}
        return self._dev[key]

    def device_gate_blocks(self, layout: str, device="cuda",
                           rows=None) -> torch.Tensor:
        """``[C, nsb]`` bool on ``device``, ``nsb = ceil(K / BLOCK_V)``: the
        source blocks each chare's edges of ``layout`` (``"basic"``,
        ``"sd"``, ``"grid"`` or ``"pairwise"``) can gather from at all
        (``blocks.band_source_mask`` of its band table; all ones for the
        pairwise layout, which has none).  The frontier gate's geometry,
        uploaded once per (partition, layout, device, rows) and shared."""
        rows = self._rows(rows)
        key = (f"gate:{layout}", _device_key(device), rows)
        if key not in self._dev:
            nsb = max(-(-self.chunk_size // blocks.BLOCK_V), 1)
            band = {"basic": "band", "sd": "sd_band",
                    "grid": "gr_band"}.get(layout)
            mask = (blocks.band_source_mask(getattr(self, band), nsb) != 0
                    if band is not None
                    else np.ones((self.num_chunks, nsb), dtype=bool))
            self._dev[key] = _upload(mask, device, rows)
        return self._dev[key]

    def device_row_to_col(self, device="cuda", rows=None) -> torch.Tensor:
        """``gr_row_to_col`` on ``device`` alone, uploaded once per (device,
        rows): the one grid array phase 2 reads, and so all that a streamed
        engine keeps resident besides the vertex planes."""
        rows = self._rows(rows)
        key = ("row_to_col", _device_key(device), rows)
        if key not in self._dev:
            self._dev[key] = _upload(self.gr_row_to_col, device, rows)
        return self._dev[key]

    def repartition(self, partitioner: str, plan=None) -> "PartitionedGraph":
        """Re-place the same graph under another policy, cheaply.

        Reuses this partition's plan-independent prep (``_prep``: COO
        endpoints, degree and out-weight sums), so only the plan-dependent
        work runs again, and the layouts stay demand-built (``eager=False``):
        a replan whose engine reads one edge order never sorts the other.
        The result starts with an empty device-upload cache, so nothing of
        the old placement can be reused by an engine rebound to it.
        ``plan`` (optional) is an already-built plan for ``partitioner``.
        """
        if plan is None:
            plan = part_mod.make_plan(self.graph, self.num_chunks,
                                      partitioner)
        prep = self._prep if self._prep is not None else _edge_prep(self.graph)
        return _materialize(self.graph, plan, partitioner, prep, eager=False)

    def device_relabel(self, device="cuda") -> dict:
        """Device copies of the relabel maps, uploaded once per device:
        ``global_to_local`` ``[V]`` (the un-permute of a result is one
        ``index_select`` through it) and ``local_to_global`` ``[C*K]`` (where
        the batched plane's seeds land), both int64."""
        key = ("relabel", _device_key(device))
        if key not in self._dev:
            self._dev[key] = {
                k: _upload(getattr(self, k).astype(np.int64), device)
                for k in ("global_to_local", "local_to_global")}
        return self._dev[key]

    # -- out-of-core streaming -----------------------------------------------

    def cached_layout(self, which: str, cache_dir: str,
                      coll=None) -> tuple:
        """Disk-backed ``_layout``: a warm cache entry memory-maps the packed
        planes straight off disk (no sort, no pack, no host copy); a cold
        one builds once through ``_layout`` and persists atomically.  The
        entry is keyed by ``checkpoint.layout_fingerprint`` (graph bytes,
        partitioner spec, chare count, layout name), so a changed graph or
        policy misses and rebuilds.

        ``coll`` (a ``core.mesh.PeMesh`` whose ranks all ask for the same
        entry): rank 0 opens or builds and persists it, the others wait at
        a vote and then open it warm, so W ranks cold-starting on one
        ``cache_dir`` build it once and never race on the directory."""
        if coll is None or getattr(coll, "size", 1) == 1:
            return self._cached_layout(which, cache_dir)
        first = coll.rank == 0
        out = None
        if first:
            try:
                out = self._cached_layout(which, cache_dir)
            except BaseException:
                coll.vote(torch.ones(1, device=coll.device))
                raise
        if bool(coll.vote(torch.zeros(1, device=coll.device))[0]):
            raise RuntimeError(f"rank 0 failed to build the {which!r} "
                               f"layout cache entry in {cache_dir}")
        return out if first else self._cached_layout(which, cache_dir)

    def _cached_layout(self, which: str, cache_dir: str) -> tuple:
        from repro_torch.checkpoint import store

        fp = store.layout_fingerprint(self.graph, self.partitioner,
                                      self.num_chunks, which)
        hit = store.open_layout_cache(cache_dir, fp)
        if which in self._lazy or hit is None:
            # built here (an eager partition already holds it, or a miss
            # builds it now): serve it, and persist a missing entry so later
            # processes warm-start off disk
            s, d, w, band = self._layout(which)
            if hit is None:
                store.save_layout_cache(cache_dir, fp, {
                    "src": s, "dst": d, "weight": w, "band": band})
            return self._lazy[which]
        self._lazy[which] = (hit["src"], hit["dst"], hit["weight"],
                             hit["band"])
        self.layout_builds[which] = "disk"
        return self._lazy[which]

    def shard_source(self, windows: int | None = None,
                     budget_bytes: int | None = None,
                     cache_dir: str | None = None, rows=None,
                     coll=None) -> "ShardSource":
        """The windowed edge-shard provider for ``residency="stream"``.

        The window width comes from ``windows`` (a count) or is the widest
        for which TWO staging windows -- the double buffer -- fit under
        ``budget_bytes``; by default 8 windows.  With ``cache_dir`` the
        planes come from the disk layout cache (memory-mapped on a warm
        hit), so the host never holds a second copy of the edge layout.
        ``rows`` (``(lo, hi)``; None: every rectangle) serves those
        rectangles only, as views of the packs (memory-mapped ones
        included), and the budget sizes their windows; ``coll`` orders a
        mesh's ranks around a cold cache entry (``cached_layout``).
        """
        if not self.is_grid:
            raise ValueError(
                "residency='stream' needs a grid(R,C) partition: rectangles "
                "are the independently bounded shard unit (use grid(1,1) "
                "for a single PE)")
        if cache_dir is not None:
            s, d, w, band = self.cached_layout("grid", cache_dir, coll)
        else:
            s, d, w, band = self._layout("grid")
        valid = self.gr_edge_valid
        lo, hi = (0, self.num_chunks) if rows is None else rows
        s, d, w, band, valid = (a[lo:hi] for a in (s, d, w, band, valid))
        nb = blocks.num_edge_blocks(s.shape[1])
        per_block = _window_block_bytes(hi - lo)
        if windows is not None:
            if windows < 1:
                raise ValueError(f"windows must be >= 1, got {windows}")
            nbw = max(-(-nb // int(windows)), 1)
        elif budget_bytes is not None:
            nbw = int(budget_bytes // (2 * per_block))
            if nbw < 1:
                raise ValueError(
                    f"budget_bytes={budget_bytes} cannot hold the "
                    f"double-buffered working set: two single-block staging "
                    f"windows need {2 * per_block} bytes")
            nbw = min(nbw, nb)
        else:
            nbw = max(-(-nb // 8), 1)
        return ShardSource(src=s, dst=d, valid=valid, weight=w, band=band,
                           blocks_per_window=nbw)


def _stable_argsort_bounded(keys: np.ndarray, bound: int) -> np.ndarray:
    """Stable argsort of non-negative int keys known to be < ``bound``.

    For bounds under 2^30 this runs one or two int16 radix passes (numpy's
    stable sort is radix for 16-bit ints but mergesort for 32/64-bit, which
    is ~4x slower on edge-scale arrays); larger bounds fall back to the
    generic stable sort.
    """
    if bound <= 1 << 15:
        return np.argsort(keys.astype(np.int16), kind="stable")
    if bound <= 1 << 30:
        lo = (keys & 0x7FFF).astype(np.int16)
        hi = (keys >> 15).astype(np.int16)
        o1 = np.argsort(lo, kind="stable")
        return o1[np.argsort(hi[o1], kind="stable")]
    return np.argsort(keys, kind="stable")


def _pack_edges(order_idx, src_local, dst, wgt, owner, per_chunk_e,
                num_chunks, emax):
    """Scatter owner-grouped edges into the padded [C, Emax] rectangle.

    ``order_idx`` must list edges with owners grouped (nondecreasing); the
    slot of an edge within its row is its rank among same-owner edges.
    """
    so, do = src_local[order_idx], dst[order_idx]
    ow = owner[order_idx]
    starts = np.zeros(num_chunks, dtype=np.int64)
    np.cumsum(per_chunk_e[:-1], out=starts[1:])
    # ow is sorted, so flat = row offset + within-row slot is ascending:
    # flat[i] = ow[i]*emax + (i - starts[ow[i]])
    flat = (np.arange(len(order_idx), dtype=np.int64)
            + (np.arange(num_chunks, dtype=np.int64) * emax - starts)[ow])
    s = np.zeros((num_chunks, emax), dtype=INT)
    d = np.zeros((num_chunks, emax), dtype=INT)
    w = np.ones((num_chunks, emax), dtype=WEIGHT)
    s.ravel()[flat] = so
    d.ravel()[flat] = do
    w.ravel()[flat] = wgt[order_idx]
    return s, d, w


# Edge count from which the ``auto`` layout build runs on the card instead
# of the host radix path: scale-20 stand-ins cross it, every test-sized
# graph stays on the host build.  REPRO_DEVICE_BUILD=device|host overrides.
_DEVICE_BUILD_MIN_EDGES = 1 << 21


def _device_build_enabled(num_edges: int, num_chunks: int, emax: int):
    """The device the layout build runs on, or ``None`` for the host build.
    ``REPRO_DEVICE_BUILD``: ``host`` (or ``0``) never; ``device`` (or ``1``)
    always, on the card where there is one and else on the CPU; ``auto``
    (the default) on the card from ``_DEVICE_BUILD_MIN_EDGES`` edges.  The
    device pack scatters int32 flat indices into ``[C, NB*BLOCK_E]``, so a
    padded plane past int32 range keeps the host build."""
    mode = os.environ.get("REPRO_DEVICE_BUILD", "auto")
    if mode in ("host", "0"):
        return None
    nb = blocks.num_edge_blocks(emax)
    if num_chunks * nb * blocks.BLOCK_E >= 1 << 31:
        return None
    cuda = torch.cuda.is_available()
    if mode in ("device", "1"):
        return torch.device("cuda" if cuda else "cpu")
    if cuda and num_edges >= _DEVICE_BUILD_MIN_EDGES:
        return torch.device("cuda")
    return None


def _build_layout_device(b: "_EdgeBase", key: np.ndarray, C: int,
                         device) -> tuple:
    """The layout build in torch on ``device``, bit-identical to the host
    build: the stable sort into (owner, tile-bucket) order, the rectangle
    pack scatter and the band min/max.  Stability is the whole contract:
    equal keys give an equal permutation, so the packed planes and the band
    table equal the host radix path's bit for bit.  The packed planes come
    back to the host (they live there for the streamed shard source and the
    layout cache); the edge arrays go up once."""
    E = len(key)
    nb = blocks.num_edge_blocks(b.emax)
    emax_p = nb * blocks.BLOCK_E
    starts = np.zeros(C, dtype=np.int64)
    np.cumsum(b.per_chunk_e[:-1], out=starts[1:])
    row_off = np.arange(C, dtype=np.int64) * emax_p - starts

    def up(a, dtype=INT):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
            device)

    order = torch.sort(up(key), stable=True).indices
    # flat slot of each edge in the padded [C, emax_p] plane: the same
    # ascending row offset + within-row rank as _pack_edges
    flat = (torch.arange(E, dtype=torch.int64, device=device)
            + up(row_off, np.int64)[up(b.owner).index_select(0, order)
                                    .long()])

    def packed(a, fill, dtype=INT):
        vals = up(a, dtype).index_select(0, order)
        plane = torch.full((C * emax_p,), fill, dtype=vals.dtype,
                           device=device)
        return plane.index_copy_(0, flat, vals)

    def host(plane):
        return plane.reshape(C, emax_p)[:, :b.emax].contiguous().cpu().numpy()

    s = host(packed(b.src_local, 0))
    d = host(packed(b.dst, 0))
    w = host(packed(b.wgt, 1.0, WEIGHT))
    # band min/max over BLOCK_E columns: a fill that never wins at the
    # padding slots, then the (0, -1, 0, -1) empty-block convention
    shape = (C, nb, blocks.BLOCK_E)
    big = 1 << 30
    rows = []
    for blk in (b.src_blk, b.seg_blk):
        lo = packed(blk, big).reshape(shape).amin(dim=2)
        hi = packed(blk, -1).reshape(shape).amax(dim=2)
        rows += [torch.where(hi < 0, 0, lo), hi]
    band = torch.stack(rows, dim=1).to(torch.int32).cpu().numpy()
    return s, d, w, band


def _window_block_bytes(num_rects: int) -> int:
    """Staged bytes one BLOCK_E window column costs across all rectangles:
    src/dst/valid int32 + weight float32 planes plus the 4-row band slice."""
    return num_rects * blocks.BLOCK_E * 16 + num_rects * 4 * 4


# the staged edge planes, keyed as the resident grid arrays, and the
# ShardSource fields they are cut from
_STAGED_PLANES = (("gr_src_local", "src"), ("gr_dst_col", "dst"),
                  ("gr_edge_valid", "valid"), ("gr_edge_weight", "weight"))


@dataclasses.dataclass
class ShardSource:
    """Windowed edge-shard provider for ``residency="stream"``.

    Wraps one grid layout's packed planes -- host ndarrays or memory-mapped
    layout-cache files -- and serves BLOCK_E-aligned *edge windows*: window
    ``k`` of rectangle ``p`` is columns ``[k*W, (k+1)*W)`` of the
    ``[P, Emax]`` pack plus the matching band-table slice.  The streamed
    engine keeps only two staging windows on the device (the double
    buffer), so the device's edge footprint is ``2/num_windows`` of the
    resident layout whatever the graph's size.

    A staging slot (``make_staging``) is one flat int32 buffer holding the
    four edge planes and the window's row mask (``row_active``), so one
    copy takes a window to the device; the band slice stays beside it on
    the host (the engine's window folds read each window's band table from
    the device, ``window_bands``).
    """

    src: np.ndarray      # [P, Emax] int32 row-local sources
    dst: np.ndarray      # [P, Emax] int32 column-padded destinations
    valid: np.ndarray    # [P, Emax] int32 padding mask
    weight: np.ndarray   # [P, Emax] float32
    band: np.ndarray     # [P, 4, NB] int32
    blocks_per_window: int

    @property
    def num_rects(self) -> int:
        return self.src.shape[0]

    @property
    def emax(self) -> int:
        return self.src.shape[1]

    @property
    def num_blocks(self) -> int:
        return blocks.num_edge_blocks(self.emax)

    @property
    def num_windows(self) -> int:
        return -(-self.num_blocks // self.blocks_per_window)

    @property
    def window_edges(self) -> int:
        return self.blocks_per_window * blocks.BLOCK_E

    @property
    def origin(self) -> str:
        """"disk" when the planes are memory-mapped cache files."""
        return "disk" if isinstance(self.src, np.memmap) else "memory"

    @property
    def total_edge_bytes(self) -> int:
        """Bytes the RESIDENT path would upload for the edge layout."""
        return (self.src.nbytes + self.dst.nbytes + self.valid.nbytes
                + self.weight.nbytes + self.band.nbytes)

    @property
    def window_bytes(self) -> int:
        """Device bytes of ONE staging window (all rectangles)."""
        return _window_block_bytes(self.num_rects) * self.blocks_per_window

    @property
    def staging_words(self) -> int:
        """int32 words of a staging slot's buffer: four ``[P, W]`` edge
        planes and the ``[P]`` row mask."""
        return 4 * self.num_rects * self.window_edges + self.num_rects

    def staged_views(self, buf) -> dict:
        """The planes of one staging buffer (a flat int32 numpy array, or a
        torch tensor on any device): the edge planes ``[P, W]`` by their
        resident names (the weight plane's words read as float32) and the
        row mask ``row_active`` ``[P]``."""
        P, W = self.num_rects, self.window_edges
        f32 = np.float32 if isinstance(buf, np.ndarray) else torch.float32
        out = {}
        for i, (name, _) in enumerate(_STAGED_PLANES):
            plane = buf[i * P * W:(i + 1) * P * W].reshape(P, W)
            out[name] = plane.view(f32) if name == "gr_edge_weight" else plane
        out["row_active"] = buf[4 * P * W:4 * P * W + P]
        return out

    def make_staging(self, pin_memory: bool = False) -> dict:
        """One recycled host staging slot: ``staged_views`` of a fresh
        buffer (in pinned memory if asked), the band slice ``gr_band``
        ``[P, 4, blocks_per_window]``, and the buffer itself (``buffer``,
        a CPU torch tensor, what a copy to the device takes)."""
        buf = torch.zeros(self.staging_words, dtype=torch.int32,
                          pin_memory=pin_memory)
        out = self.staged_views(buf.numpy())
        out["gr_edge_weight"][...] = 1.0
        out["gr_band"] = np.zeros(
            (self.num_rects, 4, self.blocks_per_window), dtype=INT)
        out["buffer"] = buf
        return out

    def _band_slice(self, k: int):
        blo = k * self.blocks_per_window
        return blo, min(self.num_blocks, blo + self.blocks_per_window)

    def window_bands(self, device) -> list:
        """Each window's band table ``[P, 4, blocks_per_window]`` on
        ``device``, the ragged tail padded with empty blocks (0, -1, 0, -1)
        as ``read_window`` pads it: one tensor per window, so each learns
        its own tile plan (``push_fused.tile_plan`` caches plans per band
        tensor)."""
        out = []
        for k in range(self.num_windows):
            blo, bhi = self._band_slice(k)
            t = np.zeros((self.num_rects, 4, self.blocks_per_window),
                         dtype=INT)
            t[:, 1::2] = -1
            t[:, :, :bhi - blo] = self.band[:, :, blo:bhi]
            out.append(torch.from_numpy(t).to(device))
        return out

    def gate_masks(self, num_src_blocks: int) -> np.ndarray:
        """``[P, num_windows, nsb]`` bool: which gather-side source blocks
        each (rectangle, window) shard can read -- ``band_source_mask`` at
        window granularity.  A slot whose mask misses the live frontier is
        neither fetched nor pushed."""
        P, nw = self.num_rects, self.num_windows
        out = np.zeros((P, nw, num_src_blocks), dtype=bool)
        for k in range(nw):
            blo, bhi = self._band_slice(k)
            sub = np.ascontiguousarray(self.band[:, :, blo:bhi])
            out[:, k, :] = blocks.band_source_mask(sub, num_src_blocks) != 0
        return out

    @staticmethod
    def active_windows(gate_masks: np.ndarray,
                       frontier_blocks: np.ndarray) -> np.ndarray:
        """``[P, num_windows]`` bool fetch schedule: which (rectangle,
        window) slots the live frontier can reach at all.

        ``frontier_blocks`` is the BLOCK_V-granular frontier summary --
        ``[P, nsb]`` for one query, or ``[P, nsb, B]`` for the batched
        plane, where a slot stays active iff ANY live query column's
        frontier meets its band source blocks (the union gate: a window may
        be skipped only when it is dead for every query, and a fetched
        window contributes the identity to the columns whose frontier
        misses it).
        """
        fb = np.asarray(frontier_blocks)
        if fb.ndim == 3:
            fb = fb.any(axis=2)  # union over query columns
        return (gate_masks & fb[:, None, :]).any(axis=2)

    def read_window(self, k: int, staging: dict,
                    active: np.ndarray | None = None) -> int:
        """Copy window ``k`` into the recycled ``staging`` slot; returns the
        bytes read from the backing store.

        Rectangles with ``active[p] == False`` are not read: their staged
        edge rows keep what a previous window left, with the validity row,
        the band slice and ``row_active`` cleared, so every push path treats
        them as empty (the identity contribution frontier gating relies on).
        The ragged tail window is zero-masked the same way.  With every
        rectangle active the planes copy as whole slices (no temporary),
        else row by row.
        """
        lo = k * self.window_edges
        hi = min(self.emax, lo + self.window_edges)
        blo, bhi = self._band_slice(k)
        n, nbk = max(hi - lo, 0), max(bhi - blo, 0)
        act = (np.ones(self.num_rects, dtype=bool) if active is None
               else np.asarray(active, dtype=bool))
        staging["row_active"][...] = act
        bband = staging["gr_band"]
        bband[:, 0::2, :] = 0  # empty-block convention: (0, -1, 0, -1)
        bband[:, 1::2, :] = -1
        valid = staging["gr_edge_valid"]
        valid[:, n:] = 0
        valid[~act] = 0
        rows = np.flatnonzero(act) if n else np.zeros(0, dtype=np.int64)
        if len(rows) == 0:
            return 0
        every = len(rows) == self.num_rects
        read = 0
        for name, field in _STAGED_PLANES:
            plane, out = getattr(self, field), staging[name]
            if every:
                np.copyto(out[:, :n], plane[:, lo:hi])
            else:
                for p in rows:
                    np.copyto(out[p, :n], plane[p, lo:hi])
            read += len(rows) * n * plane.itemsize
        for p in rows:
            bband[p, :, :nbk] = self.band[p, :, blo:bhi]
        read += len(rows) * 4 * nbk * self.band.itemsize
        return read


@dataclasses.dataclass(frozen=True)
class _EdgePrep:
    """Plan-independent prep products, computed once per graph: the COO
    source expansion and the per-vertex weight-sum bincount."""

    src: np.ndarray  # [E] int32 COO sources, original ids
    dst: np.ndarray  # [E] int32 COO destinations, original ids
    wgt: np.ndarray  # [E] float32 weights (ones when unweighted)
    out_degrees: np.ndarray  # [V] int32
    wsum: np.ndarray  # [V] float32 per-vertex outgoing weight sums


def _edge_prep(graph: Graph) -> _EdgePrep:
    src = graph.src
    wgt = graph.edge_weights
    wsum = np.bincount(src, weights=wgt,
                       minlength=graph.num_vertices).astype(WEIGHT)
    return _EdgePrep(src, graph.dst, wgt, graph.out_degrees, wsum)


def partition(graph: Graph, num_chunks: int,
              partitioner: str = "contiguous",
              eager: bool = True) -> PartitionedGraph:
    """Split ``graph`` into ``num_chunks`` chares under a partitioner policy.

    ``partitioner`` names a registered 1-D policy or a ``grid(R,C)`` family
    member (``num_chunks == R*C``, one chare per edge rectangle); the
    default reproduces the paper's contiguous equal-vertex chunks.
    ``eager=False`` defers the edge-layout builds to first use, so an
    engine builds only its own.
    """
    plan = part_mod.make_plan(graph, num_chunks, partitioner)
    return _materialize(graph, plan, partitioner, _edge_prep(graph), eager)


@dataclasses.dataclass(frozen=True)
class _EdgeBase:
    """Relabeled-edge base shared by the layout builds of one partition:
    owner-local sources, padded destinations, the owner split, and the
    kernel-tile ids the sort keys and band tables are made of."""

    src_local: np.ndarray  # [E] int32 owner-local sources
    dst: np.ndarray  # [E] int32 scatter-space destinations (padded ids, or
    #                  column-padded ids on a grid)
    wgt: np.ndarray  # [E] float32
    owner: np.ndarray  # [E] owning chunk (or rectangle) of each edge
    per_chunk_e: np.ndarray  # [C]
    emax: int
    src_blk: np.ndarray  # [E] gather-side tile id (local source / BLOCK_V)
    seg_blk: np.ndarray  # [E] scatter-side tile id (scatter dest / BLOCK_S)
    nsb: int  # gather-side tile count per owner
    nseg: int  # scatter-side tile count


@dataclasses.dataclass(frozen=True)
class _GridMeta:
    """Grid-only metadata riding on ``PartitionedGraph._grid``."""

    rows: int
    cols: int
    col_chunk_size: int
    row_to_col: np.ndarray  # [R*C, K] int32, -1 at padding


def _materialize(graph: Graph, plan, partitioner: str, prep: _EdgePrep,
                 eager: bool = True) -> PartitionedGraph:
    """Build the chare decomposition for one ``PartitionPlan``;
    ``GridPlan`` placements route to ``_materialize_grid``."""
    if isinstance(plan, part_mod.GridPlan):
        return _materialize_grid(graph, plan, partitioner, prep, eager)
    num_chunks = plan.num_chunks
    chunk_size = plan.chunk_size
    padded = num_chunks * chunk_size
    g2l, l2g = plan.relabel()

    # relabel every edge endpoint into padded-id space; int32 halves the
    # memory traffic of the gathers/scatters below
    g2l32 = g2l.astype(INT)
    src = g2l32[prep.src]
    dst = g2l32[prep.dst]
    owner = src // chunk_size

    live = l2g >= 0
    deg = np.ones(padded, dtype=INT)  # 1 for padding (avoids div-by-zero)
    deg[live] = np.maximum(prep.out_degrees[l2g[live]], 1)
    vertex_valid = live.astype(INT)
    out_weight = np.ones(padded, dtype=WEIGHT)
    out_weight[live] = np.where(prep.wsum[l2g[live]] > 0,
                                prep.wsum[l2g[live]], 1.0)

    per_chunk_e = np.bincount(owner, minlength=num_chunks)
    emax = max(int(per_chunk_e.max()) if len(src) else 1, 1)
    # one validity mask serves both layouts: row c has per_chunk_e[c] edges
    edge_valid = (np.arange(emax) < per_chunk_e[:, None]).astype(INT)
    src_local = src - owner * chunk_size
    base = _EdgeBase(src_local, dst, prep.wgt, owner, per_chunk_e, emax,
                     src_blk=src_local // blocks.BLOCK_V,
                     seg_blk=dst // blocks.BLOCK_S,
                     nsb=-(-chunk_size // blocks.BLOCK_V),
                     nseg=-(-padded // blocks.BLOCK_S))

    pg = PartitionedGraph(
        graph=graph,
        num_chunks=num_chunks,
        chunk_size=chunk_size,
        vertex_valid=vertex_valid.reshape(num_chunks, chunk_size),
        out_degree=deg.reshape(num_chunks, chunk_size),
        out_weight=out_weight.reshape(num_chunks, chunk_size),
        edge_valid=edge_valid,
        partitioner=partitioner,
        global_to_local=g2l,
        local_to_global=l2g,
        plan=plan,
        _base=base,
        _prep=prep,
    )
    if eager:
        pg._layout("basic")
        pg._layout("sd")
    return pg


def _materialize_grid(graph: Graph, plan, partitioner: str, prep: _EdgePrep,
                      eager: bool = True) -> PartitionedGraph:
    """Build the rectangle decomposition for one ``GridPlan``.

    One chare per rectangle ``(r, c)``; the per-vertex planes (state width,
    degrees, validity) are the ROW layout replicated across each row's C
    rectangles, destinations are relabeled into the COLUMN-padded space the
    two-phase reduce combines over, and the edge layout orders each
    rectangle's edges by (segment block, source block) through the same
    radix pass as the 1-D layouts.
    """
    R, C = plan.rows, plan.cols
    P = R * C
    Kr, Kc = plan.chunk_size, plan.col_chunk_size
    row_g2l, row_l2g = plan.row.relabel()  # [V], [R*Kr]
    col_g2l, _ = plan.col.relabel()  # [V], [C*Kc]

    # state relabel: the row layout replicated across each row's rectangles;
    # g2l names the column-0 replica (engines read results from it), l2g
    # names every replica (so source seeding and id-valued inits hit all C)
    rrow = row_g2l // Kr
    g2l = rrow * C * Kr + (row_g2l - rrow * Kr)
    l2g = np.repeat(row_l2g.reshape(R, Kr), C, axis=0).reshape(-1)

    live = row_l2g >= 0
    deg = np.ones(R * Kr, dtype=INT)
    deg[live] = np.maximum(prep.out_degrees[row_l2g[live]], 1)
    out_weight = np.ones(R * Kr, dtype=WEIGHT)
    out_weight[live] = np.where(prep.wsum[row_l2g[live]] > 0,
                                prep.wsum[row_l2g[live]], 1.0)

    def rep(a):
        return np.repeat(a.reshape(R, Kr), C, axis=0)

    # row slot -> column-padded id of the same vertex: the gather map that
    # brings the column-combined vector back into (replicated) row state
    row_to_col = np.full(R * Kr, -1, dtype=INT)
    row_to_col[live] = col_g2l[row_l2g[live]].astype(INT)

    # relabel edges: row-local gather index, column-padded scatter id,
    # owning rectangle
    src_row = row_g2l.astype(INT)[prep.src]
    src_local = src_row % Kr
    dst_col = col_g2l.astype(INT)[prep.dst]
    owner = blocks.edge_rectangles(src_row // Kr, dst_col // Kc, C)
    per_rect_e = np.bincount(owner, minlength=P)
    emax = max(int(per_rect_e.max()) if len(src_local) else 1, 1)
    edge_valid = (np.arange(emax) < per_rect_e[:, None]).astype(INT)
    base = _EdgeBase(src_local, dst_col, prep.wgt, owner, per_rect_e, emax,
                     src_blk=src_local // blocks.BLOCK_V,
                     seg_blk=dst_col // blocks.BLOCK_S,
                     nsb=-(-Kr // blocks.BLOCK_V),
                     nseg=-(-(C * Kc) // blocks.BLOCK_S))

    pg = PartitionedGraph(
        graph=graph,
        num_chunks=P,
        chunk_size=Kr,
        vertex_valid=rep(live.astype(INT)),
        out_degree=rep(deg),
        out_weight=rep(out_weight),
        edge_valid=edge_valid,
        partitioner=partitioner,
        global_to_local=g2l,
        local_to_global=l2g,
        plan=plan,
        _base=base,
        _prep=prep,
        _grid=_GridMeta(R, C, Kc, rep(row_to_col)),
    )
    if eager:
        pg._layout("grid")
    return pg


@dataclasses.dataclass(frozen=True)
class PairwiseLayout:
    """Edge layout for the *basic* variant: per (source chunk, dest chunk)
    buckets of (src_local, dst_local) pairs, padded to the max bucket size.

    ``pb_*`` arrays are [C, C, Pmax]; row ``[c, k]`` holds chunk c's messages
    destined to chunk k -- Listing 2's ``outgoing[CHUNKINDEX(dest)]`` buffers.
    """

    pair_max: int
    pb_src_local: np.ndarray
    pb_dst_local: np.ndarray
    pb_valid: np.ndarray
    pb_weight: np.ndarray


def build_pairwise(pg: PartitionedGraph) -> PairwiseLayout:
    """Bucket edges by (source chunk, dest chunk), vectorized: one stable
    argsort over flattened bucket ids, then one scatter into the padded
    rectangle."""
    if pg.is_grid:
        raise ValueError("pairwise layout is 1-D only; grid partitions "
                         "already bucket edges by rectangle")
    prep = pg._prep if pg._prep is not None else _edge_prep(pg.graph)
    g2l32 = pg.global_to_local.astype(INT)
    src = g2l32[prep.src]
    dst = g2l32[prep.dst]
    wgt = prep.wgt
    K, C = pg.chunk_size, pg.num_chunks
    bucket = (src // K) * C + dst // K  # flattened (sc, dc)
    counts = np.bincount(bucket, minlength=C * C)
    pmax = max(int(counts.max()) if len(src) else 1, 1)
    order = _stable_argsort_bounded(bucket, C * C)
    bo = bucket[order]
    starts = np.zeros(C * C, dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    flat = (np.arange(len(order), dtype=np.int64)
            + (np.arange(C * C, dtype=np.int64) * pmax - starts)[bo])
    s = np.zeros((C, C, pmax), dtype=INT)
    d = np.zeros((C, C, pmax), dtype=INT)
    w = np.ones((C, C, pmax), dtype=WEIGHT)
    m = np.zeros((C, C, pmax), dtype=INT)
    s.ravel()[flat] = src[order] % K
    d.ravel()[flat] = dst[order] % K
    w.ravel()[flat] = wgt[order]
    m.ravel()[flat] = 1
    return PairwiseLayout(pair_max=pmax, pb_src_local=s, pb_dst_local=d,
                          pb_valid=m, pb_weight=w)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------


def ring(n: int, weighted: bool = False, weight_seed: int = 0) -> Graph:
    v = np.arange(n, dtype=INT)
    g = from_edges(n, v, (v + 1) % n)
    return random_weights(g, seed=weight_seed) if weighted else g


def two_cliques(n: int, weighted: bool = False, weight_seed: int = 0) -> Graph:
    """Two disjoint cliques of size n//2 -- a labelprop ground-truth fixture."""
    half = n // 2
    src_parts, dst_parts = [], []
    for base, size in ((0, half), (half, n - half)):
        i = np.arange(size, dtype=INT)
        s = np.repeat(i, size)
        d = np.tile(i, size)
        keep = s != d
        src_parts.append(base + s[keep])
        dst_parts.append(base + d[keep])
    g = from_edges(n, np.concatenate(src_parts).astype(INT),
                   np.concatenate(dst_parts).astype(INT))
    return random_weights(g, seed=weight_seed) if weighted else g


def erdos_renyi(n: int, num_edges: int, seed: int = 0,
                weighted: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=num_edges, dtype=INT)
    dst = rng.integers(0, n, size=num_edges, dtype=INT)
    keep = src != dst
    g = from_edges(n, src[keep], dst[keep])
    return random_weights(g, seed=seed) if weighted else g


def rmat(n_log2: int, num_edges: int, seed: int = 0,
         a=0.57, b=0.19, c=0.19, weighted: bool = False) -> Graph:
    """RMAT power-law generator (Graph500-style), vectorized."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    src = np.zeros(num_edges, dtype=np.int64)
    dst = np.zeros(num_edges, dtype=np.int64)
    for _ in range(n_log2):
        r = rng.random(num_edges)
        src = src * 2 + (r >= a + b)
        r2 = rng.random(num_edges)
        # quadrant probabilities conditioned on the row bit
        p_right = np.where(r >= a + b, c / (c + (1 - a - b - c)), b / (a + b))
        dst = dst * 2 + (r2 < p_right)
    keep = src != dst
    g = from_edges(n, src[keep].astype(INT), dst[keep].astype(INT))
    return random_weights(g, seed=seed) if weighted else g


# Scaled stand-ins for the paper's datasets (same E/V ratio, power-law skew).
_DATASETS = {
    # name: (n_log2, edge_multiple-of-V)   paper: V, E, E/V
    "soc-lj1-mini": (15, 14),   # soc-LiveJournal1: 4.8M, 69M, 14.2x
    "twitter-mini": (15, 24),   # twitter_rv: 61.6M, 1.47B, 23.8x
    "uk-2007-mini": (15, 35),   # uk-2007-05: 105.9M, 3.74B, 35.3x
}


def load_dataset(name: str, scale_log2: int | None = None, seed: int = 1,
                 weighted: bool = False) -> Graph:
    n_log2, mult = _DATASETS[name]
    if scale_log2 is not None:
        n_log2 = scale_log2
    return rmat(n_log2, (1 << n_log2) * mult, seed=seed, weighted=weighted)


def dataset_names():
    return list(_DATASETS)
