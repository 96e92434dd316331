"""Graph representation and chare-style partitioning (1-D placements).

The port's copy of the host half of ``repro/core/graph.py``.  The paper
assigns contiguous chunks of vertices to actors (chares); each chare stores
its local vertices in index order plus the destinations of their outgoing
edges.  ``Graph`` is the global CSR; ``PartitionedGraph`` is the chare
decomposition with padded, rectangular ``[C, ...]`` per-chunk arrays.  The
host layout build is numpy and produces arrays equal to the reference's for
the same graph, partitioner and chare count; ``device_arrays`` /
``device_aux`` / ``device_pairwise`` upload them as torch tensors.

Real datasets from the paper (soc-LiveJournal1, twitter_rv, uk-2007-05) are
not available offline; ``load_dataset`` provides scaled RMAT stand-ins with
the same edge/vertex ratios (14x, 24x, 35x).
"""

from __future__ import annotations

import dataclasses

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


def _upload(a: np.ndarray, device) -> torch.Tensor:
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

    def _layout(self, which: str) -> tuple:
        """Build-or-fetch one edge layout: the bounded radix sort into the
        (owner, tile-bucket) order, the rectangle pack, and the band table."""
        if which not in self._lazy:
            if which not in ("basic", "sd"):
                raise ValueError(f"unknown layout {which!r}; 1-D partitions "
                                 "expose 'basic' and 'sd'")
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
                # dest-sorted send order, block-granular)
                key = (owner_k * b.nseg + b.seg_blk) * b.nsb + b.src_blk
            order = _stable_argsort_bounded(key, key_bound)
            s, d, w = _pack_edges(order, b.src_local, b.dst, b.wgt,
                                  b.owner, b.per_chunk_e, C, b.emax)
            band = blocks.edge_bands_grouped(b.src_blk[order],
                                             b.seg_blk[order],
                                             b.per_chunk_e, b.emax)
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

    def device_arrays(self, layout: str = "both", device="cuda") -> dict:
        """Device-resident layout tensors (edge planes + band table), uploaded
        once per (partition, layout, device) and shared by every Engine built
        on it.  int32 planes stay int32, weights float32.

        The edge planes are widened to whole BLOCK_E edge blocks (padding
        edges invalid, source/destination 0, weight 1) -- the shape the band
        table already describes -- so the per-superstep push never has to
        copy them to pad.  On CUDA the band table's kernel paths and tile
        schedule (``push_fused.tile_plan``) are learned here, once.
        """
        if layout == "both":
            return {**self.device_arrays("basic", device),
                    **self.device_arrays("sd", device)}
        names = {
            "basic": ("src_local", "dst_global", "edge_valid", "edge_weight",
                      "band"),
            "sd": ("sd_src_local", "sd_dst_global", "sd_edge_valid",
                   "sd_edge_weight", "sd_band"),
        }[layout]
        key = (f"dense:{layout}", _device_key(device))
        if key not in self._dev:
            fill = {"edge_weight": 1, "sd_edge_weight": 1}
            arrs = {
                k: _upload(getattr(self, k) if k.endswith("band")
                           else _pad_edges(getattr(self, k), fill.get(k, 0)),
                           device)
                for k in names}
            band = arrs[names[-1]]
            if band.is_cuda:  # the kernel paths, learned before any run
                push_fused.tile_plan(band)
            self._dev[key] = arrs
        return self._dev[key]

    def device_pairwise(self, device="cuda") -> dict:
        """Device-resident pairwise (edge-bucketed) layout for the basic
        variant: ``pb_*`` ``[C, C, Pmax]`` tensors, built and uploaded on
        first use per device, then shared.  ``pb_recv_dst`` ``[C, C*Pmax]``
        is ``pb_dst_local`` receiver-major (row k: every sender's pairs for
        chare k), the segment ids of basic's receive side."""
        key = ("pairwise", _device_key(device))
        if key not in self._dev:
            pw = build_pairwise(self)
            arrs = {k: _upload(getattr(pw, k), device)
                    for k in ("pb_src_local", "pb_dst_local", "pb_valid",
                              "pb_weight")}
            arrs["pb_recv_dst"] = _upload(np.ascontiguousarray(
                pw.pb_dst_local.transpose(1, 0, 2)).reshape(
                    self.num_chunks, -1), device)
            self._dev[key] = arrs
        return self._dev[key]

    def device_aux(self, device="cuda") -> dict:
        """Device-resident per-vertex auxiliaries (degree/weight/validity)."""
        key = ("aux", _device_key(device))
        if key not in self._dev:
            self._dev[key] = {
                "out_degree": _upload(self.out_degree, device),
                "out_weight": _upload(self.out_weight, device),
                "vertex_valid": _upload(self.vertex_valid, device),
            }
        return self._dev[key]


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

    ``partitioner`` names a registered 1-D policy; the default reproduces
    the paper's contiguous equal-vertex chunks.  ``eager=False`` defers the
    edge-layout builds to first use, so an engine builds only its own.
    """
    plan = part_mod.make_plan(graph, num_chunks, partitioner)
    return _materialize(graph, plan, partitioner, _edge_prep(graph), eager)


@dataclasses.dataclass(frozen=True)
class _EdgeBase:
    """Relabeled-edge base shared by the layout builds of one partition:
    owner-local sources, padded destinations, the owner split, and the
    kernel-tile ids the sort keys and band tables are made of."""

    src_local: np.ndarray  # [E] int32 owner-local sources
    dst: np.ndarray  # [E] int32 padded destinations
    wgt: np.ndarray  # [E] float32
    owner: np.ndarray  # [E] owning chunk of each edge
    per_chunk_e: np.ndarray  # [C]
    emax: int
    src_blk: np.ndarray  # [E] gather-side tile id (local source / BLOCK_V)
    seg_blk: np.ndarray  # [E] scatter-side tile id (padded dest / BLOCK_S)
    nsb: int  # gather-side tile count per owner
    nseg: int  # scatter-side tile count


def _materialize(graph: Graph, plan, partitioner: str, prep: _EdgePrep,
                 eager: bool = True) -> PartitionedGraph:
    """Build the chare decomposition for one ``PartitionPlan``."""
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
