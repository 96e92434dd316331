"""Seeded Graph500 RMAT graphs, drawn with torch on the device.

The benchmark owns its inputs: every run draws its configuration's graph
from the configuration's own seed on the card in a few large calls, sorts
it into CSR there and copies the arrays to the host once.  The distribution
is the Graph500 RMAT one (a=0.57, b=c=0.19, d=0.05, self-loops dropped, no
vertex relabel), at the sizes of the program's own numpy ``rmat``
stand-ins; the bits are not.  Weights, where the configuration asks for
them, are uniform in [1, 10).

Nothing here imports the program: ``Csr`` holds plain numpy arrays, and
the harness hands them to the system under test and to the references
alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Edges drawn per call: bounds the temporaries of one chunk (two float32
# draws and two int32 id words per edge) whatever the graph's size.
CHUNK_EDGES = 1 << 25


@dataclasses.dataclass(frozen=True)
class Csr:
    """A directed graph in CSR form: ``dst[indptr[v]:indptr[v + 1]]`` are
    v's out-neighbours; ``weight`` is aligned with ``dst`` or None."""

    num_vertices: int
    indptr: np.ndarray  # [V + 1] int64
    dst: np.ndarray  # [E] int32
    weight: np.ndarray | None  # [E] float32 or None

    @property
    def num_edges(self) -> int:
        return int(self.dst.shape[0])

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def rmat_edges(scale: int, num_edges: int, gen: torch.Generator,
               a: float = 0.57, b: float = 0.19, c: float = 0.19):
    """``num_edges`` RMAT draws on ``gen``'s device as int32 (src, dst),
    self-loops dropped.  Each bit level picks the row half with probability
    a + b, then the column half conditioned on the row: quadrant b given
    the upper half, quadrant d = 1 - a - b - c given the lower one (Graph500's
    law; the program's ``rmat`` gives the lower half's right column c
    instead)."""
    device = gen.device
    p_low, p_high = b / (a + b), (1.0 - a - b - c) / (1.0 - a - b)
    srcs, dsts = [], []
    for start in range(0, num_edges, CHUNK_EDGES):
        n = min(CHUNK_EDGES, num_edges - start)
        src = torch.zeros(n, dtype=torch.int32, device=device)
        dst = torch.zeros(n, dtype=torch.int32, device=device)
        for _ in range(scale):
            row = torch.rand(n, generator=gen, device=device) >= a + b
            r2 = torch.rand(n, generator=gen, device=device)
            col = torch.where(row, r2 < p_high, r2 < p_low)
            src.mul_(2).add_(row.to(torch.int32))
            dst.mul_(2).add_(col.to(torch.int32))
        keep = src != dst
        srcs.append(src[keep])
        dsts.append(dst[keep])
    return torch.cat(srcs), torch.cat(dsts)


def rmat_csr(scale: int, edge_factor: int, seed: int, device,
             weighted: bool = False, a: float = 0.57, b: float = 0.19,
             c: float = 0.19) -> Csr:
    """The configuration's graph for ``seed``: ``edge_factor * 2**scale``
    RMAT draws on ``device``, sorted by source there (stable, so the
    adjacency order is the draw order), weights uniform in [1, 10) drawn
    after the sort, and the arrays copied to the host once."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    V = 1 << scale
    src, dst = rmat_edges(scale, edge_factor * V, gen, a, b, c)
    order = torch.sort(src, stable=True).indices
    dst = dst.index_select(0, order)
    counts = torch.bincount(src, minlength=V)
    del src, order
    indptr = torch.zeros(V + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=indptr[1:])
    weight = None
    if weighted:
        weight = (1.0 + 9.0 * torch.rand(dst.shape[0], generator=gen,
                                         device=device)).cpu().numpy()
    return Csr(V, indptr.cpu().numpy(), dst.cpu().numpy(), weight)


def vertices_with_out_edges(g: Csr) -> np.ndarray:
    """The ids a query or a traversal may start from."""
    return np.flatnonzero(g.out_degrees > 0)
