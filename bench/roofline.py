"""The least work a superstep needs, and the card's published peaks.

Counted from the graph and the program alone -- |V|, the edges the
superstep must read, the plane width B, whether it reads weights -- and
never from the program's layout, so the count stays the same whatever
kernel or layout does the work.  Each input byte is read once and each
output byte written once:

* 4 B an active vertex for its CSR offset, 4 B an edge it pushes along
  for the destination id, 4 B more for the edge's weight where the program
  reads weights;
* the vertex values, read once and written once: 2 x 4 B x V x B.

An add-monoid program (the PageRanks) pushes every vertex along every
edge in each superstep.  A min program (bfs, sssp) needs only the edges
out of the vertices that changed in the superstep before (the seeds,
first), as the reference's own run finds them
(``reference.programs.Traversal``).

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit --
3.35 TB/s of HBM3 and 67 TFLOP/s in float32 outside the tensor cores.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
WORD = 4  # bytes: int32 ids and offsets, float32 / int32 values


def superstep_bytes(num_vertices: int, active_vertices: int,
                    active_edges: int, batch: int = 1,
                    weighted: bool = False) -> int:
    edge_words = 2 if weighted else 1
    return WORD * (active_vertices + edge_words * active_edges
                   + 2 * num_vertices * batch)


def superstep_flops(active_edges: int, batch: int = 1,
                    weighted: bool = False) -> int:
    """One combine an edge and column, one multiply (or add) more for a
    weight."""
    return active_edges * batch * (2 if weighted else 1)


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the two bounds: time at peak bandwidth or peak float32
    rate."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def run_work(num_vertices: int, num_edges: int, supersteps: int,
             weighted: bool, active_vertices=None, active_edges=None,
             batch: int = 1) -> tuple[int, int]:
    """(bytes, flops) of one whole run: every superstep at full width, or,
    given the per-superstep active counts of a min program, each at its
    own."""
    if active_vertices is None:
        active_vertices = [num_vertices] * supersteps
        active_edges = [num_edges] * supersteps
    nbytes = sum(superstep_bytes(num_vertices, v, e, batch, weighted)
                 for v, e in zip(active_vertices, active_edges))
    flops = sum(superstep_flops(e, batch, weighted) for e in active_edges)
    return nbytes, flops
