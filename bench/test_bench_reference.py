"""The plain references against the program at a tiny size, and the
roofline's byte count on hand-counted graphs.  The tests may import both;
the references import nothing of the program."""

import numpy as np
import pytest
import torch

from bench import graphgen, roofline
from bench.reference import programs as ref

SCALE = 9


@pytest.fixture(scope="module")
def case():
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import Graph, partition

    csr = graphgen.rmat_csr(SCALE, 14, 7, "cpu", weighted=True)
    g = Graph(num_vertices=csr.num_vertices, indptr=csr.indptr, dst=csr.dst,
              weight=csr.weight)
    eng = Engine(partition(g, 1), strategy="sortdest", device="cpu")
    rg = ref.upload(csr.indptr, csr.dst, csr.weight, "cpu")
    return csr, eng, rg


@pytest.mark.parametrize("program", ["pagerank", "pagerank_weighted"])
def test_pageranks_match_the_program(case, program):
    _, eng, rg = case
    got, iters = eng.run(program, iters=20)
    want = ref.pagerank(rg, iters=20, weighted=program == "pagerank_weighted")
    assert iters == 20
    rel = np.max(np.abs(got - want.numpy()) / want.numpy())
    assert rel < 1e-5


@pytest.mark.parametrize("program", ["bfs", "sssp"])
def test_traversals_match_the_program_exactly(case, program):
    csr, eng, rg = case
    for source in graphgen.vertices_with_out_edges(csr)[[0, 5, 40]]:
        got, iters = eng.run(program, source=int(source))
        want = getattr(ref, program)(rg, int(source))
        np.testing.assert_array_equal(got, want.value.numpy())
        assert iters == want.supersteps


def test_personalized_pagerank_matches_the_program(case):
    csr, eng, rg = case
    sources = [int(s) for s in graphgen.vertices_with_out_edges(csr)[:3]]
    plane, iters = eng.run_batch("personalized_pagerank", sources=sources,
                                 batch=4, iters=8)
    for row, s in zip(plane, sources):
        want = ref.personalized_pagerank(rg, s, iters=8).numpy()
        assert np.max(np.abs(row - want)) / want.max() < 1e-5
    assert list(iters) == [8, 8, 8]


def test_bfloat16_reference_departs():
    """The control's arithmetic is really lower: its ranks move."""
    csr = graphgen.rmat_csr(SCALE, 14, 3, "cpu", weighted=True)
    rg = ref.upload(csr.indptr, csr.dst, csr.weight, "cpu")
    hi = ref.pagerank(rg)
    lo = ref.pagerank(rg, dtype=torch.bfloat16).to(torch.float64)
    assert float(((lo - hi).abs() / hi).max()) > 1e-3


# 0 -> 1, 0 -> 2, 1 -> 2, 2 -> 3: four vertices, four edges
TINY = (np.array([0, 2, 3, 4, 4]), np.array([1, 2, 2, 3], np.int32),
        np.array([1.0, 2.0, 3.0, 4.0], np.float32))


def test_traversal_counts_the_frontier_by_hand():
    rg = ref.upload(*TINY, "cpu")
    t = ref.bfs(rg, 0)
    assert t.value.tolist() == [0, 1, 1, 2]
    # superstep 1 pushes the seed's 2 edges; 2 pushes vertices 1 and 2
    # (one edge each); 3 pushes vertex 3 (none) and changes nothing
    assert (t.supersteps, t.active_vertices, t.active_edges) \
        == (3, [1, 2, 1], [2, 2, 0])
    s = ref.sssp(rg, 0)
    assert s.value.tolist() == [0.0, 1.0, 2.0, 6.0]


def test_superstep_bytes_by_hand():
    V, E = 4, 4
    # offsets 4 B x 4 + ids 4 B x 4 + values read and written 2 x 4 B x 4
    assert roofline.superstep_bytes(V, V, E) == 64
    assert roofline.superstep_bytes(V, V, E, weighted=True) == 80
    assert roofline.superstep_bytes(V, V, E, batch=8) == 4 * (4 + 4 + 64)
    # the bfs above: frontiers of (1 vertex, 2 edges), (2, 2), (1, 0)
    nbytes, flops = roofline.run_work(V, E, 3, False, [1, 2, 1], [2, 2, 0])
    assert nbytes == 4 * (1 + 2 + 8) + 4 * (2 + 2 + 8) + 4 * (1 + 0 + 8)
    assert flops == 4
    nbytes, flops = roofline.run_work(V, E, 20, True)
    assert (nbytes, flops) == (20 * 80, 20 * 8)
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
