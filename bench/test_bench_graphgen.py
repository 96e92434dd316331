"""The seeded RMAT graph: reproducible, sized as configured, skewed, and
accepted by the program's ``Graph``."""

import numpy as np
import pytest

from bench import graphgen

SCALE, FACTOR = 10, 14


@pytest.fixture(scope="module")
def graph():
    return graphgen.rmat_csr(SCALE, FACTOR, 2**31 + 11, "cpu", weighted=True)


def test_same_seed_same_arrays_other_seed_other(graph):
    again = graphgen.rmat_csr(SCALE, FACTOR, 2**31 + 11, "cpu", weighted=True)
    other = graphgen.rmat_csr(SCALE, FACTOR, 12, "cpu", weighted=True)
    for a, b in ((graph.indptr, again.indptr), (graph.dst, again.dst),
                 (graph.weight, again.weight)):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(graph.dst[:100], other.dst[:100])


def test_size_and_csr_form(graph):
    V = 1 << SCALE
    assert graph.num_vertices == V
    assert graph.indptr.shape == (V + 1,) and graph.indptr.dtype == np.int64
    assert graph.dst.dtype == np.int32 and graph.weight.dtype == np.float32
    # E/V as configured, less the self-loops (about 1/4 of the diagonal's
    # chance per bit, a few percent at this scale)
    assert 0.9 * FACTOR * V < graph.num_edges <= FACTOR * V
    assert graph.indptr[-1] == graph.num_edges
    src = np.repeat(np.arange(V), graph.out_degrees)
    assert not np.any(src == graph.dst)
    assert graph.weight.min() >= 1.0 and graph.weight.max() < 10.0


def test_degree_skew_is_rmat(graph):
    """Graph500's law concentrates the edges: the top 1% of vertices hold
    far more than a uniform graph's 1% of them."""
    deg = np.sort(graph.out_degrees)[::-1]
    top = deg[: len(deg) // 100].sum() / deg.sum()
    assert top > 0.08
    assert deg[0] > 10 * deg.mean()
    indeg = np.bincount(graph.dst, minlength=graph.num_vertices)
    # in-degrees follow a + c = 0.76 per column bit, as out-degrees do
    assert abs(np.log(indeg.max() / deg[0])) < np.log(2.5)


def test_the_program_accepts_the_arrays(graph):
    from repro_torch.core.graph import Graph, partition

    g = Graph(num_vertices=graph.num_vertices, indptr=graph.indptr,
              dst=graph.dst, weight=graph.weight)
    pg = partition(g, 1, eager=False)
    assert pg.graph.num_edges == graph.num_edges
    np.testing.assert_array_equal(g.out_degrees, graph.out_degrees)
