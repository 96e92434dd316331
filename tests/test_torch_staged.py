"""The staged push of the torch port against the JAX reference.

On the CPU the port's staged kernels (``push_staged``) run their plain
torch versions; the reference's ``push_sum``/``push_min`` Pallas kernels run
in interpret mode, as its own tests run them.  Both get the same
numpy-seeded inputs:

* the four kernels one by one on block-padded shapes (E <= 2048,
  V <= 1024);
* ``ops.push(fused=False)`` over the ``test_torch_kernels.py`` operand
  matrix (add/min x int/float x weighted/unit x [B] plane x init seed,
  all-invalid edges, the saturation boundary);
* ``segment_reduce`` (ints as ints past 2^24, batched columns, float min's
  +inf) and ``make_segment_fn``'s combine inference;
* the ``segment_fn`` and ``make_push_fn(fused=False)`` engine cells of
  ``tests/test_fused.py`` and the quickstart twin.

Tolerances: gathers, min and int sums bit-equal; float sums within
rtol=1e-6 and atol=1e-6*max|out| (both sides run on the CPU and differ only
in the order they sum in).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import (ALL_PARTITIONERS, ALL_STRATEGIES, program_graph,
                      serial_ref, source_params)
from repro.kernels import ops as rops
from repro.kernels import push_min, push_sum
from repro_torch.core import Engine, get_spec, graph_from_reference
from repro_torch.core import graph as TG
from repro_torch.core import programs as TPROG
from repro_torch.core import run_parallel
from repro_torch.kernels import ops, push_fused, push_staged

SENTINEL = push_fused.SENTINEL
PADDED = [(256, 256), (512, 256), (1024, 512), (2048, 1024)]
SHAPES = [(1, 1), (257, 300), (2048, 640)]


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


def assert_add_close(got, want):
    assert got.dtype == want.dtype
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def _coo(rng, E, V):
    return (rng.integers(0, V, E).astype(np.int32),
            rng.integers(0, V, E).astype(np.int32),
            rng.integers(0, 2, E).astype(np.int32))


# ---------------------------------------------------------------------------
# The four kernels' plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,V", PADDED)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_sum_matches_reference(E, V, dtype):
    rng = np.random.default_rng(E + V)
    src, _, valid = _coo(rng, E, V)
    vals = (rng.normal(size=V) if dtype == np.float32
            else rng.integers(1 << 24, 1 << 30, V)).astype(dtype)
    got = push_staged.gather_sum(*map(torch.from_numpy, (src, valid, vals)))
    want = np.asarray(push_sum.gather_sum(*map(jnp.asarray,
                                              (src, valid, vals))))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("E,V", PADDED)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_gather_min_matches_reference(E, V, dtype):
    rng = np.random.default_rng(E * V)
    src, _, valid = _coo(rng, E, V)
    if dtype == np.float32:  # +inf, the sentinel range and negatives
        vals = rng.normal(size=V).astype(np.float32) * 100
        vals[::5] = np.inf
        vals[1::7] = 3e9
    else:
        vals = rng.integers(0, SENTINEL, V, dtype=np.int64).astype(np.int32)
    got = push_staged.gather_min(*map(torch.from_numpy, (src, valid, vals)))
    want = np.asarray(push_min.gather_min(*map(jnp.asarray,
                                              (src, valid, vals))))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("E,S", PADDED)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scatter_sum_matches_reference(E, S, dtype):
    rng = np.random.default_rng(E - S)
    dst = rng.integers(0, S, E).astype(np.int32)
    c = (rng.normal(size=E) if dtype == np.float32
         else rng.integers(1 << 24, 1 << 26, E)).astype(dtype)
    got = push_staged.scatter_sum(torch.from_numpy(dst), torch.from_numpy(c),
                                  S).numpy()
    want = np.asarray(push_sum.scatter_sum(jnp.asarray(dst), jnp.asarray(c),
                                           S))
    if dtype == np.float32:
        assert_add_close(got, want)
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,S", PADDED)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_scatter_min_matches_reference(E, S, dtype):
    rng = np.random.default_rng(E + 3 * S)
    dst = rng.integers(0, S, E).astype(np.int32)
    if dtype == np.float32:
        c = rng.normal(size=E).astype(np.float32) * 50
        c[::6] = np.inf
    else:
        c = rng.integers(0, 1 << 30, E).astype(np.int32)
        c[::6] = SENTINEL
    got = push_staged.scatter_min(torch.from_numpy(dst), torch.from_numpy(c),
                                  S)
    want = push_min.scatter_min(jnp.asarray(dst), jnp.asarray(c), S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_out_of_range_ids_read_identity_and_drop():
    """A source outside [0, V) gathers the identity and a destination
    outside [0, S) is dropped, as the Pallas kernels' one-hot tiles do."""
    src = np.array([-1, 0, 300, 5] + [0] * 252, np.int32)
    valid = np.ones(256, np.int32)
    vals = np.arange(256, dtype=np.float32) + 1
    t, j = torch.from_numpy, jnp.asarray
    for mine, theirs in ((push_staged.gather_sum, push_sum.gather_sum),
                         (push_staged.gather_min, push_min.gather_min)):
        np.testing.assert_array_equal(
            mine(t(src), t(valid), t(vals)).numpy(),
            np.asarray(theirs(j(src), j(valid), j(vals))))
    dst = np.array([-3, 1, 256, 2] + [0] * 252, np.int32)
    for mine, theirs in ((push_staged.scatter_sum, push_sum.scatter_sum),
                         (push_staged.scatter_min, push_min.scatter_min)):
        np.testing.assert_array_equal(
            mine(t(dst), t(vals), 256).numpy(),
            np.asarray(theirs(j(dst), j(vals), 256)))


@pytest.mark.parametrize("kernel", ["gather_sum", "gather_min",
                                    "scatter_sum", "scatter_min"])
@pytest.mark.parametrize("batch", [None, 3])
def test_rows_and_columns_equal_one_row_one_column(kernel, batch):
    """One call over [C, E] chare rows and a trailing [B] plane equals the
    reference's loop: one row and one column at a time."""
    rng = np.random.default_rng(1)
    C, E, V = 3, 500, 200
    tail = () if batch is None else (batch,)
    idx = torch.from_numpy(rng.integers(0, V, (C, E)).astype(np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, (C, E)).astype(np.int32))
    n = V if kernel.startswith("gather") else E
    x = torch.from_numpy(rng.integers(0, 1000, (C, n) + tail)
                         .astype(np.int32))
    fn = getattr(push_staged, kernel)
    call = ((lambda i, v, a: fn(i, v, a)) if kernel.startswith("gather")
            else (lambda i, v, a: fn(i, a, V)))
    got = call(idx, valid, x)
    for r in range(C):
        for b in range(batch or 1):
            col = x[r] if batch is None else x[r][:, b].contiguous()
            want = call(idx[r], valid[r], col)
            have = got[r] if batch is None else got[r][:, b]
            torch.testing.assert_close(have, want, rtol=0, atol=0)


def test_gather_sum_dtypes():
    """Ints stay ints, floats widen to at least float32 (bf16 exactly)."""
    src = torch.tensor([2, 0, 1], dtype=torch.int32)
    valid = torch.tensor([1, 1, 0], dtype=torch.int32)
    bf = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    got = push_staged.gather_sum(src, valid, bf)
    assert got.dtype == torch.float32
    assert got.tolist() == [3.0, 1.5, 0.0]
    big = torch.full((3,), (1 << 24) + 1, dtype=torch.int32)
    assert push_staged.gather_sum(src, valid, big).dtype == torch.int32
    assert push_staged.gather_sum_dtype(torch.float64) == torch.float64
    assert push_staged.gather_min(src, valid, bf).dtype == torch.bfloat16


def test_wrappers_refuse_other_devices():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    for fn, args in ((push_staged.gather_sum, (z, z, z)),
                     (push_staged.gather_min, (z, z, z)),
                     (push_staged.scatter_sum, (z, z, 4)),
                     (push_staged.scatter_min, (z, z, 4))):
        with pytest.raises(ValueError, match="meta"):
            fn(*args)


# ---------------------------------------------------------------------------
# ops.push(fused=False) vs the reference's staged pair
# ---------------------------------------------------------------------------


def staged_both(vals, src, dst, valid, V, **kw):
    """(port, reference) results of ops.push(fused=False)."""
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: j(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = ops.push(t(vals), t(src), t(dst), t(valid), V, fused=False, **tkw)
    want = rops.push(j(vals), j(src), j(dst), j(valid), V, fused=False,
                     **jkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_unfused_add_float_matches_reference(E, V, weighted, batch):
    rng = np.random.default_rng(E)
    src, dst, valid = _coo(rng, E, V)
    shape = (V,) if batch is None else (V, batch)
    vals = rng.normal(size=shape).astype(np.float32)
    w = rng.uniform(1.0, 4.0, E).astype(np.float32) if weighted else None
    got, want = staged_both(vals, src, dst, valid, V, combine="add",
                            weight=w)
    assert got.shape == shape
    assert_add_close(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_unfused_add_int_matches_reference_exactly(E, V, weighted):
    rng = np.random.default_rng(V)
    src, dst, valid = _coo(rng, E, V)
    vals = rng.integers(1 << 24, 1 << 26, V).astype(np.int32)
    w = rng.integers(0, 3, E).astype(np.int32) if weighted else None
    got, want = staged_both(vals, src, dst, valid, V, combine="add",
                            weight=w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("mode", ["none", "weight", "unit"])
@pytest.mark.parametrize("batch", [None, 3])
def test_unfused_min_int_matches_reference_exactly(E, V, mode, batch):
    rng = np.random.default_rng(E * 3 + V)
    src, dst, valid = _coo(rng, E, V)
    shape = (V,) if batch is None else (V, batch)
    vals = rng.integers(0, 10_000, shape).astype(np.int32)
    vals[rng.integers(0, 2, shape).astype(bool)] = SENTINEL
    w = rng.integers(0, 9, E).astype(np.int32) if mode == "weight" else None
    got, want = staged_both(vals, src, dst, valid, V, combine="min",
                            weight=w, unit_weight=mode == "unit")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("mode", ["none", "weight", "unit"])
def test_unfused_min_float_matches_reference_exactly(E, V, mode):
    rng = np.random.default_rng(E + 7 * V)
    src, dst, valid = _coo(rng, E, V)
    vals = rng.uniform(0.0, 100.0, V).astype(np.float32)
    vals[rng.integers(0, 2, V).astype(bool)] = np.inf
    w = rng.uniform(-5.0, 5.0, E).astype(np.float32) if mode == "weight" \
        else None
    got, want = staged_both(vals, src, dst, valid, V, combine="min",
                            weight=w, unit_weight=mode == "unit")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combine,dtype", [("add", np.float32),
                                           ("add", np.int32),
                                           ("min", np.int32),
                                           ("min", np.float32)])
@pytest.mark.parametrize("batch", [None, 2])
def test_unfused_init_seed_matches_reference(combine, dtype, batch):
    rng = np.random.default_rng(9)
    E, V = 700, 300
    src, dst, valid = _coo(rng, E, V)
    shape = (V,) if batch is None else (V, batch)
    draw = lambda: (rng.normal(size=shape) if dtype == np.float32
                    else rng.integers(0, 1000, shape)).astype(dtype)
    vals, init = draw(), draw()
    if combine == "min" and dtype == np.float32:
        init[0] = np.inf
    got, want = staged_both(vals, src, dst, valid, V, combine=combine,
                            init=init)
    if combine == "add" and dtype == np.float32:
        assert_add_close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_unfused_saturation_and_all_invalid():
    for v0 in (SENTINEL - 1, SENTINEL):
        one = np.zeros(1, np.int32)
        for kw in ({"weight": np.array([5], np.int32)},
                   {"unit_weight": True}):
            got, want = staged_both(np.array([v0], np.int32), one, one,
                                    np.ones(1, np.int32), 1, combine="min",
                                    **kw)
            assert got.tolist() == want.tolist() == [SENTINEL]
    rng = np.random.default_rng(2)
    src, dst, _ = _coo(rng, 300, 64)
    zero = np.zeros(300, np.int32)
    fvals = rng.normal(size=64).astype(np.float32)
    for combine, vals in (("add", fvals), ("min", fvals),
                          ("min", rng.integers(0, 9, 64).astype(np.int32))):
        got, want = staged_both(vals, src, dst, zero, 64, combine=combine)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combine,dtype,mode", [
    ("add", torch.float32, "weight"), ("add", torch.int32, "none"),
    ("min", torch.int32, "unit"), ("min", torch.float32, "weight")])
def test_unfused_rows_equal_fused(combine, dtype, mode):
    """The staged pair over [C, E] chare rows equals the fused push (its
    plain version here) on the same operands."""
    rng = np.random.default_rng(4)
    C, E, V = 3, 600, 100
    t = torch.from_numpy
    src = t(rng.integers(0, V, (C, E)).astype(np.int32))
    dst = t(rng.integers(0, V, (C, E)).astype(np.int32))
    valid = t(rng.integers(0, 2, (C, E)).astype(np.int32))
    vals = t(rng.integers(0, 50, (C, V))).to(dtype)
    w = t(rng.integers(1, 4, (C, E))).to(dtype) if mode == "weight" else None
    kw = dict(combine=combine, weight=w, unit_weight=mode == "unit")
    got = ops.push(vals, src, dst, valid, V, fused=False, **kw)
    torch.testing.assert_close(got, ops.push(vals, src, dst, valid, V, **kw),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# segment_reduce / make_segment_fn
# ---------------------------------------------------------------------------


def test_segment_reduce_int_add_keeps_precision():
    data = torch.full((3,), (1 << 24) + 1, dtype=torch.int32)
    got = ops.segment_reduce(data, torch.zeros(3, dtype=torch.int32), 1,
                             combine="add")
    assert got.dtype == torch.int32
    assert int(got[0]) == 3 * ((1 << 24) + 1)
    want = rops.segment_reduce(jnp.asarray(data.numpy()),
                               jnp.zeros(3, jnp.int32), 1, combine="add")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,nseg", [(777, 123), (256, 256), (1000, 7)])
@pytest.mark.parametrize("combine,dtype", [("add", np.float32),
                                           ("add", np.int32),
                                           ("min", np.int32),
                                           ("min", np.float32)])
@pytest.mark.parametrize("batch", [None, 3])
def test_segment_reduce_matches_reference(n, nseg, combine, dtype, batch):
    rng = np.random.default_rng(n + nseg)
    seg = rng.integers(0, nseg, n).astype(np.int32)
    shape = (n,) if batch is None else (n, batch)
    if dtype == np.float32:
        data = rng.normal(size=shape).astype(np.float32)
        if combine == "min":
            data[rng.integers(0, 4, shape) == 0] = np.inf
    else:
        data = rng.integers(1 << 24, 1 << 26, shape).astype(np.int32)
    got = ops.segment_reduce(torch.from_numpy(data), torch.from_numpy(seg),
                             nseg, combine=combine).numpy()
    want = np.asarray(rops.segment_reduce(jnp.asarray(data),
                                          jnp.asarray(seg), nseg,
                                          combine=combine))
    assert got.dtype == want.dtype and got.shape == want.shape
    if combine == "add" and dtype == np.float32:
        assert_add_close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_segment_reduce_rows_equal_per_row_calls():
    rng = np.random.default_rng(8)
    data = torch.from_numpy(rng.normal(size=(4, 300, 2)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 50, (4, 300)).astype(np.int32))
    got = ops.segment_reduce(data, seg, 50, combine="min")
    assert tuple(got.shape) == (4, 50, 2)
    for r in range(4):
        torch.testing.assert_close(
            got[r], ops.segment_reduce(data[r], seg[r], 50, combine="min"),
            rtol=0, atol=0)
    with pytest.raises(ValueError, match="combine"):
        ops.segment_reduce(data, seg, 50, combine="max")


def test_make_segment_fn_combine_inference():
    """The combine keyword wins; a fixed constructor monoid is the default
    for calls without it; with neither, float -> add and int -> min."""
    seg = torch.tensor([0, 0, 1], dtype=torch.int32)
    f = torch.tensor([1.0, 2.0, 5.0])
    i = torch.tensor([4, 3, 9], dtype=torch.int32)
    infer = ops.make_segment_fn()
    assert infer(f, seg, 2).tolist() == [3.0, 5.0]
    assert infer(i, seg, 2).tolist() == [3, 9]
    assert infer(f, seg, 2, combine="min").tolist() == [1.0, 5.0]
    assert infer(i, seg, 2, combine="add").tolist() == [7, 9]
    fixed = ops.make_segment_fn(combine="min")
    assert fixed(f, seg, 2).tolist() == [1.0, 5.0]
    assert fixed(f, seg, 2, combine="add").tolist() == [3.0, 5.0]
    for fn_t, fn_r in ((infer, rops.make_segment_fn()),
                       (fixed, rops.make_segment_fn(combine="min"))):
        for x in (f, i):
            np.testing.assert_array_equal(
                fn_t(x, seg, 2).numpy(),
                np.asarray(fn_r(jnp.asarray(x.numpy()),
                                jnp.asarray(seg.numpy()), 2)))


# ---------------------------------------------------------------------------
# Engine hooks: the cells of tests/test_fused.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("strategy", ALL_STRATEGIES)
@pytest.mark.parametrize("name", sorted(TPROG.PROGRAMS))
def test_staged_hooks_equivalence(name, strategy, partitioner):
    """With the staged push hook and the scatter-kernel segment hook (the
    plain versions here) every cell matches the serial reference:
    bit-exact for min monoids, 1e-3 for add -- and equals the same engine
    with no hook at all."""
    spec = get_spec(name)
    g = to_port(program_graph(name, "rmat6"))
    params = source_params(spec)
    ref = serial_ref(name, "rmat6", tuple(sorted(params.items())))
    got, iters = run_parallel(g, name, num_pes=1, strategy=strategy,
                              partitioner=partitioner, device="cpu",
                              push_fn=ops.make_push_fn(fused=False),
                              segment_fn=ops.make_segment_fn(), **params)
    assert iters >= 1
    assert spec.matches(got, ref)
    plain, plain_iters = run_parallel(g, name, num_pes=2, strategy=strategy,
                                      partitioner=partitioner, device="cpu",
                                      push_fn=None, **params)
    assert plain_iters == iters
    if spec.exact:
        np.testing.assert_array_equal(got, plain)
    else:
        np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)


def test_staged_hook_bfs_ignores_edge_weights():
    from repro.core import graph as RG
    from repro.core import programs as RPROG

    rg = RG.random_weights(RG.rmat(6, 300, seed=2), seed=5)
    ref, _ = RPROG.bfs_serial(rg, source=3)
    for hook in (ops.make_push_fn(fused=False), ops.make_push_fn()):
        got, _ = run_parallel(to_port(rg), "bfs", num_pes=1, device="cpu",
                              push_fn=hook, source=3)
        np.testing.assert_array_equal(got, ref)


def test_staged_hook_falls_back_on_undeclared_transform():
    """A custom edge_value without an edge_semiring runs the staged path
    (gather, edge_value, mask, segment combine), hook or no hook, and the
    segment hook takes its combine."""
    from repro.core import graph as RG
    from repro_torch.core import strategies as TS

    prog = TPROG.VertexProgram(
        name="squared_weight", key=("squared_weight",), combiner=TS.ADD,
        init=lambda pg: np.ones((pg.num_chunks, pg.chunk_size), np.float32),
        update=lambda s, aux: s,
        edge_value=lambda v, w: v * w * w,  # not the canonical v * w
        apply=lambda s, inc, aux: inc,
        fixed_iters=1)
    rg = RG.random_weights(RG.rmat(5, 150, seed=4), seed=6)
    pg = TG.partition(to_port(rg), 1)
    base, _ = Engine(pg, device="cpu").run(prog)
    w2 = np.bincount(rg.dst, weights=rg.edge_weights.astype(np.float64) ** 2,
                     minlength=rg.num_vertices).astype(np.float32)
    for kw in ({"push_fn": ops.make_push_fn(fused=False)},
               {"push_fn": None, "segment_fn": ops.make_segment_fn()}):
        hooked, _ = Engine(pg, device="cpu", **kw).run(prog)
        np.testing.assert_allclose(hooked, base, rtol=1e-6)
        np.testing.assert_allclose(hooked, w2, rtol=1e-4)


def test_segment_hook_float_min_program():
    """The hook receives the monoid via the combine keyword: SSSP (float
    min) through the scatter kernel's plain version keeps +inf for
    unreachable vertices."""
    g = TG.from_edges(4, np.array([0, 1]), np.array([1, 2]),
                      weight=np.array([1.0, 2.0], np.float32))
    got, _ = run_parallel(g, "sssp", num_pes=1, device="cpu", push_fn=None,
                          segment_fn=ops.make_segment_fn(), source=0)
    np.testing.assert_array_equal(got, [0.0, 1.0, 3.0, np.inf])


def test_quickstart_twin_on_cpu():
    from repro_torch import quickstart

    checks = quickstart.main(["--device", "cpu", "--scale", "8"])
    assert set(checks) >= {"pagerank/basic", "pagerank/sortdest+segment_fn",
                           "labelprop", "sssp", "bfs"}
    assert all(checks.values()), checks
