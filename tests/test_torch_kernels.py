"""Push kernels of the torch port against the JAX reference.

On the CPU the port's ``ops.push`` runs the plain torch version of its CUDA
kernels; the reference's ``ops.push`` runs its Pallas kernels in interpret
mode, as its own tests do.  Both get the same numpy-seeded inputs over the
``test_fused.py`` matrix (add/min x int/float x weighted/unit x [B] plane x
init seed, all-invalid rows, empty edge blocks, the saturation boundary):
min and int add must be bit-equal, float add within rtol=1e-6 and
atol=1e-6*max|out| -- both sides run on the CPU and differ only in the order
they sum in.

The CUDA kernels themselves are held against the plain version on the card
by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.blocks import BLOCK_E, BLOCK_S, BLOCK_V
from repro_torch.kernels import ops, push_fused, ref
from repro_torch.kernels.blocks import edge_bands

SENTINEL = push_fused.SENTINEL
SHAPES = [(1, 1), (7, 5), (257, 300), (700, 123), (2048, 640)]


@pytest.fixture
def rng():
    """A fresh generator per test (not conftest's shared one), so
    these tests neither see nor shift other modules' random streams."""
    return np.random.default_rng(0)


def _coo(rng, E, V, sorted_by_block=False):
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    valid = rng.integers(0, 2, E).astype(np.int32)
    if sorted_by_block:  # the layouts' (seg block, src block) bucket order
        order = np.argsort((dst // BLOCK_S) * (V // BLOCK_V + 1)
                           + src // BLOCK_V, kind="stable")
        src, dst, valid = src[order], dst[order], valid[order]
    return src, dst, valid


def both(vals, src, dst, valid, V, **kw):
    """(port, reference) results of ops.push on the same numpy inputs."""
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
    j = lambda a: None if a is None else jnp.asarray(a)
    tkw = {k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jkw = {k: j(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    got = ops.push(t(vals), t(src), t(dst), t(valid), V, **tkw)
    want = rops.push(j(vals), j(src), j(dst), j(valid), V, **jkw)
    return got.numpy(), np.asarray(want)


def assert_add_close(got, want):
    assert got.dtype == want.dtype
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# ops.push (plain version on CPU) vs the reference's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_add_float_matches_reference(E, V, weighted, batch, rng):
    src, dst, valid = _coo(rng, E, V, sorted_by_block=True)
    shape = (V,) if batch is None else (V, batch)
    vals = rng.normal(size=shape).astype(np.float32)
    w = rng.uniform(1.0, 4.0, E).astype(np.float32) if weighted else None
    got, want = both(vals, src, dst, valid, V, combine="add", weight=w)
    assert got.shape == shape
    assert_add_close(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("weighted", [False, True])
def test_add_int_matches_reference_exactly(E, V, weighted, rng):
    src, dst, valid = _coo(rng, E, V)
    # past float32's 2^24 integer range: ints must accumulate as ints
    vals = rng.integers(1 << 24, 1 << 26, V).astype(np.int32)
    w = rng.integers(0, 3, E).astype(np.int32) if weighted else None
    got, want = both(vals, src, dst, valid, V, combine="add", weight=w)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("mode", ["none", "weight", "unit"])
@pytest.mark.parametrize("batch", [None, 3])
def test_min_int_matches_reference_exactly(E, V, mode, batch, rng):
    src, dst, valid = _coo(rng, E, V, sorted_by_block=True)
    shape = (V,) if batch is None else (V, batch)
    vals = rng.integers(0, 10_000, shape).astype(np.int32)
    vals[rng.integers(0, 2, shape).astype(bool)] = SENTINEL  # unreached
    w = rng.integers(0, 9, E).astype(np.int32) if mode == "weight" else None
    got, want = both(vals, src, dst, valid, V, combine="min", weight=w,
                     unit_weight=mode == "unit")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("E,V", SHAPES)
@pytest.mark.parametrize("mode", ["none", "weight", "unit"])
def test_min_float_matches_reference_exactly(E, V, mode, rng):
    """FMIN (SSSP distances): +inf round-trips the sentinel encoding."""
    src, dst, valid = _coo(rng, E, V)
    vals = rng.uniform(0.0, 100.0, V).astype(np.float32)
    vals[rng.integers(0, 2, V).astype(bool)] = np.inf
    w = rng.uniform(0.0, 5.0, E).astype(np.float32) if mode == "weight" \
        else None
    got, want = both(vals, src, dst, valid, V, combine="min", weight=w,
                     unit_weight=mode == "unit")
    np.testing.assert_array_equal(got, want)


def test_min_float_negative_weights_match_reference(rng):
    src, dst, valid = _coo(rng, 900, 300)
    vals = rng.normal(size=300).astype(np.float32)
    w = rng.uniform(-5.0, 5.0, 900).astype(np.float32)
    got, want = both(vals, src, dst, valid, 300, combine="min", weight=w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("reached", ["none", "half"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("seeded", [False, True])
def test_min_unreached_sources_over_negative_weights(dtype, reached, batch,
                                                     seeded, rng):
    """An unreached source (int SENTINEL, float +inf) over a negative weight
    sends a real value: SENTINEL + w for ints, and for floats 2^31 + w,
    which rounds below 2^31 once |w| >= 256 (float32's spacing is 128 just
    below 2^31).  A min that skipped contributions because the gathered
    value is the identity would lose them."""
    E, V = 900, 300
    src, dst, valid = _coo(rng, E, V, sorted_by_block=True)
    shape = (V,) if batch is None else (V, batch)
    if dtype == np.int32:
        vals = rng.integers(0, 10_000, shape).astype(np.int32)
        w = rng.integers(-3000, 9, E).astype(np.int32)
        unreached = SENTINEL
    else:
        vals = rng.uniform(0.0, 100.0, shape).astype(np.float32)
        w = rng.uniform(-2000.0, 5.0, E).astype(np.float32)
        unreached = np.inf
    if reached == "none":
        vals[:] = unreached
    else:
        vals[rng.integers(0, 2, shape).astype(bool)] = unreached
    init = None
    if seeded:
        init = (rng.integers(0, 10_000, shape) if dtype == np.int32
                else rng.uniform(0.0, 100.0, shape)).astype(dtype)
        init[rng.integers(0, 2, shape).astype(bool)] = unreached
    got, want = both(vals, src, dst, valid, V, combine="min", weight=w,
                     init=init)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, want)
    if reached == "none":  # so whatever lowered out came from one
        base = np.full(shape, unreached, dtype) if init is None else init
        assert bool((got < base).any())


@pytest.mark.parametrize("combine,dtype", [("add", np.float32),
                                           ("add", np.int32),
                                           ("min", np.int32),
                                           ("min", np.float32)])
@pytest.mark.parametrize("batch", [None, 2])
def test_init_seed_matches_reference(combine, dtype, batch, rng):
    E, V = 700, 300
    src, dst, valid = _coo(rng, E, V)
    shape = (V,) if batch is None else (V, batch)
    vals = (rng.normal(size=shape) if dtype == np.float32
            else rng.integers(0, 1000, shape)).astype(dtype)
    init = (rng.normal(size=shape) if dtype == np.float32
            else rng.integers(0, 1000, shape)).astype(dtype)
    if combine == "min" and dtype == np.float32:
        init[0] = np.inf
    got, want = both(vals, src, dst, valid, V, combine=combine, init=init)
    if combine == "add" and dtype == np.float32:
        assert_add_close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_saturates_at_headroom_boundary():
    """A near-sentinel value + weight clamps to the sentinel, never wraps."""
    for v0 in (SENTINEL - 1, SENTINEL):
        one = np.zeros(1, np.int32)
        for kw in ({"weight": np.array([5], np.int32)}, {"unit_weight": True}):
            got, want = both(np.array([v0], np.int32), one, one,
                             np.ones(1, np.int32), 1, combine="min", **kw)
            assert got.tolist() == want.tolist() == [SENTINEL]


def test_all_invalid_gives_identity(rng):
    E, V = 300, 64
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    valid = np.zeros(E, np.int32)
    fvals = rng.normal(size=V).astype(np.float32)
    got, want = both(fvals, src, dst, valid, V, combine="add")
    assert np.all(got == 0.0) and np.array_equal(got, want)
    got, want = both(rng.integers(0, 9, V).astype(np.int32), src, dst, valid,
                     V, combine="min")
    assert np.all(got == SENTINEL) and np.array_equal(got, want)
    got, want = both(fvals, src, dst, valid, V, combine="min")
    assert np.all(np.isinf(got)) and np.array_equal(got, want)


def test_empty_edge_blocks_contribute_nothing(rng):
    E, V = 200, 300
    src, dst, valid = _coo(rng, E, V)
    vals = rng.normal(size=V).astype(np.float32)
    pad = 3 * BLOCK_E
    z = np.zeros(pad, np.int32)
    padded = [np.concatenate([a, z]) for a in (src, dst, valid)]
    base, _ = both(vals, src, dst, valid, V, combine="add")
    got, want = both(vals, *padded, V, combine="add")
    np.testing.assert_array_equal(got, base)
    assert_add_close(got, want)


def test_push_ref_matches_reference(rng):
    src, dst, valid = _coo(rng, 500, 200)
    for combine, vals, w in (
            ("add", rng.normal(size=200).astype(np.float32),
             rng.uniform(1, 2, 500).astype(np.float32)),
            ("min", rng.integers(0, 99, 200).astype(np.int32),
             rng.integers(0, 5, 500).astype(np.int32)),
            ("min", rng.uniform(0, 9, 200).astype(np.float32), None)):
        t = [torch.from_numpy(a) for a in (vals, src, dst, valid)]
        got = ref.push_ref(*t, 200, combine=combine,
                           weight=None if w is None else torch.from_numpy(w))
        want = rref.push_ref(*(jnp.asarray(a) for a in (vals, src, dst,
                                                         valid)), 200,
                             combine=combine,
                             weight=None if w is None else jnp.asarray(w))
        if combine == "add":
            assert_add_close(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The port's own contract: chare rows, bands, plain version, counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("combine,dtype,mode", [
    ("add", torch.float32, "none"), ("add", torch.float32, "weight"),
    ("add", torch.int32, "none"), ("min", torch.int32, "unit"),
    ("min", torch.float32, "weight")])
def test_rows_equal_per_row_calls(combine, dtype, mode, rng):
    """One call over [C, E] chare rows equals C one-row calls."""
    C, E, V, S = 3, 600, 100, 300
    src = torch.from_numpy(rng.integers(0, V, (C, E)).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, S, (C, E)).astype(np.int32))
    valid = torch.from_numpy(rng.integers(0, 2, (C, E)).astype(np.int32))
    vals = torch.from_numpy(rng.integers(0, 50, (C, V))).to(dtype)
    w = (torch.from_numpy(rng.integers(1, 4, (C, E))).to(dtype)
         if mode == "weight" else None)
    kw = dict(combine=combine, unit_weight=mode == "unit")
    got = ops.push(vals, src, dst, valid, S, weight=w, **kw)
    assert tuple(got.shape) == (C, S)
    for r in range(C):
        row = ops.push(vals[r], src[r], dst[r], valid[r], S,
                       weight=None if w is None else w[r], **kw)
        torch.testing.assert_close(got[r], row, rtol=0, atol=0)


def test_bands_on_device_equal_edge_bands(rng):
    C, E = 3, 5 * BLOCK_E
    src = rng.integers(0, 2000, (C, E)).astype(np.int32)
    dst = rng.integers(0, 3000, (C, E)).astype(np.int32)
    valid = rng.integers(0, 2, (C, E)).astype(np.int32)
    valid[1, BLOCK_E:3 * BLOCK_E] = 0  # empty blocks -> (0, -1, 0, -1)
    got = ops._bands_on_device(*(torch.from_numpy(a) for a in
                                 (src, dst, valid)), 5)
    np.testing.assert_array_equal(got.numpy(), edge_bands(src, dst, valid))
    one = ops._bands_on_device(*(torch.from_numpy(a[0]) for a in
                                 (src, dst, valid)), 5)
    np.testing.assert_array_equal(one.numpy(), edge_bands(
        src[:1], dst[:1], valid[:1])[0])


def test_plain_version_ignores_band(rng):
    """The band table only lets the kernel skip empty blocks; the plain
    version never reads it."""
    src, dst, valid = (torch.from_numpy(a) for a in _coo(rng, 512, 256))
    vals = torch.from_numpy(rng.normal(size=256).astype(np.float32))
    band = ops._bands_on_device(src, dst, valid, 2)
    a = push_fused.fused_push_plain(band, src, dst, valid, None, vals, 256)
    b = push_fused.fused_push_plain(torch.zeros_like(band), src, dst, valid,
                                    None, vals, 256)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fused_push_checks_operands(rng):
    src = torch.zeros(256, dtype=torch.int32)
    vals = torch.zeros(4)
    band = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unit_weight"):
        push_fused.fused_push(band, src, src, src, vals, vals, 4,
                              unit_weight=True)
    with pytest.raises(ValueError, match="BLOCK_E"):
        push_fused.fused_push(band, src[:7], src[:7], src[:7], None, vals, 4)
    with pytest.raises(ValueError, match="init"):
        push_fused.fused_push(band, src, src, src, None, vals, 4,
                              init=torch.zeros(5))
    with pytest.raises(ValueError, match="combine"):
        push_fused.fused_push(band, src, src, src, None, vals, 4,
                              combine="max")


def test_output_dtypes():
    od = push_fused.output_dtype
    assert od(torch.bfloat16, "add") == torch.float32
    assert od(torch.float64, "add") == torch.float64
    assert od(torch.int32, "add") == torch.int32
    assert od(torch.float32, "min") == torch.float32
    assert od(torch.int32, "min") == torch.int32


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("seeded", [False, True])
def test_min_skip_bound_is_an_order_key(dtype, seeded):
    """The min kernels skip contributions at or above ``_min_cap``, an order
    key (a float's bit pattern as an int): the int sentinel for ints, which
    no int exceeds; float(SENTINEL)'s key where a float out starts at the
    identity; above +inf's key where a float init may hold more."""
    init = torch.zeros(3, dtype=dtype) if seeded else None
    cap = push_fused._min_cap(dtype, init)
    key = lambda x: int(np.array(x, np.float32).view(np.int32))
    if dtype == torch.int32:
        assert cap == SENTINEL
    elif seeded:
        assert cap > key(np.inf)
    else:
        assert cap == key(push_fused.SENTINEL_F32) == key(2.0 ** 31)


def test_cpu_calls_do_not_count_as_launches(rng):
    push_fused.reset_launch_counts()
    src, dst, valid = (torch.from_numpy(a) for a in _coo(rng, 300, 50))
    ops.push(torch.ones(50), src, dst, valid, 50)
    ops.push(torch.ones(50, dtype=torch.int32), src, dst, valid, 50,
             combine="min")
    ops.push(torch.ones(50), src, dst, valid, 50, fused=False)
    ops.segment_reduce(torch.ones(300), dst, 50)
    assert push_fused.launch_counts == dict.fromkeys(
        ("fused_push_add", "fused_push_min", "fused_push_add_tiled",
         "fused_push_add_merge", "fused_push_add_atomic",
         "fused_push_min_tiled", "fused_push_min_atomic", "gather_sum",
         "scatter_sum", "gather_min", "scatter_min"), 0)
