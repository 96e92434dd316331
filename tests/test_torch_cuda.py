"""The port's CUDA kernels and engine on the card, against their plain
versions.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the reference package, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Min and int32 add results must be bit-equal to the plain torch version;
float add within rtol=1e-5, atol=1e-6*max|out| (float atomics add in no
fixed order).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Engine, get_spec
from repro_torch.core import graph as G
from repro_torch.kernels import _build, ops, push_fused, push_staged
from repro_torch.kernels.blocks import BLOCK_E

pytestmark = pytest.mark.gpu

PROGRAMS = ("bfs", "labelprop", "pagerank", "pagerank_weighted", "sssp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def staged_launches(combine, iters):
    """The launch counts of a staged superstep loop: one gather and one
    scatter of the monoid per superstep, nothing else."""
    name = "sum" if combine == "add" else "min"
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want[f"gather_{name}"] = want[f"scatter_{name}"] = iters
    return want


def assert_kernel_equal(got, want, combine):
    if combine == "add" and got.dtype.is_floating_point:
        scale = float(want.abs().max()) if want.numel() else 0.0
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * scale)
    else:
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("combine,dtype,mode", [
    ("add", torch.float32, "none"), ("add", torch.float32, "weight"),
    ("add", torch.int32, "none"), ("add", torch.int32, "weight"),
    ("min", torch.int32, "none"), ("min", torch.int32, "weight"),
    ("min", torch.int32, "unit"), ("min", torch.float32, "none"),
    ("min", torch.float32, "weight"), ("min", torch.float32, "unit")])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("seeded", [False, True])
def test_kernel_matches_plain(cuda, combine, dtype, mode, batch, seeded):
    rng = np.random.default_rng(7)
    C, E, V, S = 3, 8 * BLOCK_E, 700, 512
    tail = () if batch is None else (batch,)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    src = t(rng.integers(0, V, (C, E)).astype(np.int32))
    dst = t(rng.integers(0, S, (C, E)).astype(np.int32))
    valid = t(rng.integers(0, 2, (C, E)).astype(np.int32))
    valid[:, 2 * BLOCK_E:4 * BLOCK_E] = 0  # two empty blocks per row
    band = ops._bands_on_device(src, dst, valid, E // BLOCK_E)
    if dtype == torch.float32:
        vals = t(rng.normal(size=(C, V) + tail).astype(np.float32))
        w = t(rng.uniform(-2.0, 4.0, (C, E)).astype(np.float32))
    else:
        vals = t(rng.integers(0, 1 << 26, (C, V) + tail).astype(np.int32))
        w = t(rng.integers(0, 5, (C, E)).astype(np.int32))
    w = w if mode == "weight" else None
    kw = dict(combine=combine, unit_weight=mode == "unit")
    init = (push_fused.fused_push_plain(band, src, dst, valid, None, vals, S,
                                        combine=combine) if seeded else None)
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S, init=init,
                                **kw)
    assert push_fused.launch_counts[f"fused_push_{combine}"] == 1
    want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                       init=init, **kw)
    assert_kernel_equal(got, want, combine)
    # the one-row (1-D) form of the same call
    row = push_fused.fused_push(band[2], src[2], dst[2], valid[2],
                                None if w is None else w[2], vals[2], S,
                                init=None if init is None else init[2], **kw)
    assert_kernel_equal(row, want[2], combine)


def test_ops_push_sentinel_round_trip(cuda):
    rng = np.random.default_rng(3)
    E, V = 1000, 300
    src = rng.integers(0, V, E).astype(np.int32)
    dst = rng.integers(0, V, E).astype(np.int32)
    valid = rng.integers(0, 2, E).astype(np.int32)
    vals = rng.uniform(0, 100, V).astype(np.float32)
    vals[rng.integers(0, 2, V).astype(bool)] = np.inf
    w = rng.uniform(0, 5, E).astype(np.float32)
    args = [torch.from_numpy(a) for a in (vals, src, dst, valid)]
    want = ops.push(*args, V, combine="min", weight=torch.from_numpy(w))
    got = ops.push(*(a.to(cuda) for a in args), V, combine="min",
                   weight=torch.from_numpy(w).to(cuda))
    assert torch.equal(got.cpu(), want)
    assert bool(torch.isinf(got).any())


def test_kernel_rejects_unsupported_operands(cuda):
    z = torch.zeros(256, dtype=torch.int32, device=cuda)
    band = torch.zeros((4, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        push_fused.fused_push(band, z, z, z, None,
                              torch.zeros(4, dtype=torch.float64,
                                          device=cuda), 4)
    with pytest.raises(ValueError):
        push_fused.fused_push(band, z.cpu(), z, z, None,
                              torch.zeros(4, device=cuda), 4)


@pytest.mark.parametrize("source", ("push_fused", "push_staged"))
def test_library_builds_into_ignored_dir(cuda, source):
    path = _build.build(source)
    assert path.exists()
    assert path.is_relative_to(_build.BUILD_ROOT)


STAGED_CASES = [  # (kernel, value dtype)
    ("gather_sum", torch.float32), ("gather_sum", torch.int32),
    ("gather_sum", torch.bfloat16), ("gather_min", torch.int32),
    ("gather_min", torch.float32), ("scatter_sum", torch.float32),
    ("scatter_sum", torch.int32), ("scatter_min", torch.int32),
    ("scatter_min", torch.float32)]


@pytest.mark.parametrize("kernel,dtype", STAGED_CASES)
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("rowed", [False, True])
def test_staged_kernel_matches_plain(cuda, kernel, dtype, batch, rowed):
    """Each staged kernel against its plain version on the card: gathers and
    min/int scatters bit-equal, float sums within the stated tolerance.
    Sources and destinations include out-of-range ids (identity / dropped),
    float min values include negatives and the sentinel range."""
    rng = np.random.default_rng(11)
    C, E, V, S = 3, 3000, 700, 512
    lead = (C,) if rowed else ()
    tail = () if batch is None else (batch,)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    edges = t(rng.integers(-5, V + 5, lead + (E,)).astype(np.int32))
    valid = t(rng.integers(0, 2, lead + (E,)).astype(np.int32))
    n = (V if kernel.startswith("gather") else E)
    if dtype == torch.int32:
        # past float32's 2^24 integer range: int sums stay exact
        x = t(rng.integers(1 << 24, 1 << 26, lead + (n,) + tail)
              .astype(np.int32))
    else:
        x = rng.normal(size=lead + (n,) + tail).astype(np.float32) * 100
        if kernel.endswith("min"):
            x.reshape(-1)[::7] = 3e9  # above float(SENTINEL): unreached
        x = t(x).to(dtype)
    fn = getattr(push_staged, kernel)
    plain = getattr(push_staged, kernel + "_plain")
    push_fused.reset_launch_counts()
    if kernel.startswith("gather"):
        got, want = fn(edges, valid, x), plain(edges, valid, x)
    else:
        got, want = fn(edges, x, S), plain(edges, x, S)
    assert push_fused.launch_counts[kernel] == 1
    assert sum(push_fused.launch_counts.values()) == 1
    assert_kernel_equal(got, want, "add" if kernel == "scatter_sum"
                        else "min")


def test_staged_kernels_all_invalid_and_saturation(cuda):
    """All-invalid edges give the identity; the min-plus transform of the
    unfused push saturates at the sentinel headroom, never wraps."""
    S = push_fused.SENTINEL
    z = torch.zeros(300, dtype=torch.int32, device=cuda)
    vals = torch.arange(300, dtype=torch.int32, device=cuda)
    assert bool((push_staged.gather_min(z, z, vals) == S).all())
    assert bool((push_staged.gather_sum(z, z, vals.float()) == 0).all())
    sat = torch.tensor([S - 1, S, S - 3, 7], dtype=torch.int32, device=cuda)
    idx = torch.arange(4, dtype=torch.int32, device=cuda)
    one = torch.ones(4, dtype=torch.int32, device=cuda)
    out = ops.push(sat, idx, idx, one, 4, combine="min", weight=one * 5,
                   fused=False)
    assert out.tolist() == [S, S, S, 12]


@pytest.mark.parametrize("combine,dtype,mode", [
    ("add", torch.float32, "none"), ("add", torch.float32, "weight"),
    ("add", torch.int32, "weight"), ("min", torch.int32, "unit"),
    ("min", torch.int32, "weight"), ("min", torch.float32, "weight")])
@pytest.mark.parametrize("batch", [None, 4])
def test_unfused_push_matches_fused(cuda, combine, dtype, mode, batch):
    """``ops.push(fused=False)`` (the staged pair) equals ``ops.push()``
    (the fused kernel) on the same operands, chare rows included."""
    rng = np.random.default_rng(5)
    C, E, V = 3, 5000, 900
    tail = () if batch is None else (batch,)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    src = t(rng.integers(0, V, (C, E)).astype(np.int32))
    dst = t(rng.integers(0, V, (C, E)).astype(np.int32))
    valid = t(rng.integers(0, 2, (C, E)).astype(np.int32))
    if dtype == torch.float32:
        vals = rng.uniform(0, 100, (C, V) + tail).astype(np.float32)
        if combine == "min":
            vals[rng.integers(0, 2, vals.shape).astype(bool)] = np.inf
        vals, w = t(vals), t(rng.uniform(0.5, 4, (C, E)).astype(np.float32))
    else:
        vals = t(rng.integers(0, 1 << 26, (C, V) + tail).astype(np.int32))
        w = t(rng.integers(0, 5, (C, E)).astype(np.int32))
    kw = dict(combine=combine, weight=w if mode == "weight" else None,
              unit_weight=mode == "unit")
    push_fused.reset_launch_counts()
    got = ops.push(vals, src, dst, valid, V, fused=False, **kw)
    name = "sum" if combine == "add" else "min"
    assert push_fused.launch_counts[f"gather_{name}"] == 1
    assert push_fused.launch_counts[f"scatter_{name}"] == 1
    assert push_fused.launch_counts[f"fused_push_{combine}"] == 0
    assert_kernel_equal(got, ops.push(vals, src, dst, valid, V, **kw),
                        combine)


def run_both(name, pg, **kw):
    """(card result, card iters, CPU result, CPU iters, card launches) of
    one program on the same partition."""
    push_fused.reset_launch_counts()
    got, iters = Engine(pg, **kw).run(name)
    launched = dict(push_fused.launch_counts)
    want, want_iters = Engine(pg, device="cpu", **kw).run(name)
    assert iters == want_iters
    if get_spec(name).exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    return iters, launched


def prepared(name, g, chares):
    spec = get_spec(name)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    return G.partition(spec.prepare_graph(g), chares)


@pytest.mark.parametrize("chares", (1, 8))
@pytest.mark.parametrize("strategy", ("sortdest", "reduction", "pairs"))
@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_on_cuda_matches_cpu(cuda, name, strategy, chares):
    """The engine on the card agrees with the same engine on the CPU, and
    launches the kernels its dispatch chose once per superstep."""
    pg = prepared(name, G.rmat(11, 14 << 11, seed=1), chares)
    eng = Engine(pg, strategy=strategy)
    iters, launched = run_both(name, pg, strategy=strategy)
    assert eng.dispatch["kernel"] == "cuda"
    combine = get_spec(name).make().combiner.name
    if eng.dispatch["choice"] == "fused":
        assert launched[f"fused_push_{combine}"] == iters
        assert sum(launched.values()) == iters
    else:
        assert launched == staged_launches(combine, iters)


@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_on_cuda_launches_for_a_staged_choice(cuda, name):
    """A near-uniform graph makes the dispatch choose "staged"; the engine
    on the card then runs the staged gather and scatter kernels, one each
    per superstep, and no fused kernel."""
    pg = prepared(name, G.erdos_renyi(512, 20000, seed=3), 1)
    assert Engine(pg).dispatch["choice"] == "staged"
    iters, launched = run_both(name, pg)
    combine = get_spec(name).make().combiner.name
    assert launched == staged_launches(combine, iters)


@pytest.mark.parametrize("chares", (1, 8))
@pytest.mark.parametrize("how", ("basic", "push_fn=None", "segment_fn"))
@pytest.mark.parametrize("name", PROGRAMS)
def test_staged_engines_on_cuda_match_cpu(cuda, name, how, chares):
    """``basic``, ``push_fn=None`` and ``segment_fn`` engines on the card
    agree with the same engines on the CPU, launching one gather and one
    scatter kernel per superstep."""
    from repro_torch.kernels.ops import make_segment_fn

    kw = {"basic": dict(strategy="basic"),
          "push_fn=None": dict(push_fn=None),
          "segment_fn": dict(push_fn=None,
                             segment_fn=make_segment_fn())}[how]
    pg = prepared(name, G.rmat(10, 14 << 10, seed=2), chares)
    iters, launched = run_both(name, pg, **kw)
    combine = get_spec(name).make().combiner.name
    assert launched == staged_launches(combine, iters)
