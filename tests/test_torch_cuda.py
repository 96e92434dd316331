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
from repro_torch.kernels import _build, ops, push_fused
from repro_torch.kernels.blocks import BLOCK_E

pytestmark = pytest.mark.gpu

PROGRAMS = ("bfs", "labelprop", "pagerank", "pagerank_weighted", "sssp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


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


def test_library_builds_into_ignored_dir(cuda):
    path = _build.build("push_fused")
    assert path.exists()
    assert path.is_relative_to(_build.BUILD_ROOT)


@pytest.mark.parametrize("chares", (1, 8))
@pytest.mark.parametrize("strategy", ("sortdest", "reduction", "pairs"))
@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_on_cuda_matches_cpu(cuda, name, strategy, chares):
    """The engine on the card (CUDA kernels installed whatever the dispatch
    picks) agrees with the same engine on the CPU, and launches its kernel
    once per superstep."""
    spec = get_spec(name)
    g = G.rmat(11, 14 << 11, seed=1)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    pg = G.partition(spec.prepare_graph(g), chares)
    dev_eng = Engine(pg, strategy=strategy)
    cpu_eng = Engine(pg, strategy=strategy, device="cpu")
    push_fused.reset_launch_counts()
    got, iters = dev_eng.run(name)
    launched = sum(push_fused.launch_counts.values())
    want, want_iters = cpu_eng.run(name)
    assert iters == want_iters
    if spec.exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert dev_eng.dispatch["kernel"] == "cuda"
    assert launched == iters


@pytest.mark.parametrize("name", PROGRAMS)
def test_engine_on_cuda_launches_for_a_staged_choice(cuda, name):
    """A near-uniform graph makes the dispatch choose "staged"; the engine
    on the card still runs the CUDA kernels (the band table only lets them
    skip empty blocks), never the plain torch pipeline."""
    spec = get_spec(name)
    g = G.erdos_renyi(512, 20000, seed=3)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    pg = G.partition(spec.prepare_graph(g), 1)
    dev_eng = Engine(pg)
    assert dev_eng.dispatch["choice"] == "staged"
    push_fused.reset_launch_counts()
    got, iters = dev_eng.run(name)
    assert sum(push_fused.launch_counts.values()) == iters
    want, want_iters = Engine(pg, device="cpu").run(name)
    assert iters == want_iters
    if spec.exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_staged_pipeline_on_cuda_raises(cuda):
    """push_fn=None asks for the staged pipeline, whose kernels are not
    ported: on the card it raises instead of running plain torch."""
    pg = G.partition(G.rmat(8, 2000, seed=1), 2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(pg, push_fn=None).run("bfs")
