"""The port's CUDA kernels and engine on the card, against their plain
versions.

Every test here needs a CUDA device and skips without one.  The module
imports neither JAX nor the reference package, so it also runs where only
the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Min and int32 add results must be bit-equal to the plain torch version;
float add within rtol=1e-5, atol=1e-6*max|out| (the plain version and the
kernels sum in other orders; the atomic paths in no fixed order at all).
The tiled fused add sums in an order fixed by the data: its results must
be bit-identical from call to call, and column b of a ``[B]`` plane
bit-identical to a one-column call on that column.  The min paths (tiled
and atomic fused min, both scatter_min paths) are exact in any order and
skip contributions that cannot lower out: every result bit-equal to the
plain version, unreached sources over negative weights included.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import Engine, StreamConfig, get_spec
from repro_torch.core import graph as G
from repro_torch.kernels import _build, ops, push_fused, push_staged
from repro_torch.kernels.blocks import BLOCK_E, BLOCK_S

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


def fused_launches(arrays, layout, combine, iters):
    """The launch counts of a fused superstep loop over one layout: the
    fused kernel of the monoid once per superstep and the path the band
    table's rows take (tiled -- for add with its merge pass -- atomic, or
    both)."""
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want[f"fused_push_{combine}"] = iters
    band = arrays[{"sd": "sd_band", "grid": "gr_band"}.get(layout, "band")]
    plan = push_fused.tile_plan(band)
    tiled = plan.num_tiled if combine == "add" or plan.min_tiled else 0
    if tiled:
        want[f"fused_push_{combine}_tiled"] = iters
        if combine == "add" and plan.merge_tiles.numel():
            want["fused_push_add_merge"] = iters
    if tiled < band.shape[0]:
        want[f"fused_push_{combine}_atomic"] = iters
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
        layout = "basic" if strategy == "reduction" else "sd"
        assert launched == fused_launches(eng.arrays, layout, combine, iters)
        if layout == "sd":
            assert launched[f"fused_push_{combine}_tiled"] == iters
            assert launched[f"fused_push_{combine}_atomic"] == 0
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


# ---------------------------------------------------------------------------
# The fixed-order tiled fused add and the tiled scatter_sum
# ---------------------------------------------------------------------------


def sd_layout(cuda, chares=1, scale=13, layout="sd"):
    """A weighted RMAT partition's layout on the card, as the engine holds
    it: (src, dst, valid, weight, band, V, S)."""
    pg = G.partition(G.random_weights(G.rmat(scale, 14 << scale, seed=1),
                                      seed=5), chares)
    a = pg.device_arrays(layout, cuda)
    p = "sd_" if layout == "sd" else ""
    return (a[p + "src_local"], a[p + "dst_global"], a[p + "edge_valid"],
            a[p + "edge_weight"], a[p + "band"], pg.chunk_size,
            pg.num_chunks * pg.chunk_size)


def draw_vals(shape, dtype, cuda, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        x = rng.uniform(0, 1, shape).astype(np.float32)
    else:  # past float32's 2^24 integer range, and sums that wrap
        x = rng.integers(1 << 24, 1 << 30, shape).astype(np.int32)
    return torch.from_numpy(x).to(cuda)


def same_bits(a, b):
    """Bit-identical, -0.0 and +0.0 told apart."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def tiled_counts(calls=1):
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want.update(fused_push_add=calls, fused_push_add_tiled=calls,
                fused_push_add_merge=calls)
    return want


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("chares", [1, 3])
def test_tiled_add_matches_plain(cuda, dtype, weighted, batch, chares):
    """On the sd layout the add takes the tiled kernels (tile pass + merge
    pass, no atomic launch) and agrees with the plain version: ints exactly
    (wrapping), floats within rtol=1e-5, atol=1e-6*max|out|; with and
    without an init seed."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares)
    tail = () if batch is None else (batch,)
    vals = draw_vals((chares, V) + tail, dtype, cuda)
    w = (w if dtype == torch.float32 else (w * 3).to(torch.int32)) \
        if weighted else None
    for init in (None, draw_vals((chares, S) + tail, dtype, cuda, seed=1)):
        push_fused.reset_launch_counts()
        got = push_fused.fused_push(band, src, dst, valid, w, vals, S,
                                    init=init)
        assert push_fused.launch_counts == tiled_counts()
        want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                           init=init)
        assert_kernel_equal(got, want, "add")


@pytest.mark.parametrize("weighted", [False, True])
def test_tiled_add_is_bit_reproducible(cuda, weighted):
    """Two calls on the same operands give the same bits, and so does the
    one-row (1-D) form."""
    src, dst, valid, w, band, V, S = sd_layout(cuda)
    vals = draw_vals((1, V), torch.float32, cuda)
    w = w if weighted else None
    a = push_fused.fused_push(band, src, dst, valid, w, vals, S)
    b = push_fused.fused_push(band, src, dst, valid, w, vals, S)
    assert same_bits(a, b)
    row = push_fused.fused_push(band[0], src[0], dst[0], valid[0],
                                None if w is None else w[0], vals[0], S)
    assert same_bits(row, a[0])
    # edge planes off the kernel's 16-byte boundary are copied onto it
    off = lambda t: torch.cat([t[0, :1], t[0]])[1:]
    assert off(src).data_ptr() % 16
    moved = push_fused.fused_push(band[0], off(src), off(dst), off(valid),
                                  None if w is None else off(w), vals[0], S)
    assert same_bits(moved, a[0])


@pytest.mark.parametrize("batch", [2, 4, 16])
def test_tiled_add_columns_equal_one_column_calls(cuda, batch):
    """Column b of a [B] call has the bits of a [V] call on vals[..., b]:
    the order of the additions does not depend on B (B=16 runs two column
    groups of eight)."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2)
    vals = draw_vals((2, V, batch), torch.float32, cuda)
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S)
    for b in range(batch):
        one = push_fused.fused_push(band, src, dst, valid, w,
                                    vals[..., b].contiguous(), S)
        assert same_bits(got[..., b].contiguous(), one), b


def raw_sorted_layout(cuda, dst, V=700, seed=0):
    """One row of edges with the given (seg-sorted) destinations, padded to
    whole edge blocks, random sources, a quarter invalid."""
    rng = np.random.default_rng(seed)
    E = -(-len(dst) // BLOCK_E) * BLOCK_E
    d = np.zeros(E, np.int32)
    d[:len(dst)] = dst
    valid = np.zeros(E, np.int32)
    valid[:len(dst)] = rng.integers(0, 4, len(dst)) > 0
    src = rng.integers(0, V, E).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(cuda)
    src, d, valid = t(src), t(d), t(valid)
    return src, d, valid, ops._bands_on_device(src, d, valid, E // BLOCK_E)


def check_tiled(cuda, src, dst, valid, band, S, batch=None):
    tail = () if batch is None else (batch,)
    for dtype in (torch.float32, torch.int32):
        vals = draw_vals((700,) + tail, dtype, cuda)
        push_fused.reset_launch_counts()
        got = push_fused.fused_push(band, src, dst, valid, None, vals, S)
        again = push_fused.fused_push(band, src, dst, valid, None, vals, S)
        assert push_fused.launch_counts == tiled_counts(2)
        assert same_bits(got, again)
        want = push_fused.fused_push_plain(band, src, dst, valid, None, vals,
                                           S)
        assert_kernel_equal(got, want, "add")


def test_tiled_add_hub_block_spans_chunks(cuda):
    """A hub segment block with five chunks' worth of edges: its partials
    from every chunk are merged in chunk order."""
    rng = np.random.default_rng(4)
    n = 5 * push_fused.TILE_CHUNK_BLOCKS * BLOCK_E
    hub = np.minimum(rng.geometric(0.05, n) - 1, BLOCK_S - 1)  # skewed
    dst = np.concatenate([hub, np.sort(rng.integers(BLOCK_S, 4 * BLOCK_S,
                                                    3000))])
    src, d, valid, band = raw_sorted_layout(cuda, dst)
    plan = push_fused.tile_plan(band)
    c0, c1 = plan.tile_chunks[0, 0].tolist()
    assert c1 - c0 >= 4
    check_tiled(cuda, src, d, valid, band, 4 * BLOCK_S)


@pytest.mark.parametrize("batch", [None, 16])
def test_tiled_add_chunk_wider_than_a_tile(cuda, batch):
    """Ten dense chunks, then one chunk whose destinations spread over 40
    segment blocks (the warps take turns on one wide tile) and one over 6
    (several windows of the warps' own tiles, more with B=16's narrower
    ones): the blocks inside a range go straight to out."""
    rng = np.random.default_rng(5)
    n = push_fused.TILE_CHUNK_BLOCKS * BLOCK_E
    parts = [b * BLOCK_S + rng.integers(0, BLOCK_S, n) for b in range(10)]
    parts.append(np.sort(rng.integers(10 * BLOCK_S, 50 * BLOCK_S, n)))
    parts.append(np.sort(rng.integers(50 * BLOCK_S, 56 * BLOCK_S, n)))
    src, d, valid, band = raw_sorted_layout(cuda, np.concatenate(parts))
    plan = push_fused.tile_plan(band)
    assert plan.chunk_blocks[0, 10:12].tolist() == [[10, 49], [50, 55]]
    check_tiled(cuda, src, d, valid, band, 56 * BLOCK_S, batch)


def test_tiled_add_on_a_sparse_layout(cuda):
    """A near-uniform graph at 8 chares: most chunks are wider than a
    warp's tile (the warps take turns); right, and the same bits from call
    to call."""
    pg = G.partition(G.erdos_renyi(1 << 15, 1 << 16, seed=1), 8)
    a = pg.device_arrays("sd", cuda)
    args = (a["sd_band"], a["sd_src_local"], a["sd_dst_global"],
            a["sd_edge_valid"])
    cb = push_fused.tile_plan(args[0]).chunk_blocks
    assert bool(((cb[..., 1] - cb[..., 0]) >= 8).any())
    S = pg.num_chunks * pg.chunk_size
    vals = draw_vals((8, pg.chunk_size), torch.float32, cuda)
    got = push_fused.fused_push(*args, None, vals, S)
    assert same_bits(got, push_fused.fused_push(*args, None, vals, S))
    assert_kernel_equal(got, push_fused.fused_push_plain(*args, None, vals,
                                                         S), "add")


@pytest.mark.parametrize("batch", [None, 4])
def test_tiled_add_pieces_keep_the_bits(cuda, monkeypatch, batch):
    """A sparse chunk's range is split over several CTAs (the work list's
    pieces); the sums are the same bits whatever the piece size, from one
    segment block a CTA to the whole range."""
    pg = G.partition(G.erdos_renyi(1 << 15, 1 << 16, seed=2), 8)
    a = pg.device_arrays("sd", cuda)
    band = a["sd_band"]
    edges = (a["sd_src_local"], a["sd_dst_global"], a["sd_edge_valid"],
             a["sd_edge_weight"])
    S = pg.num_chunks * pg.chunk_size
    tail = () if batch is None else (batch,)
    vals = draw_vals((8, pg.chunk_size) + tail, torch.float32, cuda)
    plan = push_fused.tile_plan(band)
    live = int((plan.chunk_blocks[..., 1] >= plan.chunk_blocks[..., 0])
               .sum())
    assert plan.work.shape[0] > live  # some ranges are split
    got = push_fused.fused_push(band, *edges, vals, S)
    for piece in (1, 1 << 20):
        monkeypatch.setattr(push_fused, "TILE_PIECE_BLOCKS", piece)
        other = band.clone()  # a new table, so a plan with these pieces
        n = push_fused.tile_plan(other).work.shape[0]
        assert n > plan.work.shape[0] if piece == 1 else n == live
        assert same_bits(push_fused.fused_push(other, *edges, vals, S), got)
    assert_kernel_equal(got, push_fused.fused_push_plain(band, *edges, vals,
                                                         S), "add")


def test_tiled_add_ints_wrap_exactly(cuda):
    """int32 sums past 2^31 wrap as the plain version's do, bit for bit."""
    dst = np.repeat(np.arange(3 * BLOCK_S), 40)
    src, d, valid, band = raw_sorted_layout(cuda, dst)
    vals = torch.full((700,), (1 << 30) + 7, dtype=torch.int32, device=cuda)
    got = push_fused.fused_push(band, src, d, valid, None, vals, 3 * BLOCK_S)
    want = push_fused.fused_push_plain(band, src, d, valid, None, vals,
                                       3 * BLOCK_S)
    assert torch.equal(got, want)


def test_basic_layout_keeps_the_atomic_path(cuda):
    """The basic layout of an RMAT graph at C=1 is not seg-sorted: the add
    runs the atomic kernel alone, and is still right."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, scale=12,
                                               layout="basic")
    assert push_fused.tile_plan(band).num_tiled == 0
    vals = draw_vals((1, V), torch.float32, cuda)
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S)
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want.update(fused_push_add=1, fused_push_add_atomic=1)
    assert push_fused.launch_counts == want
    assert_kernel_equal(got, push_fused.fused_push_plain(
        band, src, dst, valid, w, vals, S), "add")


def test_ops_push_without_a_band_takes_the_atomic_add(cuda):
    """ops.push derives a band for one call when given none: the add runs
    the atomic kernel with no tile plan, so the call makes no host sync
    and caches nothing; the layout's own band takes the tiled path."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2, scale=12)
    vals = draw_vals((2, V), torch.float32, cuda)
    plans = len(push_fused._plans)
    push_fused.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.push(vals, src, dst, valid, S, weight=w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want.update(fused_push_add=1, fused_push_add_atomic=1)
    assert push_fused.launch_counts == want
    assert len(push_fused._plans) == plans
    push_fused.reset_launch_counts()
    tiled = ops.push(vals, src, dst, valid, S, weight=w, band=band)
    assert push_fused.launch_counts == tiled_counts()
    assert_kernel_equal(got, tiled, "add")


def test_mixed_rows_take_both_paths(cuda):
    """A table with a seg-sorted row and an unsorted one: one atomic launch
    over the unsorted row, the tiled kernels over the other."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2)
    dst = dst.clone()
    live = int(valid[1].sum())
    dst[1, :live] = dst[1, :live][torch.randperm(live, device=cuda)]
    band = ops._bands_on_device(src, dst, valid, band.shape[-1])
    assert push_fused.tile_plan(band).tiled.tolist() == [True, False]
    vals = draw_vals((2, V), torch.float32, cuda)
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S)
    want = tiled_counts()
    want["fused_push_add_atomic"] = 1
    assert push_fused.launch_counts == want
    assert_kernel_equal(got, push_fused.fused_push_plain(
        band, src, dst, valid, w, vals, S), "add")
    forced = push_fused.fused_push_atomic(band, src, dst, valid, w, vals, S)
    assert_kernel_equal(forced, got, "add")


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("rowed", [False, True])
def test_scatter_sum_on_layouts(cuda, dtype, order, batch, rowed):
    """scatter_sum over the sd layout's destinations (the shared-memory
    tile path) and over the same ids shuffled (the global path), chare rows
    or one row, with a [B] plane; ints past 2^24 exact, out-of-range ids
    dropped."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=3)
    tail = () if batch is None else (batch,)
    c = draw_vals(tuple(dst.shape) + tail, dtype, cuda)
    if dtype == torch.int32:
        c = c >> 5  # sums of up to ~10^4 terms stay inside int32
    # padding edges contribute nothing, as gathered values there are 0
    c = c * valid.reshape(valid.shape + (1,) * len(tail)).to(c.dtype)
    dst = dst.clone()
    if order == "shuffled":
        perm = torch.randperm(dst.shape[1], device=cuda)
        dst, c = dst[:, perm].contiguous(), c[:, perm].contiguous()
    dst[:, ::97] = -1
    dst[:, 5::101] = S + 3
    if not rowed:
        dst, c = dst[1], c[1]
    push_fused.reset_launch_counts()
    got = push_staged.scatter_sum(dst, c, S)
    assert push_fused.launch_counts["scatter_sum"] == 1
    assert_kernel_equal(got, push_staged.scatter_sum_plain(dst, c, S), "add")


def test_pagerank_runs_are_bit_identical(cuda):
    """Engine(pg, "sortdest") PageRank twice on the card: the same bits,
    through the tiled add."""
    pg = prepared("pagerank_weighted", G.rmat(12, 14 << 12, seed=1), 1)
    eng = Engine(pg)
    push_fused.reset_launch_counts()
    a, _ = eng.run("pagerank_weighted")
    b, _ = eng.run("pagerank_weighted")
    assert push_fused.launch_counts["fused_push_add_tiled"] > 0
    assert push_fused.launch_counts["fused_push_add_atomic"] == 0
    assert np.array_equal(np.asarray(a).view(np.int32),
                          np.asarray(b).view(np.int32))


# ---------------------------------------------------------------------------
# The tiled fused min and the tiled scatter_min
# ---------------------------------------------------------------------------


def min_counts(*paths, calls=1):
    """The launch counts of ``calls`` fused min calls taking ``paths``."""
    want = dict.fromkeys(push_fused.launch_counts, 0)
    want["fused_push_min"] = calls
    for path in paths:
        want[f"fused_push_min_{path}"] = calls
    return want


def min_paths(band):
    """The min's paths on a band table, as its plan gives the rows."""
    plan = push_fused.tile_plan(band)
    tiled = plan.num_tiled if plan.min_tiled else 0
    rows = push_fused._rowed(band).shape[0]
    return ((("tiled",) if tiled else ())
            + (("atomic",) if tiled < rows else ()))


def draw_dist(shape, dtype, cuda, seed=0, unreached=0.5):
    """Min values as the min programs hold them: distances or depths, a
    share ``unreached`` at the identity (int SENTINEL; for floats +inf,
    float(SENTINEL) and a value above it, all of which read as
    unreached)."""
    rng = np.random.default_rng(seed)
    if dtype == torch.float32:
        x = rng.uniform(0, 100, shape).astype(np.float32)
        far = rng.choice(np.array([np.inf, 2.0 ** 31, 3e9], np.float32),
                         shape)
    else:
        x = rng.integers(0, 10_000, shape).astype(np.int32)
        far = np.full(shape, push_fused.SENTINEL, np.int32)
    x = np.where(rng.random(shape) < unreached, far, x)
    return torch.from_numpy(x).to(cuda)


def min_weight(w, dtype, negative=False):
    """The layout's weights (uniform in [1, 10)) as a min program's edge
    values: floats as they are, ints as int(3w); or, ``negative``, moved
    below zero: 300 - 250w for floats (most |w| >= 256), 300 - 100 int(3w)
    for ints."""
    if dtype == torch.float32:
        return 300 - 250 * w if negative else w
    w = (w * 3).to(torch.int32)
    return 300 - 100 * w if negative else w


def check_min(band, src, dst, valid, w, vals, S, paths, init=None,
              unit=False):
    """One fused min call taking ``paths``, bit-equal to the plain version,
    and the same bits again on the atomic path alone."""
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S,
                                combine="min", unit_weight=unit, init=init)
    assert push_fused.launch_counts == min_counts(*paths)
    want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                       combine="min", unit_weight=unit,
                                       init=init)
    assert same_bits(got, want)
    atomic = push_fused.fused_push_atomic(band, src, dst, valid, w, vals, S,
                                          combine="min", unit_weight=unit,
                                          init=init)
    assert same_bits(atomic, want)
    return got


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("mode", ["none", "array", "unit"])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("chares", [1, 8])
@pytest.mark.parametrize("seeded", [False, True])
def test_tiled_min_matches_plain(cuda, dtype, mode, batch, chares, seeded):
    """On the sd layout the min takes the tiled kernel (one launch, no
    atomic one) and equals the plain version bit for bit, as does the
    atomic kernel alone on the same operands; half the sources unreached,
    with and without an init seed."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares, scale=12)
    tail = () if batch is None else (batch,)
    vals = draw_dist((chares, V) + tail, dtype, cuda)
    init = (draw_dist((chares, S) + tail, dtype, cuda, seed=1)
            if seeded else None)
    check_min(band, src, dst, valid,
              min_weight(w, dtype) if mode == "array" else None, vals, S,
              ("tiled",), init=init, unit=mode == "unit")


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("seeded", [False, True])
def test_tiled_min_keeps_unreached_sources_over_negative_weights(
        cuda, dtype, batch, seeded):
    """Every source unreached, weights down to -300: SENTINEL + w (ints)
    and 2^31 + w (floats, below 2^31 once |w| >= 256) are real values that
    neither path may skip."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, 2, scale=12)
    tail = () if batch is None else (batch,)
    vals = draw_dist((2, V) + tail, dtype, cuda, unreached=1.0)
    init = (draw_dist((2, S) + tail, dtype, cuda, seed=1, unreached=0.9)
            if seeded else None)
    got = check_min(band, src, dst, valid,
                    min_weight(w, dtype, negative=True), vals, S, ("tiled",),
                    init=init)
    top = push_fused.SENTINEL_F32 if dtype == torch.float32 \
        else push_fused.SENTINEL
    assert bool((got < top).any())


def test_tiled_min_keeps_a_float_init_above_the_sentinel(cuda):
    """A raw float init above 2^31 (+inf, 3e9): slots no contribution
    lowers keep it, and a contribution at 2^31 (an unreached source) still
    lowers it -- the tile's untouched marker is not the identity."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, 1, scale=12)
    vals = draw_dist((1, V), torch.float32, cuda, unreached=0.7)
    init = torch.where(torch.rand((1, S), device=cuda) < 0.5,
                       torch.full((1, S), float("inf"), device=cuda),
                       torch.full((1, S), 3e9, device=cuda))
    for weight in (None, w):
        got = check_min(band, src, dst, valid, weight, vals, S,
                        ("tiled",), init=init)
        assert bool((got == push_fused.SENTINEL_F32).any())
        assert bool((got > push_fused.SENTINEL_F32).any())


def test_tiled_min_hub_block_spans_chunks(cuda):
    """A hub segment block with five chunks' worth of edges: each chunk's
    CTA mins into it with global atomics."""
    rng = np.random.default_rng(4)
    n = 5 * push_fused.TILE_CHUNK_BLOCKS * BLOCK_E
    hub = np.minimum(rng.geometric(0.05, n) - 1, BLOCK_S - 1)
    dst = np.concatenate([hub, np.sort(rng.integers(BLOCK_S, 4 * BLOCK_S,
                                                    3000))])
    src, d, valid, band = raw_sorted_layout(cuda, dst)
    for dtype in (torch.int32, torch.float32):
        for batch in ((), (16,)):
            vals = draw_dist((700,) + batch, dtype, cuda, unreached=0.9)
            check_min(band, src, d, valid, None, vals, 4 * BLOCK_S,
                      ("tiled",))


@pytest.mark.parametrize("batch", [None, 16])
def test_tiled_min_chunk_wider_than_a_tile(cuda, batch):
    """Dense chunks, then chunks over 40 and 6 segment blocks: pieces and,
    with B=16, several windows per piece."""
    rng = np.random.default_rng(5)
    n = push_fused.TILE_CHUNK_BLOCKS * BLOCK_E
    parts = [b * BLOCK_S + rng.integers(0, BLOCK_S, n) for b in range(10)]
    parts.append(np.sort(rng.integers(10 * BLOCK_S, 50 * BLOCK_S, n)))
    parts.append(np.sort(rng.integers(50 * BLOCK_S, 56 * BLOCK_S, n)))
    src, d, valid, band = raw_sorted_layout(cuda, np.concatenate(parts))
    tail = () if batch is None else (batch,)
    for dtype in (torch.int32, torch.float32):
        vals = draw_dist((700,) + tail, dtype, cuda)
        check_min(band, src, d, valid, None, vals, 56 * BLOCK_S,
                  min_paths(band), unit=True)


@pytest.mark.parametrize("graph", ["er", "rmat"])
@pytest.mark.parametrize("batch", [None, 4])
def test_tiled_min_on_sparse_layouts(cuda, graph, batch):
    """The sd layout at 8 chares of a near-uniform graph (0.25 edges per
    segment of the chunks' ranges: the atomic kernel) and of an RMAT graph
    (1.6, rows down to 0.2: the tiled kernel, every row), bit-equal to the
    plain version; and the same bits with the rule's threshold moved so
    that each table takes the other kernel (a new table, a plan of its
    own)."""
    g = (G.erdos_renyi(1 << 15, 1 << 16, seed=1) if graph == "er"
         else G.rmat(13, 14 << 13, seed=1))
    pg = G.partition(G.random_weights(g, seed=5), 8)
    a = pg.device_arrays("sd", cuda)
    band = a["sd_band"]
    plan = push_fused.tile_plan(band)
    assert plan.num_tiled == 8 and plan.min_tiled is (graph == "rmat")
    edges = (a["sd_src_local"], a["sd_dst_global"], a["sd_edge_valid"])
    S = pg.num_chunks * pg.chunk_size
    tail = () if batch is None else (batch,)
    other = band.clone()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(push_fused, "MIN_TILE_EDGES_PER_SEGMENT",
                  0 if graph == "er" else float("inf"))
        assert push_fused.tile_plan(other).min_tiled is (graph == "er")
    for dtype in (torch.int32, torch.float32):
        vals = draw_dist((8, pg.chunk_size) + tail, dtype, cuda)
        w = min_weight(a["sd_edge_weight"], dtype)
        got = check_min(band, *edges, w, vals, S, min_paths(band))
        assert same_bits(check_min(other, *edges, w, vals, S,
                                   min_paths(other)), got)


def test_basic_layout_keeps_the_atomic_min(cuda):
    """The basic layout of an RMAT graph at C=1 is not seg-sorted: the min
    runs the atomic kernel alone, bit-equal to the plain version."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, scale=12,
                                               layout="basic")
    assert push_fused.tile_plan(band).num_tiled == 0
    for dtype in (torch.int32, torch.float32):
        vals = draw_dist((1, V), dtype, cuda)
        check_min(band, src, dst, valid, min_weight(w, dtype), vals, S,
                  ("atomic",))


def test_mixed_rows_take_both_min_paths(cuda):
    """A seg-sorted row and an unsorted one: one atomic launch over the
    unsorted row, the tiled kernel over the other."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2, scale=12)
    dst = dst.clone()
    live = int(valid[1].sum())
    dst[1, :live] = dst[1, :live][torch.randperm(live, device=cuda)]
    band = ops._bands_on_device(src, dst, valid, band.shape[-1])
    assert push_fused.tile_plan(band).tiled.tolist() == [True, False]
    for dtype in (torch.int32, torch.float32):
        vals = draw_dist((2, V), dtype, cuda)
        push_fused.reset_launch_counts()
        got = push_fused.fused_push(band, src, dst, valid, None, vals, S,
                                    combine="min")
        assert push_fused.launch_counts == min_counts("tiled", "atomic")
        assert same_bits(got, push_fused.fused_push_plain(
            band, src, dst, valid, None, vals, S, combine="min"))


def test_ops_push_without_a_band_takes_the_atomic_min(cuda):
    """ops.push without a band runs the atomic min with no tile plan and
    no host sync; with the layout's band, the tiled one; same bits."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2, scale=12)
    vals = draw_dist((2, V), torch.float32, cuda)
    plans = len(push_fused._plans)
    push_fused.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = ops.push(vals, src, dst, valid, S, combine="min", weight=w)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert push_fused.launch_counts == min_counts("atomic")
    assert len(push_fused._plans) == plans
    push_fused.reset_launch_counts()
    tiled = ops.push(vals, src, dst, valid, S, combine="min", weight=w,
                     band=band)
    assert push_fused.launch_counts == min_counts("tiled")
    assert same_bits(got, tiled)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
@pytest.mark.parametrize("order", ["sorted", "shuffled", "pairwise"])
@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("rowed", [False, True])
def test_scatter_min_on_layouts(cuda, dtype, order, batch, rowed):
    """scatter_min over the sd layout's destinations (the shared-memory
    tile path), the same ids shuffled and the pairwise layout's (the global
    path), chare rows or one row, with a [B] plane; bit-equal to the plain
    version, contributions at the identity skipped, negatives kept,
    out-of-range ids dropped."""
    if order == "pairwise":
        pg = G.partition(G.random_weights(G.rmat(12, 14 << 12, seed=1),
                                          seed=5), 3)
        dst = pg.device_pairwise(cuda)["pb_recv_dst"]  # basic's receive
        S = pg.chunk_size
    else:
        src, dst, valid, w, band, V, S = sd_layout(cuda, chares=3, scale=12)
    tail = () if batch is None else (batch,)
    c = draw_dist(tuple(dst.shape) + tail, dtype, cuda, unreached=0.3)
    top = push_fused.SENTINEL_F32 if dtype == torch.float32 \
        else push_fused.SENTINEL
    c = torch.where(c < top, c - 50, c)  # some negatives
    dst = dst.clone()
    if order == "shuffled":
        perm = torch.randperm(dst.shape[1], device=cuda)
        dst, c = dst[:, perm].contiguous(), c[:, perm].contiguous()
    dst[:, ::97] = -1
    dst[:, 5::101] = S + 3
    if not rowed:
        dst, c = dst[1], c[1]
    push_fused.reset_launch_counts()
    got = push_staged.scatter_min(dst, c, S)
    assert push_fused.launch_counts["scatter_min"] == 1
    assert same_bits(got, push_staged.scatter_min_plain(dst, c, S))


# ---------------------------------------------------------------------------
# The batched query plane on the card
# ---------------------------------------------------------------------------

BATCH_PROGRAMS = ("bfs", "sssp", "personalized_pagerank", "pagerank")
SEED_SETS = [(0,), (7, 61), (3, 5, 40), 100, 2047]


@pytest.mark.parametrize("chares", (1, 8))
@pytest.mark.parametrize("strategy", ("sortdest", "reduction", "pairs",
                                      "basic"))
@pytest.mark.parametrize("name", BATCH_PROGRAMS)
def test_run_batch_on_cuda_matches_cpu(cuda, name, strategy, chares):
    """run_batch on the card equals the same plane on the CPU: min planes
    and per-query counts bit-equal, add planes within 1e-5."""
    pg = prepared("sssp", G.rmat(11, 14 << 11, seed=1), chares)
    got, got_it = Engine(pg, strategy=strategy).run_batch(
        name, sources=SEED_SETS)
    want, want_it = Engine(pg, strategy=strategy, device="cpu").run_batch(
        name, sources=SEED_SETS)
    np.testing.assert_array_equal(got_it, want_it)
    assert got.dtype == want.dtype and got.shape == want.shape
    if name in ("bfs", "sssp"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_betweenness_on_cuda_matches_cpu(cuda):
    """The Brandes accumulation on the card (float64 atomics, no fixed
    order) within rtol 1e-12 of the CPU's."""
    pg = prepared("betweenness", G.rmat(11, 14 << 11, seed=1), 1)
    pivots = (0, 5, 9, 33, 700)
    got, it = Engine(pg).betweenness(pivots=pivots)
    want, want_it = Engine(pg, device="cpu").betweenness(pivots=pivots)
    assert it == want_it and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("B", (4, 16))
def test_ppr_column_is_bit_equal_to_its_one_column_run(cuda, B):
    """On the sd layout, where the add is fixed-order, a PPR column of a
    [B] plane before normalization has the bits of the same query at B=1;
    after normalization they agree within 1e-7."""
    from repro_torch.core import programs as P

    pg = prepared("pagerank", G.rmat(12, 14 << 12, seed=1), 1)
    eng = Engine(pg)
    prog = P.make_program("personalized_pagerank")
    sets = P.seed_sets([(7, 61)] + [i * 13 for i in range(B - 1)])
    planes = []
    for cols in (sets, sets[:1]):
        state, qp = eng._batch_init(prog, cols)
        state, _ = eng._batch_loop(prog, state, qp)
        planes.append(eng._unpermute(state))
    assert same_bits(planes[0][0].contiguous(), planes[1][0].contiguous())
    wide, _ = eng.run_batch(prog, sources=sets)
    one, _ = eng.run_batch(prog, sources=sets[:1])
    np.testing.assert_allclose(wide[0], one[0], rtol=0, atol=1e-7)


@pytest.mark.parametrize("B", (1, 4, 16))
@pytest.mark.parametrize("name", ("bfs", "sssp", "personalized_pagerank"))
def test_one_fused_launch_per_superstep_whatever_b(cuda, name, B):
    pg = prepared("sssp", G.rmat(12, 14 << 12, seed=1), 1)
    eng = Engine(pg)
    sources = [int(s) for s in np.random.default_rng(B).integers(0, 4096, B)]
    push_fused.reset_launch_counts()
    _, q_it = eng.run_batch(name, sources=sources)
    supersteps = eng.dispatch["supersteps"]
    assert supersteps == int(q_it.max())
    combine = "add" if name == "personalized_pagerank" else "min"
    assert dict(push_fused.launch_counts) == fused_launches(
        eng.arrays, "sd", combine, supersteps)
    assert push_fused.launch_counts[f"fused_push_{combine}_tiled"] == \
        supersteps


WIDE_CASES = [
    ("add", torch.float32, "none"), ("add", torch.float32, "weight"),
    ("min", torch.int32, "unit"), ("min", torch.float32, "weight")]


def check_fused_plane(cuda, combine, dtype, mode, layout, B):
    """Both fused kernels on a [B] plane (the tiled paths on the sd layout,
    the atomic kernel on the basic one) against the plain version."""
    src, dst, valid, w, band, V, S = sd_layout(cuda, chares=2,
                                               layout=layout)
    vals = (draw_vals((2, V, B), dtype, cuda) if combine == "add"
            else draw_dist((2, V, B), dtype, cuda))
    if mode != "weight":
        w = None
    elif combine == "min":
        w = min_weight(w, dtype)
    kw = dict(combine=combine, unit_weight=mode == "unit")
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S, **kw)
    want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                       **kw)
    assert_kernel_equal(got, want, combine)


@pytest.mark.parametrize("combine,dtype,mode", WIDE_CASES)
@pytest.mark.parametrize("layout", ("sd", "basic"))
def test_fused_kernels_at_b16_match_plain(cuda, combine, dtype, mode,
                                          layout):
    check_fused_plane(cuda, combine, dtype, mode, layout, 16)


@pytest.mark.parametrize("combine,dtype,mode", WIDE_CASES)
@pytest.mark.parametrize("layout", ("sd", "basic"))
def test_fused_kernels_at_b8_match_plain(cuda, combine, dtype, mode, layout):
    """The server's plane width."""
    check_fused_plane(cuda, combine, dtype, mode, layout, 8)


def test_unpermute_returns_pinned_host_memory_from_one_copy(cuda):
    """The result of run and run_batch is un-permuted on the card and comes
    back in one device-to-host copy, into pinned memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pg = G.partition(G.rmat(12, 14 << 12, seed=1), 2,
                     partitioner="degree_sorted")
    eng = Engine(pg)
    state = torch.arange(pg.num_chunks * pg.chunk_size * 3, device=cuda,
                         dtype=torch.int32).reshape(pg.num_chunks,
                                                    pg.chunk_size, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host = eng._to_host(eng._unpermute(state)[:2])
        torch.cuda.synchronize()
    copies = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and "DtoH" in e.key]
    assert sum(e.count for e in copies) == 1, [e.key for e in copies]
    assert torch.from_numpy(host).is_pinned()
    flat = state.reshape(-1, 3).cpu().numpy()
    np.testing.assert_array_equal(host, flat[pg.global_to_local].T[:2])
    got, _ = eng.run("bfs", source=5)
    assert torch.from_numpy(got).is_pinned()
    np.testing.assert_array_equal(got, Engine(pg, device="cpu").run(
        "bfs", source=5)[0])


def test_warmed_pinned_cache_serves_a_load_of_results(cuda):
    """latency_table's warm before its loads: afterwards, a load's worth of
    held results of each width 1..B (N queries' worth) comes from torch's
    pinned cache, with no fresh cudaHostAlloc."""
    from repro_torch.benchmarks import tables

    g = G.rmat(12, 32 << 10, seed=2)
    eng = Engine(G.partition(g, 1))
    eng.run_batch("bfs", sources=[0], batch=4)  # builds the kernels
    B, N = 4, 8
    tables._warm_pinned_results(eng, B, N)
    fresh = torch.cuda.host_memory_stats()["num_host_alloc"]
    for b in range(1, B + 1):
        held = [eng.run_batch("bfs", sources=list(range(s, s + b)),
                              batch=B)[0] for s in range(-(-N // b))]
        assert all(h.shape == (b, g.num_vertices) for h in held)
        del held
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == fresh


# ---------------------------------------------------------------------------
# The graph query server on the card
# ---------------------------------------------------------------------------

SERVE_TRAFFIC = [  # (program, source, params): 6 bfs, 3 sssp, 3 PPR
    ("bfs", 0, {}), ("sssp", 5, {}), ("personalized_pagerank", (7, 61, 99),
                                      {"iters": 6}),
    ("bfs", 100, {}), ("bfs", 2047, {}), ("sssp", 9, {}),
    ("personalized_pagerank", 3, {"iters": 6}), ("bfs", 33, {}),
    ("bfs", 1500, {}), ("sssp", 4000, {}), ("bfs", 12, {}),
    ("personalized_pagerank", 700, {"iters": 6}),
]


class EventTimed:
    """An engine with CUDA events recorded (not waited on) around each
    run_batch."""

    def __init__(self, eng):
        self.eng, self.events = eng, []

    def run_batch(self, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.eng.run_batch(*args, **kw)
        end.record()
        self.events.append((start, end))
        return out


@pytest.mark.parametrize("policy", ("greedy", "deadline"))
def test_server_on_cuda_matches_cpu(cuda, policy):
    """A mixed queue served on the card gives the CPU server's admissions,
    rows and superstep counts (bfs/sssp bit for bit, PPR within 1e-6), and
    each dispatch's host-clock seconds cover its CUDA-event time."""
    from repro_torch.launch import serve as S

    pg = prepared("sssp", G.rmat(12, 14 << 12, seed=1), 1)
    done, rows = {}, {}
    for dev in ("cuda", "cpu"):
        eng = Engine(pg, device=dev)
        timed = EventTimed(eng) if dev == "cuda" else eng
        pol = S.DeadlinePolicy() if policy == "deadline" else S.GreedyPolicy()
        server = S.GraphQueryServer(timed, batch=4, policy=pol,
                                    clock=S.VirtualClock())
        ids = [server.submit(p, s, deadline=1.0, **kw)
               for p, s, kw in SERVE_TRAFFIC]
        done[dev] = []
        while server.pending():
            got = server.step() or server.step(force=True)
            done[dev].append(got)
            if dev == "cuda":
                start, end = timed.events[-1]
                end.synchronize()
                assert server.last_dispatch_s >= \
                    start.elapsed_time(end) / 1e3
        rows[dev] = [server.result(i) for i in ids]
    if policy == "greedy":
        assert done["cuda"] == done["cpu"]
    for (prog, *_), (got, it), (want, want_it) in zip(
            SERVE_TRAFFIC, rows["cuda"], rows["cpu"]):
        assert it == want_it and got.dtype == want.dtype
        if prog == "personalized_pagerank":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# The 2-D grid: the fused kernels on gr_band, the grid engine on the card
# ---------------------------------------------------------------------------


def grid_layout(cuda, shape=(2, 4), scale=13):
    """A weighted RMAT grid partition's rectangle layout on the card, as
    the engine holds it: (src, dst, valid, weight, band, Kr, C*Kc)."""
    R, C = shape
    pg = G.partition(G.random_weights(G.rmat(scale, 14 << scale, seed=1),
                                      seed=5), R * C,
                     partitioner=f"grid({R},{C})")
    a = pg.device_arrays("grid", cuda)
    return (a["gr_src_local"], a["gr_dst_col"], a["gr_edge_valid"],
            a["gr_edge_weight"], a["gr_band"], pg.chunk_size,
            C * pg.col_chunk_size)


@pytest.mark.parametrize("combine,dtype,mode", WIDE_CASES)
@pytest.mark.parametrize("B", (None, 8))
def test_fused_kernels_on_gr_band_match_plain(cuda, combine, dtype, mode, B):
    """Both fused kernels over the 8 rectangle rows of grid(2,4) -- each
    row's segments inside its column's Kc slice of the column space --
    against the plain version, on the tiled path; the tiled add's repeat
    and its plane's columns bit-identical to one-column calls."""
    src, dst, valid, w, band, V, S = grid_layout(cuda)
    P = src.shape[0]
    shape = (P, V) + (() if B is None else (B,))
    vals = (draw_vals(shape, dtype, cuda) if combine == "add"
            else draw_dist(shape, dtype, cuda))
    if mode != "weight":
        w = None
    elif combine == "min":
        w = min_weight(w, dtype)
    kw = dict(combine=combine, unit_weight=mode == "unit")
    plan = push_fused.tile_plan(band)
    assert plan.num_tiled == P
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S, **kw)
    path = "tiled" if combine == "add" or plan.min_tiled else "atomic"
    assert push_fused.launch_counts[f"fused_push_{combine}_{path}"] == 1
    want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                       **kw)
    assert_kernel_equal(got, want, combine)
    if combine == "add" and dtype == torch.float32:
        again = push_fused.fused_push(band, src, dst, valid, w, vals, S, **kw)
        assert same_bits(again, got)
        for b in range(B or 0):
            one = push_fused.fused_push(band, src, dst, valid, w,
                                        vals[..., b].contiguous(), S, **kw)
            assert same_bits(got[..., b].contiguous(), one)


@pytest.mark.parametrize("collectives", ("grouped", "full"))
@pytest.mark.parametrize("shape", ((2, 4), (4, 2), (1, 2)))
@pytest.mark.parametrize("name", PROGRAMS)
def test_grid_engine_on_cuda_matches_cpu(cuda, name, shape, collectives):
    """The grid engine on the card agrees with the same engine on the CPU
    (min bit for bit with equal superstep counts, add within 1e-5),
    launches its fused kernel once per superstep on gr_band's path, and
    counts the collective bytes ``grid_collective_bytes`` prices."""
    from repro_torch.core import cost

    R, C = shape
    spec = get_spec(name)
    g = G.rmat(11, 14 << 11, seed=1)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    g = spec.prepare_graph(g)
    pg = G.partition(g, R * C, partitioner=f"grid({R},{C})")
    eng = Engine(pg, collectives=collectives)
    assert eng.strategy == "grid2d" and eng.dispatch["kernel"] == "cuda"
    iters, launched = run_both(name, pg, collectives=collectives)
    combine = spec.make().combiner.name
    if eng.dispatch["choice"] == "fused":
        assert launched == fused_launches(eng.arrays, "grid", combine, iters)
    else:
        assert launched == staged_launches(combine, iters)
    eng.run(name)
    price = cost.grid_collective_bytes(g, R * C, f"grid({R},{C})")
    assert eng.dispatch["collectives"]["bytes_per_superstep"] == \
        pytest.approx(price[collectives])


@pytest.mark.parametrize("name", BATCH_PROGRAMS)
def test_grid_run_batch_on_cuda_matches_cpu(cuda, name):
    """run_batch on grid(2,4) on the card equals the CPU's plane: seeds
    and the teleport plane on every replica, the un-permute through the
    column-0 replicas."""
    pg = G.partition(prepared("sssp", G.rmat(11, 14 << 11, seed=1), 1).graph,
                     8, partitioner="grid(2,4)")
    got, got_it = Engine(pg).run_batch(name, sources=SEED_SETS)
    want, want_it = Engine(pg, device="cpu").run_batch(name,
                                                       sources=SEED_SETS)
    np.testing.assert_array_equal(got_it, want_it)
    if name in ("bfs", "sssp"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The row gate in the push kernels, and the engine's adaptive modes
# ---------------------------------------------------------------------------

ROW_MASKS = ("none", "all", "half")


def row_mask(kind, rows, cuda):
    """``None``, every row gated, or every other row gated."""
    if kind == "none":
        return None
    keep = np.zeros(rows, np.int32) if kind == "all" \
        else (np.arange(rows) % 2).astype(np.int32)
    return torch.from_numpy(keep).to(cuda)


def gated_rows_hold(got, mask, init, combine):
    """Every gated row of ``got`` is its ``init`` row, or the kernel's
    identity, bit for bit."""
    if mask is None:
        return True
    off = (mask == 0).nonzero().flatten()
    if init is not None:
        want = init[off]
    else:
        fill = (0 if combine == "add" else push_fused.SENTINEL_F32
                if got.dtype.is_floating_point else push_fused.SENTINEL)
        want = torch.full_like(got[off], fill)
    return same_bits(got[off].contiguous(), want.contiguous())


@pytest.mark.parametrize("layout", ("sd", "basic", "grid"))
@pytest.mark.parametrize("combine,dtype,mode", WIDE_CASES)
@pytest.mark.parametrize("mask", ROW_MASKS)
@pytest.mark.parametrize("B", (None, 4))
@pytest.mark.parametrize("seeded", (False, True))
def test_gated_fused_kernels_match_plain(cuda, layout, combine, dtype, mode,
                                         mask, B, seeded):
    """Both fused kernels with a row gate -- on the C=8 sd layout (tiled),
    the basic layout (atomic) and grid(2,4)'s gr_band -- against the gated
    plain version: gated rows are their init row or the identity, bit for
    bit, and active rows equal the call without the gate (bit for bit on
    the tiled add, whose order is fixed).  A gated launch still counts."""
    if layout == "grid":
        src, dst, valid, w, band, V, S = grid_layout(cuda)
    else:
        src, dst, valid, w, band, V, S = sd_layout(cuda, chares=8,
                                                   layout=layout)
    P = src.shape[0]
    shape = (P, V) + (() if B is None else (B,))
    vals = (draw_vals(shape, dtype, cuda) if combine == "add"
            else draw_dist(shape, dtype, cuda))
    if mode != "weight":
        w = None
    elif combine == "min":
        w = min_weight(w, dtype)
    od = push_fused.output_dtype(dtype, combine)
    init = None
    if seeded:
        init = (draw_vals((P, S) + shape[2:], od, cuda, seed=3)
                if combine == "add" else draw_dist((P, S) + shape[2:], od,
                                                   cuda, seed=3))
    ra = row_mask(mask, P, cuda)
    kw = dict(combine=combine, unit_weight=mode == "unit", init=init)
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(band, src, dst, valid, w, vals, S,
                                row_active=ra, **kw)
    assert push_fused.launch_counts[f"fused_push_{combine}"] == 1
    want = push_fused.fused_push_plain(band, src, dst, valid, w, vals, S,
                                       row_active=ra, **kw)
    assert_kernel_equal(got, want, combine)
    assert gated_rows_hold(got, ra, init, combine)
    full = push_fused.fused_push(band, src, dst, valid, w, vals, S, **kw)
    on = (torch.ones(P, dtype=torch.int32, device=cuda) if ra is None
          else ra).nonzero().flatten()
    if combine == "min" or layout != "basic":  # fixed order or exact
        assert same_bits(got[on].contiguous(), full[on].contiguous())
    else:
        assert_kernel_equal(got[on], full[on], combine)


@pytest.mark.parametrize("kernel,dtype", STAGED_CASES)
@pytest.mark.parametrize("mask", ROW_MASKS)
@pytest.mark.parametrize("B", (None, 4))
def test_gated_staged_kernels_match_plain(cuda, kernel, dtype, mask, B):
    """The staged gather and scatter with a row gate against their gated
    plain versions: a gated row gathers the identity, a gated scatter row
    holds it, active rows equal the ungated call."""
    src, dst, valid, _, _, V, S = sd_layout(cuda, chares=8)
    P = src.shape[0]
    ra = row_mask(mask, P, cuda)
    tail = () if B is None else (B,)
    fn = getattr(push_staged, kernel)
    plain = getattr(push_staged, kernel + "_plain")
    combine = "min" if kernel.endswith("min") else "add"
    shape = ((P, V) if kernel.startswith("gather")
             else tuple(src.shape)) + tail
    if dtype == torch.bfloat16:
        x = draw_vals(shape, torch.float32, cuda).bfloat16()
    else:
        x = (draw_dist if combine == "min" else draw_vals)(shape, dtype, cuda)
    args = (src, valid, x) if kernel.startswith("gather") else (dst, x, S)
    push_fused.reset_launch_counts()
    got = fn(*args, ra)
    assert push_fused.launch_counts[kernel] == 1
    assert_kernel_equal(got, plain(*args, ra), combine)
    full = fn(*args)
    if ra is not None:
        off, on = (ra == 0).nonzero().flatten(), ra.nonzero().flatten()
        ident = (0 if combine == "add" else push_fused.SENTINEL_F32
                 if got.dtype.is_floating_point else push_fused.SENTINEL)
        assert same_bits(got[off].contiguous(),
                         torch.full_like(got[off], ident).contiguous())
    else:
        on = torch.arange(P, device=cuda)
    assert_kernel_equal(got[on], full[on], combine)


MODE_CASES = (dict(sync="overlap"), dict(gate="frontier"),
              dict(sync="overlap", gate="frontier"),
              dict(replan="degree_sorted"),
              dict(sync="overlap", gate="frontier",
                   replan="edge_balanced"))


@pytest.mark.parametrize("kw", MODE_CASES, ids=lambda kw: "+".join(
    f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("part", ((1, "contiguous"), (8, "contiguous"),
                                  (8, "grid(2,4)")))
@pytest.mark.parametrize("name", ("bfs", "sssp", "labelprop"))
def test_modes_on_cuda_match_cpu(cuda, name, part, kw):
    """Overlap, the gate and replan on the card agree with the same
    engine on the CPU: min results bit for bit, equal superstep counts and
    equal gate accounting; the gated pushes launch the kernels."""
    from repro_torch.core import ReplanPolicy

    pes, partitioner = part
    kw = dict(kw)
    if "replan" in kw:
        kw["replan"] = ReplanPolicy(kw["replan"], every=2, mode="always")
    spec = get_spec(name)
    g = G.rmat(11, 14 << 11, seed=1)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    g = spec.prepare_graph(g)
    eng = Engine(G.partition(g, pes, partitioner=partitioner))
    push_fused.reset_launch_counts()
    got, iters = eng.run(name, **kw)
    assert sum(push_fused.launch_counts.values()) > 0
    cpu = Engine(G.partition(g, pes, partitioner=partitioner), device="cpu")
    want, want_iters = cpu.run(name, **kw)
    np.testing.assert_array_equal(got, want)
    assert iters == want_iters
    assert eng.dispatch["gate"] == cpu.dispatch["gate"]
    assert eng.pg.partitioner == cpu.pg.partitioner


@pytest.mark.parametrize("kw", MODE_CASES[:3] + MODE_CASES[4:])
def test_batched_modes_on_cuda_match_cpu(cuda, kw):
    """The batched plane under overlap, the gate and replan on the card
    equals the CPU's, column for column, with equal per-query counts."""
    from repro_torch.core import ReplanPolicy

    kw = dict(kw)
    if "replan" in kw:
        kw["replan"] = ReplanPolicy(kw["replan"], every=2, mode="always")
    g = G.random_weights(G.rmat(11, 14 << 11, seed=1), seed=5)
    got, got_it = Engine(G.partition(g, 8)).run_batch(
        "sssp", sources=[0, 5, 9, 77], **kw)
    want, want_it = Engine(G.partition(g, 8), device="cpu").run_batch(
        "sssp", sources=[0, 5, 9, 77], **kw)
    np.testing.assert_array_equal(got_it, want_it)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Out-of-core streaming: the fused kernels on window operands, each window's
# own tile plan, the streamed engine and its prefetcher's ordering
# ---------------------------------------------------------------------------


def stream_source(shape=(1, 1), scale=13, windows=4):
    """A weighted RMAT grid partition and its ShardSource."""
    R, C = shape
    pg = G.partition(G.random_weights(G.rmat(scale, 14 << scale, seed=1),
                                      seed=5), R * C,
                     partitioner=f"grid({R},{C})")
    return pg, pg.shard_source(windows=windows)


def window_operands(sb, k, cuda, active=None):
    """Window ``k`` read into a pinned staging slot and copied to the card:
    (the staged planes, the window's own band table)."""
    staging = sb.make_staging(pin_memory=True)
    sb.read_window(k, staging, active)
    wd = {n: t.to(cuda) for n, t in
          sb.staged_views(staging["buffer"]).items()}
    return wd, sb.window_bands(cuda)[k]


@pytest.mark.parametrize("combine,dtype,mode", WIDE_CASES)
@pytest.mark.parametrize("gated", (False, True))
@pytest.mark.parametrize("k", (0, -1))
def test_windowed_fused_kernels_match_plain(cuda, combine, dtype, mode,
                                            gated, k):
    """Both fused kernels on one window of grid(2,4)'s table (a full window
    and the ragged tail), seeded with a non-identity init and gated by the
    window's row mask (rectangles 1 and 6 skipped), against the plain
    version with the same init and gate: gated rows keep init bit for bit,
    and the tiled add is bit-identical from call to call."""
    pg, sb = stream_source((2, 4))
    k = k % sb.num_windows
    P = pg.num_chunks
    active = np.ones(P, dtype=bool)
    if gated:
        active[[1, 6]] = False
    wd, band = window_operands(sb, k, cuda, active)
    V = pg.chunk_size
    S = pg.grid_shape[1] * pg.col_chunk_size
    vals = (draw_vals((P, V), dtype, cuda) if combine == "add"
            else draw_dist((P, V), dtype, cuda))
    od = push_fused.output_dtype(dtype, combine)
    init = (draw_vals((P, S), od, cuda, seed=3) if combine == "add"
            else draw_dist((P, S), od, cuda, seed=3))
    if combine == "min" and od.is_floating_point:
        init = torch.clamp(init, max=push_fused.SENTINEL_F32)
    w = wd["gr_edge_weight"] if mode == "weight" else None
    if w is not None and combine == "min":
        w = min_weight(w, dtype)
    ra = wd["row_active"]
    kw = dict(combine=combine, unit_weight=mode == "unit", init=init,
              row_active=ra)
    args = (band, wd["gr_src_local"], wd["gr_dst_col"], wd["gr_edge_valid"],
            w, vals, S)
    push_fused.reset_launch_counts()
    got = push_fused.fused_push(*args, **kw)
    assert push_fused.launch_counts[f"fused_push_{combine}"] == 1
    want = push_fused.fused_push_plain(*args, **kw)
    assert_kernel_equal(got, want, combine)
    assert gated_rows_hold(got, ra, init, combine)
    if combine == "add" and dtype == torch.float32:
        assert same_bits(push_fused.fused_push(*args, **kw), got)


def test_window_tile_plans_are_their_own(cuda):
    """Two windows of one table learn different tile plans, and a streamed
    run hands the kernels each window's own band tensor (learned at bind),
    never a recycled staging tensor: every band a push received is the
    engine's table for the window it folds, in fetch order."""
    pg, sb = stream_source(windows=4)
    eng = Engine(pg, residency="stream", stream=StreamConfig(windows=4))
    p0 = push_fused.tile_plan(eng._win_bands[0])
    p1 = push_fused.tile_plan(eng._win_bands[1])
    assert not torch.equal(p0.chunk_blocks, p1.chunk_blocks)
    for k, band in enumerate(eng._win_bands):
        fresh = push_fused.tile_plan(band.clone())
        assert torch.equal(push_fused.tile_plan(band).work, fresh.work), k
    seen = []
    hook = eng.push_fn

    def recording(*args, band=None, **kw):
        seen.append(band)
        return hook(*args, band=band, **kw)

    recording.fused = True
    eng.push_fn = recording
    _, it = eng.run("bfs")
    nw = eng.dispatch["stream"]["windows"]
    assert len(seen) == it * nw
    assert all(b is eng._win_bands[i % nw] for i, b in enumerate(seen))


@pytest.mark.parametrize("prefetch", (True, False))
@pytest.mark.parametrize("name", PROGRAMS)
def test_streamed_engine_on_cuda_matches_resident(cuda, name, prefetch):
    """The streamed engine on the card (grid(1,1), 5 windows) against the
    resident grid(1,1) engine on the card and the streamed engine on the
    CPU: min bit for bit with equal superstep counts, add within 1e-5; one
    fused launch per window fold; the copies timed on the card."""
    spec = get_spec(name)
    g = G.rmat(12, 14 << 12, seed=1)
    if spec.weighted:
        g = G.random_weights(g, seed=5)
    g = spec.prepare_graph(g)
    cfg = StreamConfig(windows=5, prefetch=prefetch)
    eng = Engine(G.partition(g, 1, "grid(1,1)"), residency="stream",
                 stream=cfg)
    push_fused.reset_launch_counts()
    got, it = eng.run(name)
    st = eng.dispatch["stream"]
    combine = spec.make(**spec.defaults).combiner.name
    assert push_fused.launch_counts[f"fused_push_{combine}"] == st["fetches"]
    assert st["h2d_s"] > 0 and st["h2d_bytes"] > 0
    assert st["pipelined"] is prefetch
    want, want_it = Engine(G.partition(g, 1, "grid(1,1)")).run(name)
    cpu, cpu_it = Engine(G.partition(g, 1, "grid(1,1)"), device="cpu",
                         residency="stream", stream=cfg).run(name)
    assert it == want_it == cpu_it
    if spec.exact or name == "labelprop":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cpu)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(got, cpu, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("prefetch", (True, False))
def test_prefetcher_orders_copies_behind_slow_folds(cuda, prefetch):
    """A deliberately slow fold (a device spin before each window's push)
    leaves the copy stream far ahead of the compute stream: a copy into a
    device slot before the fold that read it finished, or a refill of a
    pinned slot before its copy finished, would corrupt a window.  The
    results stay equal to the resident run's, batched plane included."""
    g = G.random_weights(G.rmat(12, 14 << 12, seed=1), seed=5)
    eng = Engine(G.partition(g, 1, "grid(1,1)"), residency="stream",
                 stream=StreamConfig(windows=6, prefetch=prefetch))
    hook = eng.push_fn

    def slow(*args, **kw):
        torch.cuda._sleep(2_000_000)  # about a millisecond of spinning
        return hook(*args, **kw)

    slow.fused = True
    eng.push_fn = slow
    res = Engine(G.partition(g, 1, "grid(1,1)"))
    for prog in ("sssp", "bfs"):
        got, it = eng.run(prog)
        want, want_it = res.run(prog)
        np.testing.assert_array_equal(got, want)
        assert it == want_it
    got, git = eng.run_batch("sssp", sources=[0, 3, 9, 40])
    want, wit = res.run_batch("sssp", sources=[0, 3, 9, 40])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(git, wit)
