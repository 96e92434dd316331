"""The tiled add's schedule (``push_fused.tile_plan``) against a numpy model.

The fixed-order tiled ``fused_push_add`` kernel takes the rows of a band
table whose segment ranges never decrease (``seg_sorted_rows``); its chunks
are ``TILE_CHUNK_BLOCKS`` consecutive edge blocks (``chunk_blocks``) and its
merge pass sums, per segment block, the chunks whose range holds it
(``tile_chunks``).  The property and the schedule are torch code that runs
here; these tests hold them to a plain numpy model, on the sd and basic
layouts of the conftest graphs (4 partitioners x C in {1, 2, 4, 8}) and on
drawn band tables (hub blocks split over many chunks, sparse tails wider
than a tile, empty blocks, unsorted rows).  ``tiled_add_model`` then runs
the schedule the way the kernels do, in numpy, and must give the plain sum.

The kernels themselves run on the card: ``tests/test_torch_cuda.py``.
"""

import gc
import pathlib
import re

import numpy as np
import pytest
import torch

from conftest import ALL_PARTITIONERS, DEGENERATE_GRAPHS, EQUIV_GRAPHS, graph
from repro.core import graph as RG
from repro_torch.core import graph as TG
from repro_torch.kernels import push_fused as PF
from repro_torch.kernels.blocks import BLOCK_E, BLOCK_S, edge_bands

GRAPHS = tuple(sorted(EQUIV_GRAPHS + ("rmat10",) + DEGENERATE_GRAPHS))
CHARES = (1, 2, 4, 8)
K = PF.TILE_CHUNK_BLOCKS
P = PF.TILE_PIECE_BLOCKS


def to_port(g):
    return TG.graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                   weight=g.weight, directed=g.directed)


def port_partition(gname, partitioner, chares):
    return TG.partition(to_port(graph(gname)), chares,
                        partitioner=partitioner)


# ---------------------------------------------------------------------------
# The numpy model
# ---------------------------------------------------------------------------


def model_sorted(band):
    """Row by row: every live block's seg lo is >= 0 and >= the seg hi of
    the live block before it."""
    out = []
    for row in band:
        live = np.flatnonzero(row[3] >= 0)
        ok = all(row[2, i] >= 0 for i in live)
        ok &= all(row[2, b] >= row[3, a] for a, b in zip(live, live[1:]))
        out.append(bool(ok))
    return np.array(out)


def model_chunks(band, rows):
    """(lo, hi) seg blocks of each chunk's live blocks; (0, -1) if none or
    the row is not tiled."""
    C, _, NB = band.shape
    NC = -(-NB // K)
    out = np.zeros((C, NC, 2), np.int64)
    out[..., 1] = -1
    for r in range(C):
        if not rows[r]:
            continue
        for c in range(NC):
            blk = band[r, :, c * K:(c + 1) * K]
            live = blk[3] >= 0
            if live.any():
                out[r, c] = blk[2][live].min(), blk[3][live].max()
    return out


def model_work(chunks):
    """The tile pass's CTAs: (flat chunk, first, last segment block) for
    each piece of at most P blocks of each live chunk's range, in order."""
    out = []
    for c, (lo, hi) in enumerate(chunks.reshape(-1, 2)):
        for plo in range(lo, hi + 1, P):
            out.append((c, plo, min(plo + P - 1, hi)))
    return np.array(out, np.int64).reshape(-1, 3)


def model_min_tiles(band, chunks, rows):
    """Whether the tiled min takes the table's tiled rows: they hold at
    least MIN_TILE_EDGES_PER_SEGMENT live edges (live blocks x BLOCK_E)
    per segment of their live chunks' summed ranges."""
    edges = sum(int((band[r, 3] >= 0).sum()) for r in range(len(rows))
                if rows[r]) * BLOCK_E
    span = sum(int(hi - lo + 1) for row in chunks for lo, hi in row
               if hi >= lo) * BLOCK_S
    return edges > 0 and edges >= span * PF.MIN_TILE_EDGES_PER_SEGMENT


def assert_emptied(part, band_np, rows):
    """``part`` is None unless ``rows`` splits the table; then the band
    with those rows' blocks emptied (src hi and seg hi -1)."""
    if not 0 < rows.sum() < len(rows):
        assert part is None
        return
    want = band_np.copy()
    want[rows, 1] = -1
    want[rows, 3] = -1
    np.testing.assert_array_equal(part.numpy().reshape(want.shape), want)


def model_touching(chunks, r, t):
    """The live chunks of row r whose range holds segment block t."""
    lo, hi = chunks[r, :, 0], chunks[r, :, 1]
    return set(np.flatnonzero((hi >= lo) & (lo <= t) & (t <= hi)).tolist())


def assert_schedule(band_np, band=None):
    """seg_sorted_rows, chunk_blocks and tile_chunks (through tile_plan)
    equal the model on one band table."""
    band = torch.from_numpy(band_np) if band is None else band
    rows = model_sorted(band_np)
    plan = PF.tile_plan(band)
    np.testing.assert_array_equal(PF.seg_sorted_rows(band).numpy(), rows)
    np.testing.assert_array_equal(plan.tiled.numpy(), rows)
    chunks = model_chunks(band_np, rows)
    np.testing.assert_array_equal(plan.chunk_blocks.numpy(), chunks)
    assert plan.work.dtype == torch.int32
    np.testing.assert_array_equal(plan.work.numpy(), model_work(chunks))
    assert plan.num_tiled == int(rows.sum())
    assert_emptied(plan.atomic_band, band_np, rows)
    assert plan.min_tiled is model_min_tiles(band_np, chunks, rows)
    assert plan.num_tiles == int(chunks[..., 1].max()) + 1
    tc = plan.tile_chunks.numpy()
    assert tc.shape == (band_np.shape[0], plan.num_tiles, 2)
    ends = {r * plan.num_tiles + int(x) for r in range(len(chunks))
            for lo, hi in chunks[r] if hi >= lo for x in (lo, hi)}
    assert plan.merge_tiles.dtype == torch.int32
    assert plan.merge_tiles.tolist() == sorted(ends)
    for r in range(band_np.shape[0]):
        for t in range(plan.num_tiles):
            want = model_touching(chunks, r, t)
            c0, c1 = tc[r, t]
            if not want:
                assert (c0, c1) == (0, -1), (r, t)
                continue
            # the range's ends touch t, and the live chunks inside it are
            # exactly the touching ones
            assert {c0, c1} <= want, (r, t)
            got = {c for c in range(c0, c1 + 1)
                   if chunks[r, c, 1] >= chunks[r, c, 0]}
            assert got == want, (r, t)
    return plan


def tiled_add_model(plan, src, dst, valid, vals, S):
    """The tiled kernels' data flow in numpy (int64 sums): per work item, the
    contributions of its chunk's edges into the item's piece of the chunk's
    range; segments of the chunk's first and last block to scratch slots 0
    and 1, the others straight to out; then per segment block, the scratch
    partials of the chunks tile_chunks names.  Rows off the tiled path are
    summed directly."""
    C, E = src.shape
    cb = plan.chunk_blocks.numpy()
    tc = plan.tile_chunks.numpy()
    tiled = plan.tiled.numpy()
    NC = cb.shape[1]
    out = np.zeros((C, S), np.int64)
    scratch = np.zeros((C, NC, 2, BLOCK_S), np.int64)
    for r in range(C):
        if not tiled[r]:
            keep = valid[r] != 0
            np.add.at(out[r], dst[r][keep], vals[r][src[r][keep]])
    for flat, plo, phi in plan.work.numpy():
        r, c = divmod(int(flat), NC)
        lo, hi = cb[r, c]
        assert tiled[r] and lo <= plo <= phi <= hi
        e = np.arange(c * K * BLOCK_E, min((c + 1) * K * BLOCK_E, E))
        e = e[valid[r, e] != 0]
        blk = dst[r, e] // BLOCK_S
        assert ((lo <= blk) & (blk <= hi)).all()  # the range holds them
        e = e[(plo <= blk) & (blk <= phi)]
        part = np.zeros(S, np.int64)
        np.add.at(part, dst[r, e], vals[r][src[r, e]])
        for s in np.flatnonzero(part):
            sb = s // BLOCK_S
            if sb == lo:
                scratch[r, c, 0, s % BLOCK_S] = part[s]
            elif sb == hi:
                scratch[r, c, 1, s % BLOCK_S] = part[s]
            else:
                out[r, s] += part[s]
    for r in range(C):
        if not tiled[r]:
            continue
        for t in range(tc.shape[1]):
            c0, c1 = tc[r, t]
            for c in range(c0, c1 + 1):
                lo, hi = cb[r, c]
                if hi < lo or t not in (lo, hi):
                    continue
                seg = slice(t * BLOCK_S, min((t + 1) * BLOCK_S, S))
                out[r, seg] += scratch[r, c, 0 if t == lo else 1,
                                       :seg.stop - seg.start]
    return out


def plain_sum(src, dst, valid, vals, S):
    out = np.zeros((src.shape[0], S), np.int64)
    for r in range(src.shape[0]):
        keep = valid[r] != 0
        np.add.at(out[r], dst[r][keep], vals[r][src[r][keep]])
    return out


# ---------------------------------------------------------------------------
# The layouts of the conftest graphs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_sd_rows_are_seg_sorted(gname, partitioner, chares):
    """Every row of the sd band table takes the tiled path: the layout's
    key (owner, seg block, src block) makes it so by construction."""
    tp = port_partition(gname, partitioner, chares)
    rows = PF.seg_sorted_rows(torch.from_numpy(tp.sd_band))
    assert rows.dtype == torch.bool and rows.shape == (chares,)
    assert bool(rows.all())
    assert model_sorted(tp.sd_band).all()


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_basic_rows_as_modelled(gname, partitioner, chares):
    """On the basic layout (source block outermost) the property is what
    the model computes, row by row, and so is the schedule."""
    tp = port_partition(gname, partitioner, chares)
    assert_schedule(tp.band)


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("partitioner", ALL_PARTITIONERS)
@pytest.mark.parametrize("gname", GRAPHS)
def test_sd_tile_chunks_cover_touching_chunks(gname, partitioner, chares):
    """On the sd layout every segment block's chunk range holds exactly the
    chunks whose band touches it, and the schedule reduces like the plain
    sum."""
    tp = port_partition(gname, partitioner, chares)
    plan = assert_schedule(tp.sd_band)
    assert plan.num_tiled == chares
    assert plan.atomic_band is None
    S = tp.num_chunks * tp.chunk_size
    vals = np.random.default_rng(1).integers(
        -1000, 1000, (chares, tp.chunk_size))
    args = (tp.sd_src_local, tp.sd_dst_global, tp.sd_edge_valid, vals, S)
    np.testing.assert_array_equal(tiled_add_model(plan, *args),
                                  plain_sum(*args))


def test_rmat_basic_layout_takes_the_atomic_path():
    """The basic layout of an RMAT graph at C=1 (eight source blocks) is
    not seg-sorted: its one row stays on the atomic kernel."""
    tp = TG.partition(TG.rmat(11, 14 << 11, seed=1), 1)
    plan = PF.tile_plan(torch.from_numpy(tp.band))
    assert plan.num_tiled == 0 and plan.num_tiles == 0
    assert PF.tile_plan(torch.from_numpy(tp.sd_band)).num_tiled == 1


# ---------------------------------------------------------------------------
# Drawn band tables
# ---------------------------------------------------------------------------


def sorted_row_edges(rng, E, S, hub_share, empty_blocks):
    """One seg-sorted edge row: destinations sorted by segment block (a hub
    block holds ``hub_share`` of the edges; the tail's sparse blocks make
    chunks wider than a tile), random order inside a block, some empty
    edge blocks."""
    nsb = -(-S // BLOCK_S)
    p = np.full(nsb, (1 - hub_share) / max(nsb - 1, 1))
    p[0] = hub_share if nsb > 1 else 1.0
    blk = np.sort(rng.choice(nsb, E, p=p / p.sum()))
    dst = blk * BLOCK_S + rng.integers(0, BLOCK_S, E)
    dst = np.minimum(dst, S - 1)
    valid = rng.integers(0, 4, E) > 0
    for b in empty_blocks:
        valid[b * BLOCK_E:(b + 1) * BLOCK_E] = False
    return dst.astype(np.int32), valid.astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_drawn_tables_match_the_model(seed):
    """Rows of every kind in one table: a hub block split over many chunks,
    a sparse tail whose chunks span many segment blocks, empty edge blocks
    (inside and at the end of a row), an unsorted row, an all-invalid
    row, a row with negative destinations."""
    rng = np.random.default_rng(seed)
    NB = int(rng.integers(1, 5)) * K + int(rng.integers(0, K))
    E, S, V = NB * BLOCK_E, int(rng.integers(300, 9000)), 700
    rows = []
    for kind in ("hub", "tail", "unsorted", "empty", "negative"):
        if kind in ("hub", "tail"):
            dst, valid = sorted_row_edges(
                rng, E, S, 0.6 if kind == "hub" else 0.0,
                rng.integers(0, NB, 3).tolist() + [NB - 1])
        elif kind == "unsorted":
            dst = rng.integers(0, S, E).astype(np.int32)
            valid = np.ones(E, np.int32)
        elif kind == "empty":
            dst, valid = np.zeros(E, np.int32), np.zeros(E, np.int32)
        else:
            dst, valid = sorted_row_edges(rng, E, S, 0.0, [])
            dst[5], valid[5] = -3, 1
        rows.append((dst, valid))
    order = rng.permutation(len(rows))
    dst = np.stack([rows[i][0] for i in order])
    valid = np.stack([rows[i][1] for i in order])
    src = rng.integers(0, V, dst.shape).astype(np.int32)
    band = edge_bands(src, dst, valid)
    assert band.shape == (len(rows), 4, NB)
    plan = assert_schedule(band)
    sorted_rows = plan.tiled.numpy()
    assert sorted_rows[list(order).index(0)]     # hub
    assert sorted_rows[list(order).index(1)]     # tail
    assert not sorted_rows[list(order).index(4)]  # negative destination
    # mixed table: the atomic kernel's band has the tiled rows emptied (src
    # hi and seg hi), the others as they were
    ab = plan.atomic_band.numpy()
    np.testing.assert_array_equal(ab[~sorted_rows], band[~sorted_rows])
    assert (ab[sorted_rows][:, [1, 3]] == -1).all()
    np.testing.assert_array_equal(ab[sorted_rows][:, [0, 2]],
                                  band[sorted_rows][:, [0, 2]])
    vals = rng.integers(-1000, 1000, (len(rows), V))
    keep = dst >= 0
    args = (src, np.where(keep, dst, 0), valid * keep, vals, S)
    np.testing.assert_array_equal(tiled_add_model(plan, *args),
                                  plain_sum(*args))


def test_hub_block_spans_many_chunks():
    """A segment block with many times a chunk's edges is split over
    consecutive chunks, all of which the merge pass sums for it."""
    NB = 5 * K
    dst = np.zeros(NB * BLOCK_E, np.int32) + 7  # every edge into block 0
    dst[-BLOCK_E:] = BLOCK_S + 3               # the last block into block 1
    valid = np.ones_like(dst)
    band = edge_bands(dst[None], dst[None], valid[None])
    plan = assert_schedule(band)
    assert plan.tile_chunks.numpy()[0].tolist() == [[0, 4], [4, 4]]
    assert plan.merge_tiles.tolist() == [0, 1]
    assert plan.chunk_blocks.numpy()[0].tolist() == [[0, 0]] * 4 + [[0, 1]]


def wide_chunk_row(rng):
    """Ten chunks each into one segment block, then one chunk spread over
    40 blocks and one over 6."""
    n = K * BLOCK_E
    parts = [b * BLOCK_S + rng.integers(0, BLOCK_S, n) for b in range(10)]
    parts.append(np.sort(rng.integers(10 * BLOCK_S, 50 * BLOCK_S, n)))
    parts.append(np.sort(rng.integers(50 * BLOCK_S, 56 * BLOCK_S, n)))
    return np.concatenate(parts).astype(np.int32)


def test_chunk_wider_than_a_tile():
    """A sparse chunk whose segment range spans many blocks: the blocks
    inside its range belong to it alone (no merge), its two ends merge."""
    dst = wide_chunk_row(np.random.default_rng(2))
    valid = np.ones_like(dst)
    band = edge_bands(dst[None], dst[None], valid[None])
    plan = assert_schedule(band)
    cb = plan.chunk_blocks.numpy()[0]
    assert cb[10].tolist() == [10, 49] and cb[11].tolist() == [50, 55]
    # the 40-block range is two CTAs' work, the 6-block one a single CTA's
    work = plan.work.numpy().tolist()
    assert [w for w in work if w[0] == 10] == [[10, 10, 10 + P - 1],
                                               [10, 10 + P, 49]]
    assert [w for w in work if w[0] == 11] == [[11, 50, 55]]
    lo, hi = cb[10]
    tc = plan.tile_chunks.numpy()[0]
    assert (tc[lo + 1:hi] == [10, 10]).all()
    vals = np.random.default_rng(3).integers(-99, 99, (1, 700))
    src = np.random.default_rng(4).integers(0, 700, dst.shape)[None]
    args = (src, dst[None], valid[None], vals, 56 * BLOCK_S)
    np.testing.assert_array_equal(tiled_add_model(plan, *args),
                                  plain_sum(*args))


def test_sparse_table_schedule():
    """A near-uniform graph at 8 chares spreads each row's edges over all
    segments, so most chunks span many segment blocks; the schedule still
    reduces like the plain sum."""
    tp = TG.partition(TG.erdos_renyi(1 << 14, 1 << 15, seed=1), 8)
    plan = assert_schedule(tp.sd_band)
    cb = plan.chunk_blocks.numpy()
    span = cb[..., 1] - cb[..., 0] + 1
    assert (span > 8).sum() > (span > 0).sum() / 2
    S = tp.num_chunks * tp.chunk_size
    vals = np.random.default_rng(1).integers(-9, 9, (8, tp.chunk_size))
    args = (tp.sd_src_local, tp.sd_dst_global, tp.sd_edge_valid, vals, S)
    np.testing.assert_array_equal(tiled_add_model(plan, *args),
                                  plain_sum(*args))


def test_one_row_band_and_empty_table():
    """A one-row ``[4, NB]`` band is planned as one row; an all-empty table
    has no tiles and no work."""
    dst = np.arange(3 * BLOCK_E, dtype=np.int32) // 3
    one = edge_bands(dst[None], dst[None], np.ones_like(dst)[None])[0]
    plan = assert_schedule(one[None], torch.from_numpy(one))
    assert plan.chunk_blocks.shape == (1, 1, 2)
    empty = np.zeros((2, 4, 3), np.int32)
    empty[:, [1, 3]] = -1
    plan = PF.tile_plan(torch.from_numpy(empty))
    assert plan.num_tiled == 2 and plan.num_tiles == 0
    assert plan.tile_chunks.shape == (2, 0, 2)
    assert plan.work.shape == (0, 3)


def test_tile_plan_is_cached_per_table():
    """One plan per band table while the table lives; a new table (even
    with equal contents) gets its own, and a freed table's entry goes."""
    band = torch.from_numpy(port_partition("rmat10", "contiguous", 2).sd_band)
    plan = PF.tile_plan(band)
    assert PF.tile_plan(band) is plan
    other = band.clone()
    assert PF.tile_plan(other) is not plan
    n = len(PF._plans)
    del other
    gc.collect()
    assert len(PF._plans) == n - 1


def test_cpu_uploads_learn_no_plan():
    """Only CUDA uploads learn the add path at upload (the CPU path runs
    the plain version, which needs none)."""
    tp = port_partition("rmat6", "contiguous", 2)
    before = len(PF._plans)
    arrs = tp.device_arrays("sd", device="cpu")
    assert len(PF._plans) == before
    assert PF.tile_plan(arrs["sd_band"]).num_tiled == 2


def test_reference_sd_layout_is_seg_sorted_too():
    """The reference's own sd band table has the property the port's tiled
    path relies on (the port's layouts equal the reference's)."""
    for chares in CHARES:
        rp = RG.partition(graph("rmat10"), chares)
        assert model_sorted(np.asarray(rp.sd_band)).all()


def test_chunk_length_matches_the_kernels_constant():
    """The schedule's chunk length mirrors kChunkBlocks, which the tile pass
    compiles in; the launch also refuses a plan whose chunk count differs."""
    src = (pathlib.Path(PF.__file__).parent / "csrc" / "push_fused.cu") \
        .read_text()
    m = re.search(r"constexpr int kChunkBlocks = (\d+);", src)
    assert m and int(m.group(1)) == K


@pytest.mark.parametrize("chares", CHARES)
@pytest.mark.parametrize("seed", range(3))
def test_wide_ranges_split_into_pieces(seed, chares):
    """On a sparse sd layout the work list splits every chunk range wider
    than P segment blocks into pieces of at most P blocks, in order and
    without gaps, and gives every other live chunk one CTA."""
    tp = TG.partition(TG.erdos_renyi(1 << 15, 1 << 16, seed=seed), chares)
    plan = PF.tile_plan(torch.from_numpy(tp.sd_band))
    cb = plan.chunk_blocks.numpy().reshape(-1, 2)
    work = plan.work.numpy()
    assert (np.diff(work[:, 0]) >= 0).all()
    assert (work[:, 2] - work[:, 1] < P).all()
    live = np.flatnonzero(cb[:, 1] >= cb[:, 0])
    assert np.array_equal(np.unique(work[:, 0]), live)
    for c in live:
        mine = work[work[:, 0] == c]
        assert mine[0, 1] == cb[c, 0] and mine[-1, 2] == cb[c, 1]
        assert (mine[1:, 1] == mine[:-1, 2] + 1).all()
    if chares == 8:
        assert len(work) > len(live)  # some range is wider than P


@pytest.mark.parametrize("threshold", ["port", 0.0, 1.0, 2.0,
                                       float("inf")])
def test_min_tiles_follow_the_density_rule(threshold, monkeypatch):
    """The tiled min takes a table's seg-sorted rows when they hold at
    least MIN_TILE_EDGES_PER_SEGMENT edges per segment of their chunks'
    ranges, as the model says: a near-uniform table at 8 chares (0.25 per
    segment), RMAT tables at 8 chares (1.6, its sparsest row 0.2) and at
    one (7.4).  With the port's own threshold the near-uniform table goes
    to the atomic kernel and the RMAT ones tile, every row."""
    if threshold != "port":
        monkeypatch.setattr(PF, "MIN_TILE_EDGES_PER_SEGMENT", threshold)
    tables = {
        "er": TG.partition(TG.erdos_renyi(1 << 14, 1 << 15, seed=1), 8),
        "rmat/8": TG.partition(TG.rmat(12, 14 << 12, seed=1), 8),
        "rmat/1": TG.partition(TG.rmat(12, 14 << 12, seed=1), 1),
    }
    for name, tp in tables.items():
        plan = assert_schedule(tp.sd_band)
        assert plan.num_tiled == plan.tiled.numel()
        want = {"port": name != "er", 0.0: True, 1.0: name != "er",
                2.0: name == "rmat/1", float("inf"): False}[threshold]
        assert plan.min_tiled is want, name
