"""Fused push: gather, edge-value transform and segment combine in one launch.

The twin of ``repro/kernels/push_fused.py``'s ``fused_push``: same operands,
same output dtypes, same ``init=`` seed and trailing ``[B]`` plane.  On a
CUDA tensor it launches the hand-written Hopper kernels in
``csrc/push_fused.cu`` (which replace the TPU's ``_fused_push_add_kernel``
and ``_fused_push_min_kernel``; the source says what bounds them and how the
design answers it).  On a CPU tensor it runs ``fused_push_plain``, the plain
torch version of the same function, which is also what the kernels are
checked against on the card.

Each monoid has two paths, chosen per layout row by a property of the band
table: a row whose band segment ranges never decrease (``seg_sorted_rows``;
every row of the sd layout) takes the tiled kernels -- for add the
fixed-order tile pass and its merge pass, for min one tile pass where the
table has edges enough per segment (``min_tiles``) -- any other row the
atomic kernel.  ``tile_plan`` learns the property and the tiled paths'
chunk schedule once per band table (the engine's layouts at upload) and
caches them, so the superstep loop never waits on the host for them.

Edge operands are either one layout row (``src``/``dst``/``valid``/``weight``
``[E]``, ``band`` ``[4, E/BLOCK_E]``, ``vals`` ``[V(, B)]`` -> ``[S(, B)]``)
or all chare rows at once (``[C, E]``, ``[C, 4, E/BLOCK_E]``, ``[C, V(, B)]``
-> ``[C, S(, B)]``, row r gathering from ``vals[r]`` into ``out[r]``), so
one launch serves every chare of a superstep.

A rowed call may gate rows (``row_active``, ``[C]`` int32 on the card's
device, 0 for a gated row; ``None``: every row active): a gated row's
output is its ``init`` row, or the identity where no ``init`` is given, and
its kernel work returns before it reads any edge or value -- the frontier
gate's per-row twin of the reference engine's per-shard skip
(``strategies.phase1_identity``).  An active row's output is that of the
call without the gate.  A gated launch counts as a launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from repro_torch.kernels.blocks import BLOCK_E, BLOCK_S

SENTINEL = 2147483647
# float(SENTINEL) in float32: the value JAX compares and fills float min with
SENTINEL_F32 = float(np.float32(SENTINEL))

# edge blocks per chunk of the tiled add (one CTA of the tile pass): the
# schedule's mirror of kChunkBlocks, a compile-time constant of
# csrc/push_fused.cu (a test holds the two equal)
TILE_CHUNK_BLOCKS = 16
# segment blocks of a chunk's range that one CTA of the tile pass takes at
# most: a wider range (a sparse chunk) is split into pieces of this many
# (``work_items``); the sums do not depend on it
TILE_PIECE_BLOCKS = 32
# edges per segment of their chunks' ranges that a table's seg-sorted rows
# need for the tiled min (``min_tiles``); sparser ones take the atomic
# kernel
MIN_TILE_EDGES_PER_SEGMENT = 0.5

# launches of each CUDA push kernel since the last reset (CPU calls do not
# count): the fused pair here (``fused_push_add``/``fused_push_min`` once
# per call that launches, and each monoid's path in its own keys: the tiled
# kernel -- for add with its merge pass -- or the atomic kernel), the
# staged four in push_staged
launch_counts = {"fused_push_add": 0, "fused_push_min": 0,
                 "fused_push_add_tiled": 0, "fused_push_add_merge": 0,
                 "fused_push_add_atomic": 0,
                 "fused_push_min_tiled": 0, "fused_push_min_atomic": 0,
                 "gather_sum": 0, "scatter_sum": 0,
                 "gather_min": 0, "scatter_min": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# The tiled paths' schedule: which rows take them, and how their chunks and
# segment blocks meet.  Torch ops on the band's device; the CPU tests hold
# them to a numpy model.
# ---------------------------------------------------------------------------


def _rowed(band):
    return band if band.dim() == 3 else band[None]


def seg_sorted_rows(band):
    """``[C]`` bool: the rows whose live edge blocks (``band hi >= 0``) have
    non-negative segment ranges that never decrease along the row, i.e.
    ``band[2, i] >= band[3, j]`` for consecutive live blocks ``j < i``.
    ``band`` is ``[C, 4, NB]`` or one row's ``[4, NB]``."""
    band = _rowed(band)
    lo, hi = band[:, 2].long(), band[:, 3].long()
    live = hi >= 0
    seen = torch.cummax(torch.where(live, hi, -1), dim=1).values
    before = torch.cat([torch.full_like(seen[:, :1], -1), seen[:, :-1]],
                       dim=1)  # the largest hi of the blocks before
    return (~live | ((lo >= before) & (lo >= 0))).all(dim=1)


def chunk_blocks(band, rows):
    """``[C, NC, 2]`` int32: the first and last segment block that the live
    edge blocks of each chunk (``TILE_CHUNK_BLOCKS`` consecutive edge blocks,
    ``NC = ceil(NB / TILE_CHUNK_BLOCKS)``) touch, on the rows where ``rows``
    (``[C]`` bool) is set; ``(0, -1)`` for an empty chunk and for every
    chunk of the other rows."""
    band = _rowed(band)
    C, _, NB = band.shape
    K = TILE_CHUNK_BLOCKS
    NC = -(-NB // K)
    pad = NC * K - NB
    lo = torch.nn.functional.pad(band[:, 2].long(), (0, pad), value=0)
    hi = torch.nn.functional.pad(band[:, 3].long(), (0, pad), value=-1)
    big = torch.iinfo(torch.int64).max
    clo = torch.where(hi >= 0, lo, big).reshape(C, NC, K).amin(dim=-1)
    chi = hi.reshape(C, NC, K).amax(dim=-1)
    empty = (chi < 0) | ~rows[:, None]
    return torch.stack([torch.where(empty, 0, clo),
                        torch.where(empty, -1, chi)], dim=-1).to(torch.int32)


def tile_chunks(chunks, num_tiles):
    """``[C, NT, 2]`` int32: for each segment block ``t < num_tiles``, the
    first and last chunk whose range ``chunks[c] = (lo, hi)`` holds ``t``;
    ``(0, -1)`` where none does.  The ranges of a seg-sorted row never
    decrease, so the chunks holding ``t`` are consecutive (empty chunks may
    lie among them)."""
    lo, hi = chunks[..., 0].long(), chunks[..., 1].long()
    live = hi >= lo
    big = torch.iinfo(torch.int64).max
    # empty chunks take their neighbours' bounds, so both stay sorted
    hi_f = torch.cummax(torch.where(live, hi, -1), dim=1).values
    lo_f = torch.cummin(torch.where(live, lo, big).flip(1), dim=1).values \
        .flip(1)
    t = torch.arange(num_tiles, device=chunks.device).expand(
        chunks.shape[0], num_tiles).contiguous()
    c0 = torch.searchsorted(hi_f.contiguous(), t)  # first with hi >= t
    c1 = torch.searchsorted(lo_f.contiguous(), t, right=True) - 1
    none = c1 < c0
    return torch.stack([torch.where(none, 0, c0),
                        torch.where(none, -1, c1)], dim=-1).to(torch.int32)


def merge_tiles(chunks, num_tiles):
    """int32 ``[M]``, ascending: the flat indices ``r * num_tiles + t`` of
    the segment blocks in which some chunk's range starts or ends -- the
    blocks whose chunk partials the tile pass leaves in scratch, and so the
    merge pass's work list."""
    lo, hi = chunks[..., 0].long(), chunks[..., 1].long()
    live = hi >= lo
    base = torch.arange(chunks.shape[0], device=chunks.device)[:, None] \
        * num_tiles
    ends = torch.cat([(base + lo)[live], (base + hi)[live]])
    return torch.unique(ends).to(torch.int32)


def work_items(chunks):
    """``[NW, 3]`` int32, the tile pass's CTAs: for each live chunk
    (``chunks`` ``[C, NC, 2]`` from ``chunk_blocks``), in order, its flat
    index ``r * NC + c`` and the first and last segment block of each piece
    of at most ``TILE_PIECE_BLOCKS`` blocks that its range splits into."""
    flat = chunks.reshape(-1, 2).long()
    lo, hi = flat[:, 0], flat[:, 1]
    P = TILE_PIECE_BLOCKS
    pieces = torch.where(hi >= lo, (hi - lo) // P + 1, 0)
    chunk = torch.repeat_interleave(
        torch.arange(flat.shape[0], device=chunks.device), pieces)
    before = torch.cumsum(pieces, 0) - pieces  # pieces of earlier chunks
    k = torch.arange(chunk.numel(), device=chunks.device) - before[chunk]
    plo = lo[chunk] + k * P
    phi = torch.minimum(plo + P - 1, hi[chunk])
    return torch.stack([chunk, plo, phi], dim=1).to(torch.int32)


def min_tiles(band, chunks, rows) -> bool:
    """Whether the tiled min takes a table's seg-sorted rows (``rows``,
    with ``chunks`` from ``chunk_blocks``): when they hold at least
    ``MIN_TILE_EDGES_PER_SEGMENT`` edges per segment of their chunks'
    summed ranges (live edge blocks x BLOCK_E against the ranges x
    BLOCK_S).  The tile pays where segments take several contributions
    each, saving the global atomics they share; where they take about one
    (0.25 edges per segment on the ER staged-choice layout) it saves none
    and the atomic kernel was faster.  The whole table goes one way: a
    table split over both kernels was slower than either alone
    (``scripts/torch_min_rule_sweep.py`` times the four choices)."""
    band = _rowed(band)
    edges = int(((band[:, 3] >= 0) & rows[:, None]).sum()) * BLOCK_E
    lo, hi = chunks[..., 0].long(), chunks[..., 1].long()
    span = int(torch.where(hi >= lo, hi - lo + 1, 0).sum()) * BLOCK_S
    return edges > 0 and edges >= span * MIN_TILE_EDGES_PER_SEGMENT


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The path of each row of one band table, with the tiled paths'
    schedule (``tile_plan``; the tiled min reads ``work`` only)."""

    tiled: torch.Tensor         # [C] bool: the row takes the tiled path
    chunk_blocks: torch.Tensor  # [C, NC, 2] int32 (``chunk_blocks``)
    tile_chunks: torch.Tensor   # [C, NT, 2] int32 (``tile_chunks``)
    merge_tiles: torch.Tensor   # [M] int32 (``merge_tiles``)
    work: torch.Tensor          # [NW, 3] int32 (``work_items``)
    # for a table with rows on both paths, the band with the tiled rows'
    # blocks emptied, for the atomic kernel over the others; else None
    atomic_band: torch.Tensor | None
    num_tiled: int              # rows on the tiled path
    num_tiles: int              # NT: one past the last segment block used
    min_tiled: bool             # the min tiles the tiled rows too


_plans: dict = {}  # id(band) -> (weak reference to band, its TilePlan)


def tile_plan(band) -> TilePlan:
    """The path and schedule for a band table, computed on first use
    and cached for as long as the table lives.  Computing it reads a few
    numbers back to the host, so the engine's layouts learn theirs at
    upload (``PartitionedGraph.device_arrays``), before any superstep."""
    key = id(band)
    hit = _plans.get(key)
    if hit is not None and hit[0]() is band:
        return hit[1]
    rowed = _rowed(band)
    tiled = seg_sorted_rows(rowed)
    cb = chunk_blocks(rowed, tiled)
    num_tiled = int(tiled.sum())
    num_tiles = int(cb[..., 1].max()) + 1 if cb.numel() else 0
    atomic_band = None
    if 0 < num_tiled < rowed.shape[0]:
        atomic_band = rowed.clone()
        atomic_band[:, 1][tiled] = -1  # src hi: the atomic kernel's skip
        atomic_band[:, 3][tiled] = -1
        atomic_band = atomic_band.reshape(band.shape)
    plan = TilePlan(tiled, cb, tile_chunks(cb, num_tiles),
                    merge_tiles(cb, num_tiles), work_items(cb), atomic_band,
                    num_tiled, num_tiles, min_tiles(rowed, cb, tiled))
    _plans[key] = (weakref.ref(band, lambda _, k=key: _plans.pop(k, None)),
                   plan)
    return plan


def output_dtype(vals_dtype: torch.dtype, combine: str) -> torch.dtype:
    """Accumulator/output dtype: ``vals``' for min and for integer add,
    at least float32 for float add."""
    if combine == "add" and vals_dtype.is_floating_point:
        return torch.promote_types(vals_dtype, torch.float32)
    return vals_dtype


def _weight_mode(weight, unit_weight, combine) -> str:
    if unit_weight and weight is not None:
        raise ValueError("unit_weight replaces the weight operand")
    mode = "array" if weight is not None else ("unit" if unit_weight
                                               else "none")
    if combine == "add" and mode == "unit":
        mode = "none"  # multiplying by 1 is the identity
    return mode


def fused_push(band, src, dst, valid, weight, vals, num_segments, *,
               combine="add", unit_weight=False, init=None, row_active=None):
    """Fused push over pre-padded inputs: one kernel launch (for add on
    seg-sorted rows, the tile pass and its merge pass; on a table with rows
    on both paths, the atomic kernel besides).

    Shapes: edges padded to BLOCK_E (``band`` from ``blocks.edge_bands``);
    ``num_segments`` the output length S.  ``weight=None`` skips the
    edge-value transform; ``unit_weight`` applies it with a compile-time
    constant 1 and no weight operand.  The transform is ``c * w`` for add and
    the saturating ``c + min(w, SENTINEL - c)`` (ints) or ``c + w`` (floats)
    for min; float min values above ``float(SENTINEL)`` count as unreached.
    ``init`` (optional, the output's shape and dtype) seeds the accumulator
    in place of the combiner identity (0, or SENTINEL for min).  On CUDA,
    each row takes the kernel its band gives it (``tile_plan``, cached per
    band tensor); the tiled paths need every valid destination below
    ``num_segments``.  ``row_active`` gates chare rows (module docstring).
    """
    return _fused_push(band, src, dst, valid, weight, vals, num_segments,
                       combine, unit_weight, init, row_active, atomic=False)


def fused_push_atomic(band, src, dst, valid, weight, vals, num_segments, *,
                      combine="add", unit_weight=False, init=None,
                      row_active=None):
    """``fused_push`` with every row on the atomic kernel: no tile plan,
    so no host sync, and float add in no fixed order.  For a band table
    made for one call (``ops.push`` without a layout's band), whose plan
    would be computed and read back on every call, and to time the tiled
    paths against the kernel they replace."""
    return _fused_push(band, src, dst, valid, weight, vals, num_segments,
                       combine, unit_weight, init, row_active, atomic=True)


def check_row_active(row_active, src, device):
    """Refuse a row gate on a row-less (1-D) call, or one that is not
    ``[C]`` int32 on ``device``."""
    if row_active is None:
        return
    if src.dim() != 2:
        raise ValueError("row_active gates chare rows; a 1-D (row-less) "
                         "call has none")
    _check(row_active, "row_active", torch.int32, (src.shape[0],), device)


def _fused_push(band, src, dst, valid, weight, vals, num_segments, combine,
                unit_weight, init, row_active, atomic):
    if combine not in ("add", "min"):
        raise ValueError(f"unknown combine {combine!r}")
    mode = _weight_mode(weight, unit_weight, combine)
    out_dtype = output_dtype(vals.dtype, combine)
    rowed = src.dim() == 2
    shape = ((src.shape[0],) if rowed else ()) + (num_segments,) \
        + tuple(vals.shape[2 if rowed else 1:])
    if init is not None and (tuple(init.shape) != shape
                             or init.dtype != out_dtype):
        raise ValueError(f"init {tuple(init.shape)}/{init.dtype} must match "
                         f"the output {shape}/{out_dtype}")
    if src.shape[-1] % BLOCK_E:
        raise ValueError(f"edge count {src.shape[-1]} is not padded to "
                         f"BLOCK_E={BLOCK_E}")
    check_row_active(row_active, src, vals.device)
    if vals.is_cuda:
        return _launch(band, src, dst, valid, weight, vals, shape, combine,
                       mode, out_dtype, init, row_active, atomic)
    if vals.device.type != "cpu":
        raise ValueError(f"fused_push runs on CUDA or CPU tensors, not on "
                         f"{vals.device}")
    return fused_push_plain(band, src, dst, valid, weight, vals, num_segments,
                            combine=combine, unit_weight=unit_weight,
                            init=init, row_active=row_active)


def _identity(combine, dtype):
    if combine == "add":
        return 0
    return SENTINEL_F32 if dtype.is_floating_point else SENTINEL


def fused_push_plain(band, src, dst, valid, weight, vals, num_segments, *,
                     combine="add", unit_weight=False, init=None,
                     row_active=None):
    """Plain torch version of ``fused_push`` (same arguments, same result;
    float add up to summation order).  ``band`` is not read: it only lets
    the kernel skip empty edge blocks.  A gated row's edges are dropped, so
    its output row is its ``init`` row or the identity."""
    check_row_active(row_active, src, vals.device)
    mode = _weight_mode(weight, unit_weight, combine)
    out_dtype = output_dtype(vals.dtype, combine)
    rowed = src.dim() == 2
    if not rowed:
        src, dst, valid = src[None], dst[None], valid[None]
        weight = None if weight is None else weight[None]
        vals = vals[None]
        init = None if init is None else init[None]
    C, E = src.shape
    V = vals.shape[1]
    tail = tuple(vals.shape[2:])
    dev = vals.device
    row = torch.arange(C, device=dev, dtype=torch.int64)[:, None]
    live = valid != 0
    if row_active is not None:
        live = live & (row_active != 0)[:, None]
    keep = live.reshape(-1)
    gidx = (src.long() + row * V).reshape(-1)[keep]
    sidx = (dst.long() + row * num_segments).reshape(-1)[keep]
    c = vals.to(out_dtype).reshape((C * V,) + tail).index_select(0, gidx)
    if combine == "min" and out_dtype.is_floating_point:
        c = torch.clamp(c, max=SENTINEL_F32)
    if mode != "none":
        w = (torch.ones(gidx.shape[0], dtype=out_dtype, device=dev)
             if mode == "unit" else weight.reshape(-1)[keep].to(out_dtype))
        w = w.reshape(w.shape + (1,) * len(tail))
        if combine == "add":
            c = c * w
        elif out_dtype.is_floating_point:
            c = c + w
        else:
            c = c + torch.minimum(w, SENTINEL - c)  # saturate, never wrap
    if init is None:
        out = torch.full((C * num_segments,) + tail,
                         _identity(combine, out_dtype), dtype=out_dtype,
                         device=dev)
    else:
        out = init.reshape((C * num_segments,) + tail).clone()
    if combine == "add":
        out.index_add_(0, sidx, c)
    else:
        idx = sidx.reshape(sidx.shape + (1,) * len(tail)).expand_as(c)
        out.scatter_reduce_(0, idx, c, reduce="amin", include_self=True)
    out = out.reshape((C, num_segments) + tail)
    return out if rowed else out[0]


_CODES = {"none": 0, "array": 1, "unit": 2}
_lib = None


def _library():
    """The built kernel library, with its C signature declared."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("push_fused")
        f = lib.fused_push_launch
        f.restype = ctypes.c_int
        f.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
                      + [ctypes.c_longlong] * 5 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p] * 2)
        t = lib.fused_push_add_tiled_launch
        t.restype = ctypes.c_int
        t.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 12
                      + [ctypes.c_longlong] * 9 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
        m = lib.fused_push_min_tiled_launch
        m.restype = ctypes.c_int
        m.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                      + [ctypes.c_longlong] * 7 + [ctypes.c_int] * 2
                      + [ctypes.c_void_p] * 2)
        _lib = lib
    return _lib


def _check(t, name, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, vals on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _aligned(t):
    """``t``, or a copy of it on a 16-byte boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _min_cap(out_dtype, init):
    """The order key (``order_key`` in csrc/atomics.cuh) at and above
    which a min contribution cannot lower ``out``: the identity's where out
    holds nothing above it -- an int out always, a float out filled with the
    identity -- and above every float's where a float ``init`` may hold
    more (int32 max, the key of no number)."""
    if not out_dtype.is_floating_point:
        return SENTINEL
    if init is None:
        return int(np.array(SENTINEL_F32, np.float32).view(np.int32))
    return SENTINEL


def _launch(band, src, dst, valid, weight, vals, shape, combine, mode,
            out_dtype, init, row_active, atomic):
    """Check the operands and launch the CUDA kernels on the current stream:
    the tiled kernels over the seg-sorted rows (for add the tile pass and
    its merge pass, for min one pass) and the atomic kernel over the others
    (over every row if ``atomic``)."""
    if out_dtype not in (torch.float32, torch.int32):
        raise TypeError(f"the CUDA push kernels take float32 or int32 "
                        f"values; {combine} over {vals.dtype} gives "
                        f"{out_dtype}")
    rowed = src.dim() == 2
    C = src.shape[0] if rowed else 1
    E = src.shape[-1]
    NB = E // BLOCK_E
    V = vals.shape[1 if rowed else 0]
    S = shape[1 if rowed else 0]
    B = int(np.prod(vals.shape[2 if rowed else 1:], dtype=np.int64))
    dev = vals.device
    vals = vals.to(out_dtype).contiguous()
    if rowed and vals.shape[0] != C:
        raise ValueError(f"vals has {vals.shape[0]} rows, edges {C}")
    edge_shape = (C, E) if rowed else (E,)
    for name, t in (("src", src), ("dst", dst), ("valid", valid)):
        _check(t, name, torch.int32, edge_shape, dev)
    _check(band, "band", torch.int32, ((C,) if rowed else ()) + (4, NB), dev)
    if mode == "array":
        weight = weight.to(out_dtype).contiguous()
        _check(weight, "weight", out_dtype, edge_shape, dev)
    if init is None:
        out = torch.full(shape, _identity(combine, out_dtype),
                         dtype=out_dtype, device=dev)
    else:
        _check(init, "init", out_dtype, shape, dev)
        out = init.clone()
    if C * NB == 0:
        return out
    plan = None
    if not atomic:
        plan = tile_plan(band)
        if plan.num_tiles > -(-S // BLOCK_S):
            raise ValueError(f"a valid destination lies past num_segments="
                             f"{S}")
    cap = _min_cap(out_dtype, init) if combine == "min" else 0
    is_float = int(out_dtype.is_floating_point)
    gate = None if row_active is None else row_active.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _library()
    if plan is not None and (combine == "add" or plan.min_tiled):
        work = plan.work
        atomic_band = band if plan.num_tiled == 0 else plan.atomic_band
    else:
        work, atomic_band = None, band
    launched = False  # a tiled table with no live chunk launches nothing
    if atomic_band is not None:
        err = lib.fused_push_launch(
            0 if combine == "add" else 1, is_float, _CODES[mode],
            atomic_band.data_ptr(), src.data_ptr(), dst.data_ptr(),
            valid.data_ptr(), weight.data_ptr() if mode == "array" else None,
            vals.data_ptr(), out.data_ptr(), C, E, NB, V, S, B, cap, gate,
            stream)
        if err != 0:
            raise RuntimeError(f"fused_push_{combine} kernel launch failed: "
                               f"cudaError {err}")
        launched = True
        launch_counts[f"fused_push_{combine}_atomic"] += 1
    if work is not None and work.shape[0]:
        # the tiled kernels read the edge planes 16 bytes at a time
        src, dst, valid = (_aligned(t) for t in (src, dst, valid))
        if mode == "array":
            weight = _aligned(weight)
        wptr = weight.data_ptr() if mode == "array" else None
        if combine == "min":
            err = lib.fused_push_min_tiled_launch(
                is_float, _CODES[mode], band.data_ptr(), src.data_ptr(),
                dst.data_ptr(), valid.data_ptr(), wptr, vals.data_ptr(),
                out.data_ptr(), work.data_ptr(), C, E, NB,
                plan.chunk_blocks.shape[1], V, S, work.shape[0], B, cap, gate,
                stream)
        else:
            scratch = torch.empty(
                (C, plan.chunk_blocks.shape[1], 2, BLOCK_S, B),
                dtype=out_dtype, device=dev)
            err = lib.fused_push_add_tiled_launch(
                is_float, _CODES[mode], band.data_ptr(), src.data_ptr(),
                dst.data_ptr(), valid.data_ptr(), wptr, vals.data_ptr(),
                out.data_ptr(), plan.chunk_blocks.data_ptr(),
                plan.tile_chunks.data_ptr(), plan.merge_tiles.data_ptr(),
                plan.work.data_ptr(), scratch.data_ptr(), C, E, NB,
                plan.chunk_blocks.shape[1], V, S, plan.num_tiles,
                plan.merge_tiles.numel(), plan.work.shape[0], B, gate,
                stream)
        if err != 0:
            raise RuntimeError(f"tiled fused_push_{combine} kernel launch "
                               f"failed: cudaError {err}")
        launched = True
        launch_counts[f"fused_push_{combine}_tiled"] += 1
        if combine == "add" and plan.merge_tiles.numel():
            launch_counts["fused_push_add_merge"] += 1
    if launched:
        launch_counts[f"fused_push_{combine}"] += 1
    return out
