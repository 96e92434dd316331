"""Staged push: the gather half and the scatter half as two launches.

The twins of ``repro/kernels/push_sum.py``'s ``gather_sum``/``scatter_sum``
and ``repro/kernels/push_min.py``'s ``gather_min``/``scatter_min``: same
functions, same output dtypes.  On a CUDA tensor each launches its
hand-written Hopper kernel in ``csrc/push_staged.cu`` (the source says what
bounds it and how the design answers it); on a CPU tensor it runs its plain
torch version (``*_plain``), which is also what the kernels are checked
against on the card.  Any other device raises.

Operands are one layout row (``src``/``valid``/``dst`` ``[E]``, ``vals``
``[V(, B)]``, ``c`` ``[E(, B)]``, out ``[S(, B)]``) or every chare row at
once (``[C, E]``, ``[C, V(, B)]``, ``[C, E(, B)]``, ``[C, S(, B)]``; row r
gathers from ``vals[r]`` and scatters into ``out[r]``), so one launch serves
every chare of a superstep.  No padding is needed.  A source outside
``[0, V)`` gathers the identity and a destination outside ``[0, S)`` is
dropped, as the TPU kernels' one-hot tiles treat them.  A rowed call may
gate rows (``row_active``, as ``push_fused`` takes it): the gather writes
the identity over a gated row and reads nothing of it, the scatter leaves
its output row at the identity.

Dtypes: ``gather_sum`` keeps ints and widens floats to at least float32;
``gather_min`` keeps the dtype; the scatters give ``c``'s dtype.  The min
identity is the int32 sentinel; float min reads values at or above
``float(SENTINEL)`` as unreached and returns them as ``float(SENTINEL)``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.push_fused import (SENTINEL, SENTINEL_F32, _check,
                                            check_row_active, launch_counts)


def gather_sum_dtype(vals_dtype: torch.dtype) -> torch.dtype:
    """``gather_sum``'s output dtype: ints stay ints (a float32 cast rounds
    sums above 2^24), floats widen to at least float32."""
    if vals_dtype.is_floating_point:
        return torch.promote_types(vals_dtype, torch.float32)
    return vals_dtype


def _min_identity(dtype):
    return SENTINEL_F32 if dtype.is_floating_point else SENTINEL


def _tail(x, rowed):
    return tuple(x.shape[2 if rowed else 1:])


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------


def _gather_plain(src, valid, vals, out_dtype, fill, clamp, row_active):
    check_row_active(row_active, src, vals.device)
    rowed = src.dim() == 2
    if not rowed:
        src, valid, vals = src[None], valid[None], vals[None]
    C, E = src.shape
    V = vals.shape[1]
    tail = _tail(vals, True)
    s = src.long()
    keep = (valid != 0) & (s >= 0) & (s < V)
    if row_active is not None:
        keep = keep & (row_active != 0)[:, None]
    row = torch.arange(C, device=src.device, dtype=torch.int64)[:, None]
    idx = (torch.where(keep, s, 0) + row * V).reshape(-1)
    c = vals.to(out_dtype).reshape((C * V,) + tail).index_select(0, idx)
    if clamp:
        c = torch.clamp(c, max=SENTINEL_F32)
    keep = keep.reshape((C * E,) + (1,) * len(tail))
    c = torch.where(keep, c, torch.full((), fill, dtype=out_dtype,
                                        device=c.device))
    c = c.reshape((C, E) + tail)
    return c if rowed else c[0]


def gather_sum_plain(src, valid, vals, row_active=None):
    """Plain torch ``gather_sum``: ``vals[src]`` where valid, else 0."""
    return _gather_plain(src, valid, vals, gather_sum_dtype(vals.dtype), 0,
                         False, row_active)


def gather_min_plain(src, valid, vals, row_active=None):
    """Plain torch ``gather_min``: ``vals[src]`` where valid, else the
    sentinel; float values clamped to ``float(SENTINEL)``."""
    return _gather_plain(src, valid, vals, vals.dtype,
                         _min_identity(vals.dtype),
                         vals.dtype.is_floating_point, row_active)


def _scatter_plain(dst, c, num_segments, combine, row_active):
    check_row_active(row_active, dst, c.device)
    rowed = dst.dim() == 2
    if not rowed:
        dst, c = dst[None], c[None]
    C, E = dst.shape
    S = num_segments
    tail = _tail(c, True)
    d = dst.long()
    keep = (d >= 0) & (d < S)
    if row_active is not None:
        keep = keep & (row_active != 0)[:, None]
    keep = keep.reshape(-1)
    row = torch.arange(C, device=dst.device, dtype=torch.int64)[:, None]
    idx = (d + row * S).reshape(-1)[keep]
    data = c.reshape((C * E,) + tail)[keep]
    fill = 0 if combine == "add" else _min_identity(c.dtype)
    out = torch.full((C * S,) + tail, fill, dtype=c.dtype, device=c.device)
    if combine == "add":
        out.index_add_(0, idx, data)
    else:
        if c.dtype.is_floating_point:
            data = torch.clamp(data, max=SENTINEL_F32)
        idx = idx.reshape(idx.shape + (1,) * len(tail)).expand_as(data)
        out.scatter_reduce_(0, idx, data, reduce="amin", include_self=True)
    out = out.reshape((C, S) + tail)
    return out if rowed else out[0]


def scatter_sum_plain(dst, c, num_segments, row_active=None):
    """Plain torch ``scatter_sum``: ``out[s] = sum_{dst[e]==s} c[e]``."""
    return _scatter_plain(dst, c, num_segments, "add", row_active)


def scatter_min_plain(dst, c, num_segments, row_active=None):
    """Plain torch ``scatter_min``: ``out[s] = min(SENTINEL,
    min_{dst[e]==s} c[e])``."""
    return _scatter_plain(dst, c, num_segments, "min", row_active)


# ---------------------------------------------------------------------------
# Wrappers: the CUDA kernel for a CUDA tensor, the plain version for a CPU one
# ---------------------------------------------------------------------------


def _route(x, name):
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not on "
                         f"{x.device}")
    return False


def gather_sum(src, valid, vals, row_active=None):
    """``c[e] = vals[src[e]]`` where ``valid[e]``, else 0."""
    if _route(vals, "gather_sum"):
        return _gather(src, valid, vals, "add", row_active)
    return gather_sum_plain(src, valid, vals, row_active)


def gather_min(src, valid, vals, row_active=None):
    """``c[e] = vals[src[e]]`` where ``valid[e]``, else the sentinel."""
    if _route(vals, "gather_min"):
        return _gather(src, valid, vals, "min", row_active)
    return gather_min_plain(src, valid, vals, row_active)


def scatter_sum(dst, c, num_segments, row_active=None):
    """``out[s] = sum_{e: dst[e]==s} c[e]``, in ``c``'s dtype."""
    if _route(c, "scatter_sum"):
        return _scatter(dst, c, num_segments, "add", row_active)
    return scatter_sum_plain(dst, c, num_segments, row_active)


def scatter_min(dst, c, num_segments, row_active=None):
    """``out[s] = min(SENTINEL, min_{e: dst[e]==s} c[e])``, in ``c``'s
    dtype; no valid mask (contributions arrive already masked)."""
    if _route(c, "scatter_min"):
        return _scatter(dst, c, num_segments, "min", row_active)
    return scatter_min_plain(dst, c, num_segments, row_active)


_lib = None
_IN_TYPES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}


def _library():
    """The built kernel library, with its C signatures declared."""
    global _lib
    if _lib is None:
        from repro_torch.kernels import _build

        lib = _build.load("push_staged")
        g = lib.staged_gather_launch
        g.restype = ctypes.c_int
        g.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4
                      + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
        s = lib.staged_scatter_launch
        s.restype = ctypes.c_int
        s.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                      + [ctypes.c_longlong] * 3 + [ctypes.c_int]
                      + [ctypes.c_void_p] * 2)
        _lib = lib
    return _lib


def _rows(edges, values, rowed):
    """(C, E, B) of a launch, checking that the row counts agree."""
    C = edges.shape[0] if rowed else 1
    if rowed and values.shape[0] != C:
        raise ValueError(f"values have {values.shape[0]} rows, edges {C}")
    B = int(np.prod(_tail(values, rowed), dtype=np.int64))
    return C, edges.shape[-1], B


def _gather(src, valid, vals, combine, row_active):
    """Check the operands and launch the gather kernel."""
    rowed = src.dim() == 2
    if combine == "add":
        if vals.dtype not in _IN_TYPES:
            raise TypeError(f"the CUDA gather_sum kernel takes float32, "
                            f"int32 or bfloat16 values, not {vals.dtype}")
        out_dtype = gather_sum_dtype(vals.dtype)
    else:
        if vals.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"the CUDA gather_min kernel takes float32 or "
                            f"int32 values, not {vals.dtype}")
        out_dtype = vals.dtype
    C, E, B = _rows(src, vals, rowed)
    V = vals.shape[1 if rowed else 0]
    dev = vals.device
    for name, t in (("src", src), ("valid", valid)):
        _check(t, name, torch.int32, src.shape, dev)
    check_row_active(row_active, src, dev)
    vals = vals.contiguous()
    c = torch.empty(tuple(src.shape) + _tail(vals, rowed), dtype=out_dtype,
                    device=dev)
    err = _library().staged_gather_launch(
        0 if combine == "add" else 1, _IN_TYPES[vals.dtype], src.data_ptr(),
        valid.data_ptr(), vals.data_ptr(), c.data_ptr(), C, E, V, B,
        None if row_active is None else row_active.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_{_NAMES[combine]} kernel launch failed: "
                           f"cudaError {err}")
    if C * E:
        launch_counts[f"gather_{_NAMES[combine]}"] += 1
    return c


def _scatter(dst, c, num_segments, combine, row_active):
    """Check the operands and launch the scatter kernel."""
    if c.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"the CUDA scatter_{_NAMES[combine]} kernel takes "
                        f"float32 or int32 values, not {c.dtype}")
    rowed = dst.dim() == 2
    C, E, B = _rows(dst, c, rowed)
    dev = c.device
    _check(dst, "dst", torch.int32, dst.shape, dev)
    check_row_active(row_active, dst, dev)
    if tuple(c.shape[:dst.dim()]) != tuple(dst.shape):
        raise ValueError(f"c: shape {tuple(c.shape)} does not lead with the "
                         f"edge shape {tuple(dst.shape)}")
    c = c.contiguous()
    shape = tuple(dst.shape[:-1]) + (num_segments,) + _tail(c, rowed)
    fill = 0 if combine == "add" else _min_identity(c.dtype)
    out = torch.full(shape, fill, dtype=c.dtype, device=dev)
    err = _library().staged_scatter_launch(
        0 if combine == "add" else 1, int(c.dtype.is_floating_point),
        dst.data_ptr(), c.data_ptr(), out.data_ptr(), C, E, num_segments, B,
        None if row_active is None else row_active.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_{_NAMES[combine]} kernel launch failed: "
                           f"cudaError {err}")
    if C * E:
        launch_counts[f"scatter_{_NAMES[combine]}"] += 1
    return out


_NAMES = {"add": "sum", "min": "min"}
