"""Fused push: gather, edge-value transform and segment combine in one launch.

The twin of ``repro/kernels/push_fused.py``'s ``fused_push``: same operands,
same output dtypes, same ``init=`` seed and trailing ``[B]`` plane.  On a
CUDA tensor it launches the hand-written Hopper kernels in
``csrc/push_fused.cu`` (which replace the TPU's ``_fused_push_add_kernel``
and ``_fused_push_min_kernel``; the source says what bounds them and how the
design answers it).  On a CPU tensor it runs ``fused_push_plain``, the plain
torch version of the same function, which is also what the kernels are
checked against on the card.

Edge operands are either one layout row (``src``/``dst``/``valid``/``weight``
``[E]``, ``band`` ``[4, E/BLOCK_E]``, ``vals`` ``[V(, B)]`` -> ``[S(, B)]``)
or all chare rows at once (``[C, E]``, ``[C, 4, E/BLOCK_E]``, ``[C, V(, B)]``
-> ``[C, S(, B)]``, row r gathering from ``vals[r]`` into ``out[r]``), so
one launch serves every chare of a superstep.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.blocks import BLOCK_E

SENTINEL = 2147483647
# float(SENTINEL) in float32: the value JAX compares and fills float min with
SENTINEL_F32 = float(np.float32(SENTINEL))

# launches of each CUDA push kernel since the last reset (CPU calls do not
# count): the fused pair here, the staged four in push_staged
launch_counts = {"fused_push_add": 0, "fused_push_min": 0,
                 "gather_sum": 0, "scatter_sum": 0,
                 "gather_min": 0, "scatter_min": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
               combine="add", unit_weight=False, init=None):
    """One-launch fused push over pre-padded inputs.

    Shapes: edges padded to BLOCK_E (``band`` from ``blocks.edge_bands``);
    ``num_segments`` the output length S.  ``weight=None`` skips the
    edge-value transform; ``unit_weight`` applies it with a compile-time
    constant 1 and no weight operand.  The transform is ``c * w`` for add and
    the saturating ``c + min(w, SENTINEL - c)`` (ints) or ``c + w`` (floats)
    for min; float min values above ``float(SENTINEL)`` count as unreached.
    ``init`` (optional, the output's shape and dtype) seeds the accumulator
    in place of the combiner identity (0, or SENTINEL for min).
    """
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
    if vals.is_cuda:
        return _launch(band, src, dst, valid, weight, vals, shape, combine,
                       mode, out_dtype, init)
    if vals.device.type != "cpu":
        raise ValueError(f"fused_push runs on CUDA or CPU tensors, not on "
                         f"{vals.device}")
    return fused_push_plain(band, src, dst, valid, weight, vals, num_segments,
                            combine=combine, unit_weight=unit_weight,
                            init=init)


def _identity(combine, dtype):
    if combine == "add":
        return 0
    return SENTINEL_F32 if dtype.is_floating_point else SENTINEL


def fused_push_plain(band, src, dst, valid, weight, vals, num_segments, *,
                     combine="add", unit_weight=False, init=None):
    """Plain torch version of ``fused_push`` (same arguments, same result;
    float add up to summation order).  ``band`` is not read: it only lets
    the kernel skip empty edge blocks."""
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
    keep = valid.reshape(-1) != 0
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
                      + [ctypes.c_longlong] * 5 + [ctypes.c_int,
                                                   ctypes.c_void_p])
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


def _launch(band, src, dst, valid, weight, vals, shape, combine, mode,
            out_dtype, init):
    """Check the operands and launch the CUDA kernel on the current stream."""
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
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().fused_push_launch(
        0 if combine == "add" else 1, int(out_dtype.is_floating_point),
        _CODES[mode], band.data_ptr(), src.data_ptr(), dst.data_ptr(),
        valid.data_ptr(), weight.data_ptr() if mode == "array" else None,
        vals.data_ptr(), out.data_ptr(), C, E, NB, V, S, B, stream)
    if err != 0:
        raise RuntimeError(f"fused_push_{combine} kernel launch failed: "
                           f"cudaError {err}")
    if C * NB:
        launch_counts[f"fused_push_{combine}"] += 1
    return out
