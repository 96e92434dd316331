"""Wrappers for the push kernels: padding, the sentinel encoding, engine hooks.

The twin of ``repro/kernels/ops.py``.  Two kernel paths serve the push:

  * ``fused`` (default) -- ``push_fused.fused_push``, one launch: ``push``
    pads the operands to the kernel's block geometry, maps float ``+inf``
    to the int32 sentinel and back.
  * ``staged`` (``fused=False``) -- ``push_staged``'s gather kernel, the
    weight transform as a torch elementwise op, then its scatter kernel,
    with the ``[E]`` intermediate between them.  These kernels need no
    padding.

Each kernel is the CUDA kernel for tensors on the card and its plain torch
version for tensors on the CPU.  Edge operands may be one layout row
(``[E]``) or every chare row at once (``[C, E]`` with ``vals``
``[C, V(, B)]``).  ``segment_reduce``/``make_segment_fn`` expose the
scatter half alone (the engine's ``segment_fn`` hook).  Rowed calls take
an optional row gate, ``row_active`` (``[C]`` int32, 0 for a gated row):
a gated row's output is its ``init`` row or the identity, and its kernels
read nothing of it (the engine's frontier gate).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import push_fused as fused_mod
from repro_torch.kernels import push_staged as staged
from repro_torch.kernels.blocks import BLOCK_E, BLOCK_S, BLOCK_V

SENTINEL = fused_mod.SENTINEL


def _pad_to(x, mult, fill, dim=0):
    """Pad ``x`` along ``dim`` to a multiple of ``mult`` with ``fill``."""
    n = x.shape[dim]
    pad = (-n) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=dim)


def _per_edge(w, c):
    """A per-edge ``[..., E]`` operand broadcast against ``c`` ``[..., E(,
    B)]``."""
    return w.reshape(w.shape + (1,) * (c.dim() - w.dim()))


def _sat_add(c, w):
    """Saturating add for the min semiring: never wraps past the sentinel.

    Ints clamp the (non-negative) weight to the headroom below SENTINEL;
    floats ride on inf arithmetic (>= SENTINEL is "unreached" either way).
    """
    w = _per_edge(w.to(c.dtype), c)
    if c.dtype.is_floating_point:
        return c + w
    return c + torch.minimum(w, SENTINEL - c)


def _min_restore_identity(out):
    """Map sentinel-range float results back to +inf (the FMIN identity).

    The min kernels fill empty lanes with the int32 sentinel, which a float
    buffer stores as 2^31; callers expect unreached == +inf."""
    if out.dtype.is_floating_point:
        return torch.where(out >= fused_mod.SENTINEL_F32,
                           torch.full((), float("inf"), dtype=out.dtype,
                                      device=out.device), out)
    return out


def _bands_on_device(src, dst, valid, num_blocks):
    """Torch twin of ``blocks.edge_bands`` for standalone (layout-less)
    calls: per-edge-block (src_lo, src_hi, seg_lo, seg_hi) over valid edges,
    ``[4, NB]`` for ``[E]`` edges or ``[C, 4, NB]`` for ``[C, E]``.  Edges
    must already be padded to ``num_blocks * BLOCK_E``."""
    shape = src.shape[:-1] + (num_blocks, BLOCK_E)
    live = (valid != 0).reshape(shape)
    big = torch.iinfo(torch.int32).max

    def lo(blk):
        x = torch.where(live, blk.reshape(shape), big).amin(dim=-1)
        return torch.where(x == big, 0, x)  # empty block -> (0, -1)

    def hi(blk):
        return torch.where(live, blk.reshape(shape), -1).amax(dim=-1)

    sb, db = src // BLOCK_V, dst // BLOCK_S
    return torch.stack([lo(sb), hi(sb), lo(db), hi(db)],
                       dim=-2).to(torch.int32)


def push(vals, src, dst, valid, num_segments, combine="add", weight=None,
         band=None, fused=True, unit_weight=False, init=None,
         row_active=None):
    """out[s] = combine_{e: dst[e]==s, valid[e]==1} edge_value(vals[src[e]]).

    The paper's per-chare hot loop; arbitrary (unpadded) shapes accepted.
    ``vals`` may be ``[V]`` or a batched ``[V, B]`` query plane (with a
    leading chare axis when the edges have one).  ``weight`` (optional,
    per-edge) applies the semiring transform between gather and combine:
    ``c * w`` for add, saturating ``c + w`` for min.  Float min treats values
    at/above the int32 sentinel as unreached and returns them as +inf.
    ``band`` is the layout's precomputed table; a table derived on the fly
    (``band=None``) takes the atomic add, so that no tile plan is computed
    and read back for a table used once.  ``unit_weight`` applies the
    transform with a constant 1.
    ``init`` (optional, ``[num_segments(, B)]``) seeds the accumulator with a
    prior partial instead of the combiner identity.  ``fused=False`` runs
    the staged pair (``band`` unused).  ``row_active`` (rowed calls only)
    gates chare rows.
    """
    fused_mod.check_row_active(row_active, src, vals.device)
    if not fused:
        return _push_staged(vals, src, dst, valid, num_segments, combine,
                            weight, unit_weight, init, row_active)
    rowed = src.dim() == 2
    vdim = 1 if rowed else 0
    identity = 0 if combine == "add" else SENTINEL
    vals_p = _pad_to(vals, BLOCK_V, identity, dim=vdim)
    src_p = _pad_to(src, BLOCK_E, 0, dim=-1)
    dst_p = _pad_to(dst, BLOCK_E, 0, dim=-1)
    valid_p = _pad_to(valid, BLOCK_E, 0, dim=-1)
    nseg_p = num_segments + ((-num_segments) % BLOCK_S)
    if combine == "min" and vals_p.dtype.is_floating_point:
        # inf -> sentinel so the kernel's sentinel fills and masks compare
        # consistently; restored to inf on the way out
        vals_p = torch.clamp(vals_p, max=fused_mod.SENTINEL_F32)
    kernel = fused_mod.fused_push
    if band is None:
        band = _bands_on_device(src_p, dst_p, valid_p,
                                src_p.shape[-1] // BLOCK_E)
        kernel = fused_mod.fused_push_atomic
    w_p = None if weight is None else _pad_to(
        weight, BLOCK_E, 1 if combine == "add" else 0, dim=-1)
    init_p = None
    if init is not None:
        od = fused_mod.output_dtype(vals_p.dtype, combine)
        init_p = _pad_to(init, BLOCK_S, identity, dim=vdim).to(od)
        if combine == "min" and od.is_floating_point:
            init_p = torch.clamp(init_p, max=fused_mod.SENTINEL_F32)
    out = kernel(band, src_p, dst_p, valid_p, w_p, vals_p, nseg_p,
                 combine=combine, unit_weight=unit_weight, init=init_p,
                 row_active=row_active)
    out = out.narrow(vdim, 0, num_segments)
    if combine == "add":
        return out.to(vals.dtype)
    return _min_restore_identity(out)


def _push_staged(vals, src, dst, valid, num_segments, combine, weight,
                 unit_weight, init, row_active):
    """The staged pair: gather kernel, weight transform (a torch elementwise
    op, as it is an XLA op between the Pallas kernels in the reference),
    scatter kernel.  The kernels have no seed operand: ``init`` is folded
    in afterwards with the combiner (a gated row's scatter output is the
    identity, so it folds to its ``init`` row)."""
    if combine == "add":
        c = staged.gather_sum(src, valid, vals, row_active)
        if weight is not None:
            c = c * _per_edge(weight.to(c.dtype), c)
        out = staged.scatter_sum(dst, c, num_segments, row_active)
    else:
        if unit_weight and weight is None:
            weight = torch.ones_like(valid)  # the staged pair streams ones
        c = staged.gather_min(src, valid, vals, row_active)
        if weight is not None:
            c = _sat_add(c, weight)
        out = staged.scatter_min(dst, c, num_segments, row_active)
    if init is not None:
        ip = init.to(out.dtype)
        if combine == "add":
            out = out + ip
        else:
            if ip.dtype.is_floating_point:  # +inf -> sentinel
                ip = torch.clamp(ip, max=fused_mod.SENTINEL_F32)
            out = torch.minimum(out, ip)
    if combine == "add":
        return out.to(vals.dtype)
    return _min_restore_identity(out)


def segment_reduce(data, seg_ids, num_segments, combine="add",
                   row_active=None):
    """Scatter half only (data already gathered): the engine's segment hook.

    ``data`` ``[E(, B)]`` with ``seg_ids`` ``[E]``, or every chare row at
    once (``[C, E(, B)]`` with ``[C, E]`` ids -> ``[C, S(, B)]``).  Integer
    add data accumulates in its own integer dtype (a float32 cast rounds
    sums above 2^24), float add in at least float32; the result has
    ``data``'s dtype.  Float min reads values at or above the int32
    sentinel as unreached and returns them, and empty segments, as +inf.
    ``row_active`` (rowed calls) skips gated rows, whose output rows hold
    the identity.
    """
    if combine == "add":
        acc = staged.gather_sum_dtype(data.dtype)
        out = staged.scatter_sum(seg_ids, data.to(acc), num_segments,
                                 row_active)
        return out.to(data.dtype)
    if combine != "min":
        raise ValueError(f"unknown combine {combine!r}")
    return _min_restore_identity(staged.scatter_min(seg_ids, data,
                                                    num_segments, row_active))


def make_segment_fn(combine=None):
    """Adapter for ``Engine(segment_fn=...)``: routes the local combines of
    any strategy through the scatter kernels.

    The strategies pass the active program's monoid via the ``combine``
    keyword (the segment_fn contract), so one hook serves PageRank (add),
    labelprop (int min) and SSSP (float min) alike.  The ``combine``
    constructor argument forces a fixed monoid; otherwise a call without
    the keyword falls back to dtype inference (float -> add, int -> min).
    """

    def fn(data, seg_ids, num_segments, combine=combine, row_active=None):
        if combine is None:
            combine = "add" if data.dtype.is_floating_point else "min"
        return segment_reduce(data, seg_ids, num_segments, combine=combine,
                              row_active=row_active)

    return fn


def make_push_fn(fused=True):
    """Adapter for the engine's push hook: the whole per-chare hot loop --
    gather, edge-value transform, segment combine -- over every chare row:
    one fused launch fed by the layout's band table, or (``fused=False``)
    the staged gather and scatter launches.

    Contract (see ``strategies._dense_contrib``): strategies call

        push_fn(vals, src_local, dst, valid, weight, num_segments,
                combine=..., band=..., unit=..., init=..., row_active=...)

    with ``weight=None`` when the program has no edge transform and
    ``row_active`` the frontier gate's ``[C]`` row mask (``None``: no gate).
    """

    def fn(vals, src, dst, valid, weight, num_segments, combine, band=None,
           unit=False, init=None, row_active=None):
        return push(vals, src, dst, valid, num_segments, combine=combine,
                    weight=weight, band=band, fused=fused, unit_weight=unit,
                    init=init, row_active=row_active)

    fn.fused = fused  # which path the hook runs, for callers to inspect
    return fn
