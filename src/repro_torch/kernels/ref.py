"""Plain torch oracles for the push kernels: the twins of
``repro/kernels/ref.py``'s ``push_ref`` and gather/scatter references.

Edge arrays are 1-D ``[E]``; ``vals`` / the gathered data may carry a
trailing batch axis (``[V, B]`` / ``[E, B]``).  Indices are widened to int64
for ``index_select`` / ``index_add_`` / ``scatter_reduce``.
"""

from __future__ import annotations

import torch

SENTINEL = 2147483647  # int32 max: the min monoid's "unreached"


def _expand(mask, data):
    """Broadcast a per-edge [E] mask against [E] or batched [E, B] data."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def gather_sum_ref(src, valid, vals):
    c = vals.to(torch.float32).index_select(0, src.long())
    return torch.where(_expand(valid != 0, c), c, torch.zeros((), dtype=c.dtype,
                                                              device=c.device))


def scatter_sum_ref(dst, c, num_segments):
    out = torch.zeros((num_segments,) + tuple(c.shape[1:]), dtype=c.dtype,
                      device=c.device)
    return out.index_add_(0, dst.long(), c)


def gather_min_ref(src, valid, vals):
    c = vals.index_select(0, src.long())
    return torch.where(_expand(valid != 0, c), c,
                       torch.full((), SENTINEL, dtype=c.dtype, device=c.device))


def scatter_min_ref(dst, c, num_segments):
    """Segment min; empty segments hold the dtype's maximum (+inf for
    floats), as ``jax.ops.segment_min`` leaves them."""
    big = (float("inf") if c.dtype.is_floating_point
           else torch.iinfo(c.dtype).max)
    out = torch.full((num_segments,) + tuple(c.shape[1:]), big,
                     dtype=c.dtype, device=c.device)
    idx = _expand(dst.long(), c).expand_as(c)
    return out.scatter_reduce_(0, idx, c, reduce="amin", include_self=True)


def push_ref(vals, src, dst, valid, num_segments, combine="add", weight=None):
    """Full hot loop: out[s] = combine_{e: dst[e]==s, valid[e]} ev(vals[src[e]])
    where the optional per-edge ``weight`` applies the semiring transform
    (``* w`` for add, sentinel-saturating ``+ w`` for min).  Float min maps
    sentinel-range results back to +inf, matching ``ops.push``."""
    if combine == "add":
        c = gather_sum_ref(src, valid, vals)
        if weight is not None:
            c = c * _expand(weight.to(c.dtype), c)
        return scatter_sum_ref(dst, c, num_segments).to(vals.dtype)
    c = gather_min_ref(src, valid, vals)
    floating = c.dtype.is_floating_point
    if weight is not None:
        w = _expand(weight.to(c.dtype), c)
        if floating:
            c = c + w
        else:
            c = c + torch.minimum(w, SENTINEL - c)  # int32-safe saturation
    out = scatter_min_ref(dst, c, num_segments)
    if floating:
        out = torch.where(out >= SENTINEL, torch.full_like(out, float("inf")),
                          out)
    return out
