"""Int8 gradient compression for data-parallel synchronization.

The port of ``repro/optim/compress.py``.  Scheme: blockwise symmetric int8
quantization (per 256-value block max-abs scale, f16 scales), all-gather of
the int8 payloads + scales over the compressed axis, dequantize-and-sum
locally.  Wire bytes vs an f32 ring all-reduce:

    all-reduce f32:  2 * 4 * N * (P-1)/P   bytes/device
    compressed  :    (1 * N + 2 * N/256) * (P-1)   bytes/device

Because the sum happens *after* dequantization, the result is exact w.r.t.
the quantized values; quantization error itself is carried into the next
step by *error feedback* (Seide et al., Karimireddy et al.).

The port keeps data-parallel replicas on one device as it keeps chares: a
leading ``[P, ...]`` axis stands for the mesh axis.  ``compressed_psum``
takes every replica's tensor stacked on that axis; the all-gather is the
stacked payload, and the sum runs over axis 0.  Every replica receives the
same sum, so it is returned once.
"""

from __future__ import annotations

import math

import torch

from repro_torch.optim.transforms import _unzip, tree_map

BLOCK = 256
F32 = torch.float32


def _pad_flat(x, block=BLOCK):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return flat, pad


def quantize_int8(x, block=BLOCK):
    """x -> (q int8 [Nb, block], scales f16 [Nb]); symmetric per-block."""
    flat, _ = _pad_flat(x.to(F32), block)
    blocks = flat.reshape(-1, block)
    scale = torch.amax(torch.abs(blocks), dim=1) / 127.0
    safe = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127) \
        .to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize_int8(q, scale, shape, block=BLOCK):
    flat = (q.to(F32) * scale.to(F32)[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


def compressed_psum(x, block=BLOCK):
    """Sum ``x [P, ...]`` over its leading replica axis, moving int8 (+f16
    scales) per replica.  Exact given the quantized values (dequantize,
    then sum in f32)."""
    qs, ss = zip(*(quantize_int8(xi, block) for xi in x))
    q_all, s_all = torch.stack(qs), torch.stack(ss)  # [P, Nb, block], [P, Nb]
    deq = q_all.to(F32) * s_all.to(F32)[..., None]
    flat = deq.sum(dim=0).reshape(-1)
    shape = tuple(x.shape[1:])
    return flat[:math.prod(shape)].reshape(shape).to(x.dtype)


def make_error_feedback():
    """Error-feedback wrapper: carries the quantization residual.

    usage (trees of ``[P, ...]`` replica-stacked gradients):
        ef_init, ef_apply = make_error_feedback()
        residual = ef_init(grads)
        (synced, residual) = ef_apply(grads, residual)
    ``synced`` holds each leaf's sum over replicas; ``residual`` keeps one
    residual per replica.
    """

    def init(tree):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                              device=g.device), tree)

    def apply(tree, residual, block=BLOCK):
        def one(g, r):
            corrected = g.to(F32) + r
            local = [dequantize_int8(*quantize_int8(c, block), c.shape, block)
                     for c in corrected]
            new_r = corrected - torch.stack(local)  # what failed to send
            synced = compressed_psum(corrected, block)
            return synced.to(g.dtype), new_r

        return _unzip(tree_map(one, tree, residual), 2)

    return init, apply
