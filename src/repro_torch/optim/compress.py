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

``compressed_psum`` runs in two forms.  With ``group=`` (a
``torch.distributed`` process group: an ``LmMesh`` axis's
``mesh.group(name)``) each rank passes its own tensor; the int8 payloads
and f16 scales are all-gathered over the group, then dequantized and
summed in f32 in rank order, as the reference's ``all_gather`` over a
mesh axis does.  Without it, data-parallel replicas are stacked on one
device as chares are: a leading ``[P, ...]`` axis stands for the mesh
axis, the stacked payload is the all-gather, and the sum runs over axis
0.  Both forms sum the same stacked ``[P, Nb, block]`` tensor, so they
agree bit for bit.  Every replica receives the same sum.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

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


def compressed_psum(x, block=BLOCK, group=None):
    """Sum ``x`` over ``group``'s ranks (each passes its own), or ``x [P,
    ...]`` over its leading replica axis without one, moving int8 (+f16
    scales) per replica.  Exact given the quantized values (dequantize,
    then sum in f32)."""
    if group is None:
        qs, ss = zip(*(quantize_int8(xi, block) for xi in x))
        q_all, s_all = torch.stack(qs), torch.stack(ss)
        shape = tuple(x.shape[1:])
    else:
        q, s = quantize_int8(x, block)
        P = dist.get_world_size(group)
        q_all = q.new_empty((P,) + tuple(q.shape))
        s_all = s.new_empty((P,) + tuple(s.shape))
        dist.all_gather(list(q_all.unbind()), q, group=group)
        dist.all_gather(list(s_all.unbind()), s, group=group)
        shape = tuple(x.shape)
    deq = q_all.to(F32) * s_all.to(F32)[..., None]  # [P, Nb, block]
    flat = deq.sum(dim=0).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(x.dtype)


def make_error_feedback():
    """Error-feedback wrapper: carries the quantization residual.

    usage (trees of ``[P, ...]`` replica-stacked gradients, or with
    ``group=`` each rank's own gradients):
        ef_init, ef_apply = make_error_feedback()
        residual = ef_init(grads)
        (synced, residual) = ef_apply(grads, residual[, group=group])
    ``synced`` holds each leaf's sum over replicas; ``residual`` keeps one
    residual per replica (this rank's, with a group).
    """

    def init(tree):
        return tree_map(lambda g: torch.zeros(g.shape, dtype=F32,
                                              device=g.device), tree)

    def apply(tree, residual, block=BLOCK, group=None):
        def one(g, r):
            corrected = g.to(F32) + r
            mine = [corrected] if group is not None else corrected
            local = torch.stack([dequantize_int8(*quantize_int8(c, block),
                                                 c.shape, block)
                                 for c in mine])
            if group is not None:
                local = local[0]
            new_r = corrected - local  # what failed to send
            synced = compressed_psum(corrected, block, group)
            return synced.to(g.dtype), new_r

        return _unzip(tree_map(one, tree, residual), 2)

    return init, apply
