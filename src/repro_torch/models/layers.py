"""Core transformer layers: norms, RoPE, GQA attention (full / sliding-window,
train / decode), SwiGLU MLP, embedding and the LM head.

The port of ``repro/models/layers.py``.  Pure-function style over parameter
dicts of tensors: ``init_*`` builds one block's parameters (on the ``meta``
device it allocates nothing), ``*_fwd`` applies them.  Every function keeps
the reference's arithmetic, dtype by dtype: bf16 products rounded to bf16
before they are cast to f32, f32 norms, rope angles and softmax statistics.

Attention is *chunked with online softmax* (the FlashAttention recurrence
over KV chunks): scores never materialize beyond [B, heads, q_chunk,
kv_chunk].  The reference computes it in plain JAX, not in a Pallas kernel,
so the port computes it in plain torch ops (not
``scaled_dot_product_attention``, whose arithmetic differs).

On an ``LmMesh`` with a model axis wider than 1 (``mesh=``), the blocks
run tensor-parallel over it, each rank on the parameter shards the spec
tables give it: head-parallel attention (column-split ``wq``, and
``wk``/``wv`` where the KV heads divide, a row-split ``wo`` and one
all-reduce), ff-parallel ``mlp_fwd``, a vocab-split embedding (a masked
local lookup and an all-reduce) and LM head; where the heads do not
divide the axis, ``attention_fwd`` takes ``ring_attention_block``
(sequence-split, K/V rotated around the model ring) as the reference
does.  Inputs enter replicated over the model axis; each collective is
an autograd pair (``repro_torch.launch.mesh.copy_to`` / ``reduce_from``
and the rest), so the backward issues the conjugate collective.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import mesh as LM

PDT = torch.bfloat16  # parameter/activation dtype

NEG_INF = -1e30


def _normal(shape, scale, generator, device, dtype=PDT):
    """``N(0, 1) * scale`` drawn in f32 and rounded to ``dtype`` (the
    reference's ``(normal(key, shape) * scale).astype(PDT)``); an empty
    tensor on the ``meta`` device."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norm / rope / softcap
# ---------------------------------------------------------------------------


def init_rmsnorm(d, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p, x, eps=1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def rope(x, positions, theta=10_000.0):
    """x: [..., S, H, hd]; positions: [..., S] int32."""
    hd = x.shape[-1]
    half = hd // 2
    freq = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    ang = positions[..., None].float() * freq  # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def init_attention(cfg, generator, device):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    sc = d ** -0.5
    p = {
        "wq": _normal((d, h, hd), sc, generator, device),
        "wk": _normal((d, kv, hd), sc, generator, device),
        "wv": _normal((d, kv, hd), sc, generator, device),
        "wo": _normal((h, hd, d), (h * hd) ** -0.5, generator, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h, hd), dtype=PDT, device=device)
        p["bk"] = torch.zeros((kv, hd), dtype=PDT, device=device)
        p["bv"] = torch.zeros((kv, hd), dtype=PDT, device=device)
    return p


def _qkv(p, x, positions, cfg):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mask(q_pos, k_pos, causal, window):
    """[..., Sq, Sk] additive mask."""
    m = torch.zeros((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.float32,
                    device=q_pos.device)
    d = q_pos[:, None] - k_pos[None, :]
    if causal:
        m = torch.where(d < 0, NEG_INF, m)
    if window:
        m = torch.where(d >= window, NEG_INF, m)
    return m


def chunked_attention(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                      logit_softcap=0.0, kv_chunk=1024, q_chunk=1024):
    """Online-softmax attention; q:[B,Sq,H,hd] k,v:[B,Sk,KV,hd] GQA.

    K/V are broadcast to H heads up front (the reference's flat-head
    layout: kv head ``h // G`` serves head ``h``).  Both products are f32
    products of the operands as they are: the reference's scan body is
    compiled, and XLA computes its ``einsum(bf16, bf16).astype(f32)`` as
    one f32 product; the probabilities are rounded to V's dtype before the
    PV product, as there.  Memory high-water: [B, H, q_chunk, kv_chunk] f32
    scores per step.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    kv_chunk = min(kv_chunk, Sk)
    q_chunk = min(q_chunk, Sq)
    nq, nk = Sq // q_chunk, Sk // kv_chunk
    scale = hd ** -0.5

    qg = q.reshape(B, nq, q_chunk, H, hd).permute(1, 0, 3, 2, 4)
    kc = k.reshape(B, nk, kv_chunk, H, hd).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, nk, kv_chunk, H, hd).permute(1, 0, 3, 2, 4)
    qp = q_pos.reshape(nq, q_chunk)
    kp = k_pos.reshape(nk, kv_chunk)

    # banded local attention: a causal sliding-window layer only needs the
    # kv chunks covering [qpos0 - window + 1, qpos_last]
    nb = nk
    if causal and window and nk > 1:
        nb = min(nk, (window + q_chunk - 2) // kv_chunk + 2)

    outs = []
    for qi, qpos in zip(qg, qp):  # [B,H,qc,hd], [qc]
        kcb, vcb, kpb = kc, vc, kp
        if nb < nk:  # banded: the needed kv-chunk window, picked on the
            # device (no host read: the step traces on ``meta`` and the
            # host does not wait on the card)
            first = torch.clamp(torch.div(qpos[0] - window + 1, kv_chunk,
                                          rounding_mode="floor"), 0, nk - nb)
            band = first + torch.arange(nb, device=q.device)
            kcb, vcb, kpb = (t.index_select(0, band) for t in (kc, vc, kp))
        m_run = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros((B, H, q_chunk), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd), dtype=torch.float32,
                          device=q.device)
        for c in range(nb):
            kc_i, vc_i, kpos = kcb[c], vcb[c], kpb[c]  # [B,H,c,hd]
            s = torch.einsum("bhqd,bhcd->bhqc", qi.float(), kc_i.float())
            s = softcap(s * scale, logit_softcap)
            ok = _mask(qpos, kpos, causal, window) == 0.0  # [qc, c] bool
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            # fully-masked-so-far rows: keep the exp argument finite
            m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
            p = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(m_run <= NEG_INF, 0.0,
                               torch.exp(m_run - m_safe))
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqc,bhcd->bhqd", p.to(vc_i.dtype).float(), vc_i.float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))

    out = torch.stack(outs)  # [nq,B,H,qc,hd]
    return out.permute(1, 0, 3, 2, 4).reshape(B, Sq, H, hd)


def attention_fwd(p, x, positions, cfg, mixer, mesh=None):
    """Training / prefill self-attention over the full sequence.

    On a mesh whose model axis (n > 1) the head count does not divide,
    with ``S % n == 0`` and ``S // n >= 128``, the block switches to
    ``ring_attention_block`` (the reference's rule); where the heads
    divide, it runs head-parallel on this rank's heads
    (``_head_parallel``); otherwise every rank computes it whole."""
    S, n = x.shape[1], LM.model_size(mesh)
    if n > 1 and cfg.num_heads % n != 0 and S % n == 0 and S // n >= 128:
        return ring_attention_block(p, x, cfg, mixer, mesh, n), None
    if n > 1 and p["wq"].shape[1] != cfg.num_heads:
        return _head_parallel(p, x, positions, cfg, mixer, mesh), None
    q, k, v = _qkv(p, x, positions, cfg)
    out = chunked_attention(
        q, k, v, positions, positions,
        causal=not cfg.encoder_only,
        window=cfg.window if mixer == "local" else 0,
        logit_softcap=cfg.attn_logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (k, v)


def _local_kv(p, cfg, mesh):
    """The K/V projections (and biases) this rank's query heads read: its
    own KV-head shard where ``wk``/``wv`` are split over the model axis,
    else the heads its query heads map to (``h // G``) picked from the
    whole ones, one K/V head per query head; those enter through
    ``copy_to`` (each rank's gradient covers its heads only)."""
    Hl = p["wq"].shape[1]
    if p["wk"].shape[1] != cfg.num_kv_heads:  # split with the query heads
        return p
    G = cfg.num_heads // cfg.num_kv_heads
    first = mesh.axis_index("model") * Hl
    kv = torch.arange(first, first + Hl, device=p["wk"].device) // G
    out = dict(p)
    for key, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if key in p:
            out[key] = LM.copy_to(p[key], mesh).index_select(dim, kv)
    return out


def _head_parallel(p, x, positions, cfg, mixer, mesh):
    """Attention on this rank's query heads (``wq``/``bq`` column-split,
    the GQA groups kept: kv head ``h // G`` serves head ``h``), then the
    row-split ``wo``'s partial summed over the model axis."""
    x = LM.copy_to(x, mesh)
    q, k, v = _qkv(_local_kv(p, cfg, mesh), x, positions, cfg)
    out = chunked_attention(
        q, k, v, positions, positions, causal=not cfg.encoder_only,
        window=cfg.window if mixer == "local" else 0,
        logit_softcap=cfg.attn_logit_softcap)
    return LM.reduce_from(torch.einsum("bshk,hkd->bsd", out, p["wo"]), mesh)


def _hop_update(qf, k_blk, v_blk, qpos, kpos, m, l, acc, G, scale, causal,
                window, cap):
    """One ring hop's online-softmax update of ``(m, l, acc)`` (f32) with
    one K/V block: the reference's ``hop_update``."""
    kh = torch.repeat_interleave(k_blk, G, dim=2).transpose(1, 2)
    vh = torch.repeat_interleave(v_blk, G, dim=2).transpose(1, 2)
    s = torch.einsum("bhqd,bhcd->bhqc", qf.float(), kh.float())
    s = softcap(s * scale, cap)
    ok = _mask(qpos, kpos, causal, window) == 0.0
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(m_new <= NEG_INF, 0.0, m_new)
    pmat = torch.where(ok, torch.exp(s - m_safe[..., None]), 0.0)
    corr = torch.where(m <= NEG_INF, 0.0, torch.exp(m - m_safe))
    l_new = l * corr + pmat.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bhqc,bhcd->bhqd", pmat.to(vh.dtype).float(), vh.float())
    return m_new, l_new, acc


def ring_attention_block(p, x, cfg, mixer, mesh, n_model):
    """The whole attention block under sequence sharding over the model
    axis (the reference's ``ring_attention_block``): this rank's S/n rows
    of ``x`` (replicated over the axis) get their Q/K/V projections; the
    K/V blocks and their positions travel the ring one hop at a time
    (``batch_isend_irecv``; the gradient goes back the other way) while
    an online softmax in f32 folds each block in with the global
    ``qpos``/``kpos`` masks (causal, window, softcap); the output
    projection runs on the local rows and the rows are gathered back.
    The weights enter through ``copy_to`` (each rank's gradient covers
    its rows only, and the backward sums them).  Wire bytes per rank:
    (n-1) x |K+V block| per layer, the paper's pairs/ring analysis.
    Each hop's update is checkpointed (the backward recomputes its score
    tile)."""
    causal = not cfg.encoder_only
    window = cfg.window if mixer == "local" else 0
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    G = H // KV
    pp = {k: LM.copy_to(v, mesh) for k, v in p.items()}
    x_loc = LM.scatter_to(x, mesh, "model", 1)
    B, c, _ = x_loc.shape
    me = mesh.axis_index("model") if n_model > 1 else 0
    qpos = me * c + torch.arange(c, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(pp, x_loc, qpos, cfg)  # [B,c,H,hd], [B,c,KV,hd]
    qf = q.transpose(1, 2)  # [B,H,c,hd]
    m = torch.full((B, H, c), NEG_INF, dtype=torch.float32, device=x.device)
    l = torch.zeros((B, H, c), dtype=torch.float32, device=x.device)
    acc = torch.zeros((B, H, c, hd), dtype=torch.float32, device=x.device)
    kpos = qpos
    remat = torch.is_grad_enabled() and q.requires_grad
    for hop in range(n_model):
        args = (qf, k, v, qpos, kpos, m, l, acc, G, hd ** -0.5, causal,
                window, cfg.attn_logit_softcap)
        m, l, acc = (checkpoint(_hop_update, *args, use_reentrant=False)
                     if remat else _hop_update(*args))
        if hop + 1 < n_model:  # rotate the K/V block (the pairs variant)
            k, v = LM.ring_shift(k, mesh), LM.ring_shift(v, mesh)
            kpos = LM.ring_shift(kpos, mesh)
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(x.dtype)
    out = torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), pp["wo"])
    return LM.gather_from(out, mesh, "model", 1)


def attention_decode(p, x, pos, cache_k, cache_v, cfg, mixer):
    """One-token decode against a [B, W, KV, hd] cache; returns out, cache.

    The cache is a *ring buffer*: the new K/V land in slot ``pos % W``
    (written in place: the caches returned are the tensors passed in).
    When W >= pos+1 this degenerates exactly to a plain full cache (slot ==
    pos, reconstructed position == slot), so one code path serves both
    full-cache decode and sliding-window decode with W == cfg.window.
    ``pos`` is a Python int (the host knows it; no device read).
    """
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k1, v1 = _qkv(p, x, positions, cfg)  # [B,1,H,hd], [B,1,KV,hd]
    W = cache_k.shape[1]
    slot = pos % W
    cache_k[:, slot] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, slot] = v1[:, 0].to(cache_v.dtype)
    KV, H, hd = cache_k.shape[2], q.shape[2], q.shape[3]
    G = H // KV
    qg = q.reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, cache_k).float()
    s = softcap(s * hd ** -0.5, cfg.attn_logit_softcap)
    # position actually held by ring slot j (== j for a full cache)
    j = torch.arange(W, device=x.device)
    kpos = pos - torch.remainder(pos - j, W)
    valid = kpos >= 0
    if mixer == "local" and cfg.window:
        valid &= kpos > pos - cfg.window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(cache_v.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", w, cache_v).reshape(B, 1, H, hd)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), (cache_k, cache_v)


# ---------------------------------------------------------------------------
# MLP / embedding
# ---------------------------------------------------------------------------


def init_mlp(d, ff, generator, device):
    return {
        "w_gate": _normal((d, ff), d ** -0.5, generator, device),
        "w_in": _normal((d, ff), d ** -0.5, generator, device),
        "w_out": _normal((ff, d), ff ** -0.5, generator, device),
    }


def silu(x):
    """``x * sigmoid(x)`` with the sigmoid expanded as the reference's
    ``logistic`` is (``1 / (1 + exp(-x))``), each step rounded to x's
    dtype: a fused ``torch.nn.functional.silu`` rounds once and differs
    from it in about 4 of 10 bf16 elements."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def mlp_fwd(p, x, mesh=None, d_ff=None):
    """SwiGLU.  On a mesh whose model axis splits ``w_gate``/``w_in`` by
    columns and ``w_out`` by rows (their ff dim narrower than ``d_ff``),
    each rank computes its ff slice and the partials are summed over the
    axis."""
    tp = d_ff is not None and p["w_gate"].shape[1] != d_ff
    if tp:
        x = LM.copy_to(x, mesh)
    h = silu(torch.einsum("bsd,df->bsf", x, p["w_gate"]))
    h = h * torch.einsum("bsd,df->bsf", x, p["w_in"])
    out = torch.einsum("bsf,fd->bsd", h, p["w_out"])
    return LM.reduce_from(out, mesh) if tp else out


def init_embedding(vocab, d, generator, device):
    return {"table": _normal((vocab, d), 1.0, generator, device)}


def embed_scale(d) -> float:
    """``d ** 0.5`` rounded to bf16, as the reference multiplies by
    ``jnp.asarray(d ** 0.5, PDT)`` (gemma3: 33.941... -> 34.0)."""
    return float(torch.tensor(d ** 0.5, dtype=PDT))


def embed(p, tokens, d, mesh=None, vocab=None):
    """``table[tokens] * sqrt(d)``.  A table split by vocab rows over the
    model axis (fewer rows than ``vocab``) is read by a masked local
    lookup (zeros for another rank's ids) and the rows summed over the
    axis: one nonzero each, so the sum is exact."""
    table = p["table"]
    if vocab is None or table.shape[0] == vocab:
        return table[tokens] * embed_scale(d)
    Vl = table.shape[0]
    local = tokens - mesh.axis_index("model") * Vl
    mine = (local >= 0) & (local < Vl)
    rows = table[torch.where(mine, local, 0)] * mine[..., None].to(table.dtype)
    return LM.reduce_from(rows, mesh) * embed_scale(d)


def logits_fwd(p, x, final_cap=0.0):
    """bf16 product [B,S,V], then f32 (the reference's order)."""
    out = torch.einsum("bsd,vd->bsv", x, p["table"]).float()
    return softcap(out, final_cap)
