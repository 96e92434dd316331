"""Sequence mixers without attention: Mamba (jamba), mLSTM / sLSTM (xlstm).

The port of ``repro/models/ssm.py``.  All three keep O(1) decode state --
which is why their archs run the ``long_500k`` cell (DESIGN.md section 4).
Training / prefill forms:

  mamba  selective SSM, chunked: the [B, di, N] state is carried across
         chunks of ``MAMBA_CHUNK`` steps; inside a chunk the recurrence
         ``h_t = a_t h_{t-1} + b_t`` runs step by step (the reference runs
         it as an associative scan: the same recurrence in another order
         of f32 rounding).  Never materializes [B, S, di, N].
  mlstm  chunkwise-parallel linear attention with exp gating: intra-chunk
         quadratic [c x c] + carried matrix state between chunks
  slstm  strictly sequential scalar recurrence, a loop over S (diagonal
         recurrent weights, as in the reference)

Arithmetic follows the reference as it runs, op by op as measured against
it: the projections in and out are bf16 products; mLSTM's scores are one
f32 product of the bf16 operands (XLA folds the ``.astype(f32)`` of its
compiled chunk body into the product), while mamba's ``x @ w_bc`` is
rounded to bf16 before its cast (the cast is not folded there), and the
elementwise steps of the causal conv and of ``silu`` round at each step.

On an ``LmMesh`` whose model axis splits the mixers' ``"ff"`` dims
(``mesh=``; the spec tables of ``models/sharding.py``, each fused
projection cut by its parts), each rank runs its block of channels: the
input enters through ``copy_to``, the row-split ``out_proj``'s partial
is summed over the axis (``reduce_from``), as ``layers.mlp_fwd`` does.

  mamba  the conv, ``dt``, ``A`` and the scan on the rank's channels;
         ``B``/``C`` are shared across channels, so ``x @ w_bc`` is a
         partial over them, summed over the axis in every chunk (and
         every decode step) by ``sum_parts``, whose backward sums the
         gradient's parts too (each rank's scan reads the sum for its own
         channels only)
  mlstm  heads over the axis where they divide it (the rank's q, k, v,
         gates and state; no collective inside the mixer); where the
         axis is wider than the heads, each head on ``n / H`` ranks: q
         and k gathered over the axis (one ``gather_from``), v and the
         state ``C`` split along their value dim
  slstm  per channel: the rank's channels of each of the four gates

The replicated ``w_gates`` / ``r_gates`` enter through ``copy_to`` and
each rank reads its heads or channels.  Where the axis does not divide a
mixer's ``"ff"`` dims, the spec tables keep them whole, and the mixer
runs unsplit on every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch import mesh as LM
from repro_torch.models.layers import PDT, _normal, silu

F32 = torch.float32


# ---------------------------------------------------------------------------
# Mamba (S6, simplified: B,C shared across channels; dt per channel)
# ---------------------------------------------------------------------------


def init_mamba(cfg, generator, device):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    N, K = cfg.ssm_state, cfg.ssm_conv
    a = torch.arange(1, N + 1, dtype=F32, device=device)
    return {
        "in_proj": _normal((d, 2 * di), d ** -0.5, generator, device),
        "conv_w": _normal((di, K), K ** -0.5, generator, device),
        "conv_b": torch.zeros((di,), dtype=PDT, device=device),
        "w_bc": _normal((di, 2 * N), di ** -0.5, generator, device),
        "w_dt": _normal((di,), di ** -0.5, generator, device, F32),
        "b_dt": torch.full((di,), -4.6, dtype=F32, device=device),
        "a_log": torch.log(a).expand(di, N).contiguous(),
        "d_skip": torch.ones((di,), dtype=F32, device=device),
        "out_proj": _normal((di, d), di ** -0.5, generator, device),
    }


def _causal_conv(x, w, b, state=None):
    """x: [B,S,di]; w: [di,K] depthwise causal FIR. state: [B,K-1,di]."""
    K = w.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    # tap i multiplies x[t - (K-1) + i]; w[:, K-1] is the current sample's tap
    S = x.shape[1]
    out = xp[:, 0:S] * w[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w[:, i]
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out + b, new_state


MAMBA_CHUNK = 256


def _split(p, cfg) -> bool:
    """Whether ``p`` holds a block of the mixer's channels (its
    ``out_proj`` [di, d] split by rows over the model axis)."""
    return p["out_proj"].shape[0] != cfg.ssm_expand * cfg.d_model


def _mamba_core(p, xc, z, cfg, h0=None, mesh=None):
    """xc: [B,S,di] post-conv; returns y [B,S,di] and final state [B,di,N].

    The sequence is padded to a multiple of the chunk; each chunk folds the
    carried state into its first step (``Bx[:, 0] += Ad[:, 0] * h``) and
    runs the recurrence over its ``c`` steps, peaking at [B,c,di,N] f32.
    The final state is the one after the padded steps, as the reference
    returns it (each zero step decays it: past one chunk it is not the
    state after S steps).  At S = 1 (decode) this is one step of the
    recurrence from ``h0``.

    With ``mesh`` the channels are this rank's block: its ``xci @ w_bc``
    is rounded to bf16 as one device's whole product is, the partials are
    summed in f32 over the model axis and the sum rounded to bf16 -- two
    roundings where one device takes one (each partial's within half a
    bf16 ulp of it, then the sum's).
    """
    N = cfg.ssm_state
    B, S, di = xc.shape
    A = -torch.exp(p["a_log"])  # [di,N]
    c = min(MAMBA_CHUNK, S)
    pad = (-S) % c
    if pad:
        xc = torch.cat([xc, xc.new_zeros((B, pad, di))], 1)
    h = h0 if h0 is not None else torch.zeros((B, di, N), dtype=F32,
                                              device=xc.device)
    ys = []
    for start in range(0, S + pad, c):
        xci = xc[:, start:start + c]
        bc = torch.einsum("bsd,dn->bsn", xci, p["w_bc"])
        if mesh is not None:
            bc = LM.sum_parts(bc.float(), mesh).to(bc.dtype)
        bc = bc.float()
        xf = xci.float()
        Bt, Ct = bc[..., :N], bc[..., N:]
        dt = F.softplus(xf * p["w_dt"] + p["b_dt"])
        Ad = torch.exp(dt[..., None] * A)  # [B,c,di,N]
        Bx = (dt * xf)[..., None] * Bt[:, :, None, :]
        hs = []
        for t in range(c):
            h = Bx[:, t] + Ad[:, t] * h
            hs.append(h)
        hseq = torch.stack(hs, dim=1)
        y = torch.einsum("bsdn,bsn->bsd", hseq, Ct) + p["d_skip"] * xf
        ys.append(y.to(xc.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    y = y.float() * silu(z.float())
    return y.to(xc.dtype), h


def _mamba_in(p, x, cfg, mesh):
    """(xin, z, the scan's mesh or None): the input projection's two
    parts on this rank's channels."""
    split = _split(p, cfg)
    if split:
        x = LM.copy_to(x, mesh)
    u = torch.einsum("bsd,de->bse", x, p["in_proj"])
    di = u.shape[-1] // 2
    return u[..., :di], u[..., di:], mesh if split else None


def _out(p, y, cfg, mesh):
    """``y @ out_proj``: where the mixer is split, the row-split
    ``out_proj``'s partial summed over the model axis."""
    return _summed(p, torch.einsum("bse,ed->bsd", y, p["out_proj"]), cfg,
                   mesh)


def _summed(p, out, cfg, mesh):
    return LM.reduce_from(out, mesh) if _split(p, cfg) else out


def mamba_fwd(p, x, cfg, want_cache=False, mesh=None):
    xin, z, run = _mamba_in(p, x, cfg, mesh)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = silu(xc)
    y, h = _mamba_core(p, xc, z, cfg, mesh=run)
    out = _out(p, y, cfg, mesh)
    if want_cache:
        return out, {"conv": conv_state.to(PDT), "ssm": h}
    return out


def mamba_init_cache(cfg, batch, device, lead=()):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di),
                                dtype=PDT, device=device),
            "ssm": torch.zeros(lead + (batch, di, cfg.ssm_state), dtype=F32,
                               device=device)}


def mamba_decode(p, x, cache, cfg, mesh=None):
    """x: [B,1,d]; single-step recurrence.  Returns (out, new cache); on a
    mesh the cache holds this rank's channels."""
    xin, z, run = _mamba_in(p, x, cfg, mesh)
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  cache["conv"])
    xc = silu(xc)
    y, h = _mamba_core(p, xc, z, cfg, h0=cache["ssm"], mesh=run)
    return _out(p, y, cfg, mesh), {"conv": conv_state, "ssm": h}


# ---------------------------------------------------------------------------
# mLSTM (chunkwise-parallel linear attention with exp input / sig forget gate)
# ---------------------------------------------------------------------------

MLSTM_CHUNK = 256
_LOG_FLOOR = -30.0


def init_mlstm(cfg, generator, device):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    return {
        "w_qkv": _normal((d, 3 * di), d ** -0.5, generator, device),
        "w_gates": _normal((d, 2 * cfg.num_heads), d ** -0.5, generator,
                           device, F32),
        "out_proj": _normal((di, d), di ** -0.5, generator, device),
    }


def _mlstm_chunk_scan(q, k, v, li, lf, C0, n0, final_state=True):
    """q,k,v: [B,H,S,dh]; li,lf: [B,H,S] log input / log-sigmoid forget gates.
    Chunkwise linear attention: returns h [B,H,S,dh] f32, final (C, n).
    ``final_state=False`` skips the last chunk's state update, which
    nothing reads then (XLA drops it from the reference's compiled scan as
    dead code), and returns ``(h, None)``.

    Chunks of ``MLSTM_CHUNK`` without padding: the reference reshapes S
    into ``S // c`` chunks, so it takes S <= 256 or a multiple of 256, and
    the port refuses the lengths it would fail on."""
    B, H, S, dh = q.shape
    c = min(MLSTM_CHUNK, S)
    if S % c:
        raise ValueError(f"mLSTM forward over {S} steps: the chunked scan "
                         f"takes S <= {MLSTM_CHUNK} or a multiple of it")
    scale = dh ** -0.5
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    C, n = C0, n0
    hs = []
    for start in range(0, S, c):
        sl = slice(start, start + c)
        qi, ki, vi = q[:, :, sl].float(), k[:, :, sl].float(), \
            v[:, :, sl].float()
        ii, fi = li[..., sl], lf[..., sl]
        b = torch.cumsum(fi, dim=-1)  # [B,H,c] decay from chunk start
        btot = b[..., -1:]
        # intra-chunk: w_ij = exp(b_i - b_j + i_j) for j <= i
        logw = torch.clamp(b[..., :, None] - b[..., None, :]
                           + ii[..., None, :], _LOG_FLOOR, 20.0)
        w = torch.where(tri, torch.exp(logw), 0.0)
        ws = w * (torch.einsum("bhqd,bhkd->bhqk", qi, ki) * scale)
        h_intra = torch.einsum("bhqk,bhkd->bhqd", ws, vi)
        # inter-chunk: decayed carried state
        lam = torch.exp(torch.clamp(b, _LOG_FLOOR, 0.0))  # [B,H,c]
        qs = qi * scale
        h_inter = torch.einsum("bhqd,bhde->bhqe", qs, C) * lam[..., None]
        n_q = torch.einsum("bhqd,bhd->bhq", qs, n) * lam
        n_intra = ws.sum(dim=-1)
        denom = torch.clamp(torch.abs(n_q + n_intra), min=1.0)
        hs.append((h_intra + h_inter) / denom[..., None])
        if not final_state and start + c == S:
            return torch.cat(hs, dim=2), None
        # state update
        g = torch.exp(torch.clamp(btot - b + ii, _LOG_FLOOR, 20.0))
        decay = torch.exp(torch.clamp(btot, _LOG_FLOOR, 0.0))  # [B,H,1]
        C = decay[..., None] * C + torch.einsum(
            "bhkd,bhke->bhde", g[..., None] * ki, vi)
        n = decay * n + torch.einsum("bhkd,bhk->bhd", ki, g)
    h = torch.cat(hs, dim=2)
    return h, (C, n)


def _mlstm_inputs(p, x, cfg, mesh=None):
    """q, k [B,Hl,S,dh] and v [B,Hl,S,dv] (bf16) of this rank's ``Hl``
    heads (``dv``: the value channels it holds of each), and their f32
    gate pre-activations [B,S,2Hl] (input gates, then forget gates).  One
    device: every head, ``dv = dh``.  On a mesh the heads split over the
    model axis where they divide it; where the axis (n) is wider, the
    rank's channels lie inside head ``index // (n / H)``: q and k are
    gathered over the axis (the rank's head needs its whole q and k) and
    v keeps the rank's block.  Each rank takes the gates of its heads
    from the replicated ``w_gates`` product."""
    B, S, d = x.shape
    H = cfg.num_heads
    di = cfg.ssm_expand * d
    dh = di // H
    split = _split(p, cfg)
    if split:
        x = LM.copy_to(x, mesh)
    qkv = torch.einsum("bsd,de->bse", x, p["w_qkv"])
    gates = torch.einsum("bsd,dg->bsg", x.float(),
                         LM.copy_to(p["w_gates"], mesh) if split
                         else p["w_gates"])
    if not split:
        q, k, v = (t.reshape(B, S, H, dh).transpose(1, 2)
                   for t in torch.chunk(qkv, 3, dim=-1))
        return q, k, v, gates
    n, r = LM.model_size(mesh), mesh.axis_index("model")
    dl = qkv.shape[-1] // 3
    q, k, v = torch.chunk(qkv, 3, dim=-1)
    if H % n == 0:  # the rank's H / n heads
        Hl = H // n
        first = r * Hl
        q, k, v = (t.reshape(B, S, Hl, dh).transpose(1, 2)
                   for t in (q, k, v))
    elif n % H == 0:  # one head on each group of n / H ranks
        m = n // H
        Hl, first = 1, r // m
        qk = LM.gather_from(torch.cat([q, k], -1), mesh, "model", 2,
                            summed=True).unflatten(-1, (n, 2, dl))
        qk = qk[:, :, first * m:(first + 1) * m]  # [B,S,m,2,dl]
        q, k = (qk[..., i, :].reshape(B, S, 1, dh).transpose(1, 2)
                for i in (0, 1))
        v = v.reshape(B, S, 1, dl).transpose(1, 2)
    else:
        raise ValueError(f"mLSTM: {H} heads over a model axis of {n}: "
                         "neither divides the other")
    heads = list(range(first, first + Hl))
    return q, k, v, gates[..., heads + [H + h for h in heads]]


def mlstm_fwd(p, x, cfg, want_cache=False, mesh=None):
    B, S, d = x.shape
    q, k, v, gates = _mlstm_inputs(p, x, cfg, mesh)
    Hl, dh, dv = q.shape[1], q.shape[3], v.shape[3]
    li = gates[..., :Hl].transpose(1, 2)  # log input gate (pre-exp)
    lf = F.logsigmoid(gates[..., Hl:]).transpose(1, 2)
    C0 = torch.zeros((B, Hl, dh, dv), dtype=F32, device=x.device)
    n0 = torch.zeros((B, Hl, dh), dtype=F32, device=x.device)
    h, state = _mlstm_chunk_scan(q, k, v, li, lf, C0, n0,
                                 final_state=want_cache)
    h = h.transpose(1, 2).reshape(B, S, Hl * dv).to(x.dtype)
    out = _out(p, h, cfg, mesh)
    if want_cache:
        C, n = state
        return out, {"C": C, "n": n}
    return out


def mlstm_init_cache(cfg, batch, device, lead=()):
    H = cfg.num_heads
    dh = cfg.ssm_expand * cfg.d_model // H
    return {"C": torch.zeros(lead + (batch, H, dh, dh), dtype=F32,
                             device=device),
            "n": torch.zeros(lead + (batch, H, dh), dtype=F32, device=device)}


def mlstm_decode(p, x, cache, cfg, mesh=None):
    B = x.shape[0]
    q, k, v, gates = _mlstm_inputs(p, x, cfg, mesh)
    Hl, dh = q.shape[1], q.shape[3]
    gates = gates[:, 0]
    li, lf = gates[:, :Hl], F.logsigmoid(gates[:, Hl:])
    f = torch.exp(torch.clamp(lf, _LOG_FLOOR, 0.0))[..., None]
    i = torch.exp(torch.clamp(li, _LOG_FLOOR, 20.0))[..., None]
    kf = k[:, :, 0].float()
    C = f[..., None] * cache["C"] + i[..., None] * kf[..., None] * \
        v[:, :, 0].float()[..., None, :]
    n = f * cache["n"] + i * kf
    qf = q[:, :, 0].float() * dh ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), min=1.0)
    h = (num / den[..., None]).reshape(B, 1, -1).to(x.dtype)
    return _out(p, h, cfg, mesh), {"C": C, "n": n}


# ---------------------------------------------------------------------------
# sLSTM (sequential scalar recurrence, diagonal recurrent weights)
# ---------------------------------------------------------------------------


def init_slstm(cfg, generator, device):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    return {
        "w_qkv": _normal((d, 4 * di), d ** -0.5, generator, device),
        "r_gates": _normal((4 * di,), 0.1, generator, device, F32),
        "out_proj": _normal((di, d), di ** -0.5, generator, device),
    }


def _slstm_r(p, cfg, mesh):
    """The recurrent weights [4, dl] of this rank's ``dl`` channels (each
    gate's; the replicated ``r_gates`` enter through ``copy_to`` where
    the mixer is split)."""
    r = p["r_gates"].view(4, cfg.ssm_expand * cfg.d_model)
    if not _split(p, cfg):
        return r
    dl = p["out_proj"].shape[0]
    return LM.copy_to(r, mesh).narrow(1, mesh.axis_index("model") * dl, dl)


def _slstm_step(r, state, u):
    c, n, m, h = state
    di = r.shape[1]
    pre = u.float() + (h[..., None, :] * r).flatten(-2)
    zt = torch.tanh(pre[..., :di])
    it = pre[..., di:2 * di]
    ft = pre[..., 2 * di:3 * di]
    ot = torch.sigmoid(pre[..., 3 * di:])
    m_new = torch.maximum(ft + m, it)
    ip = torch.exp(torch.clamp(it - m_new, _LOG_FLOOR, 0.0))
    fp = torch.exp(torch.clamp(ft + m - m_new, _LOG_FLOOR, 0.0))
    c_new = fp * c + ip * zt
    n_new = fp * n + ip
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, m_new, h_new)


def _slstm_in(p, x, cfg, mesh):
    """The gate pre-activations [B,S,4dl] of this rank's channels and
    their recurrent weights."""
    if _split(p, cfg):
        x = LM.copy_to(x, mesh)
    return torch.einsum("bsd,de->bse", x, p["w_qkv"]), _slstm_r(p, cfg, mesh)


def slstm_fwd(p, x, cfg, want_cache=False, mesh=None):
    B, S, d = x.shape
    u, r = _slstm_in(p, x, cfg, mesh)  # [B,S,4di]
    state = tuple(torch.zeros((B, r.shape[1]), dtype=F32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        state = _slstm_step(r, state, u[:, t])
        hs.append(state[3])
    h = torch.stack(hs, dim=1).to(x.dtype)  # [B,S,di]
    out = _out(p, h, cfg, mesh)
    if want_cache:
        c, n, m, hf = state
        return out, {"c": c, "n": n, "m": m, "h": hf}
    return out


def slstm_init_cache(cfg, batch, device, lead=()):
    di = cfg.ssm_expand * cfg.d_model
    return {k: torch.zeros(lead + (batch, di), dtype=F32, device=device)
            for k in ("c", "n", "m", "h")}


def slstm_decode(p, x, cache, cfg, mesh=None):
    u, r = _slstm_in(p, x, cfg, mesh)
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = _slstm_step(r, state, u[:, 0])
    out = torch.einsum("be,ed->bd", h.to(x.dtype), p["out_proj"])[:, None]
    return _summed(p, out, cfg, mesh), {"c": c, "n": n, "m": m, "h": h}
