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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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


def _mamba_core(p, xc, z, cfg, h0=None):
    """xc: [B,S,di] post-conv; returns y [B,S,di] and final state [B,di,N].

    The sequence is padded to a multiple of the chunk; each chunk folds the
    carried state into its first step (``Bx[:, 0] += Ad[:, 0] * h``) and
    runs the recurrence over its ``c`` steps, peaking at [B,c,di,N] f32.
    The final state is the one after the padded steps, as the reference
    returns it (each zero step decays it: past one chunk it is not the
    state after S steps).  At S = 1 (decode) this is one step of the
    recurrence from ``h0``.
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
        bc = torch.einsum("bsd,dn->bsn", xci, p["w_bc"]).float()
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


def mamba_fwd(p, x, cfg, want_cache=False):
    di = cfg.ssm_expand * cfg.d_model
    u = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = u[..., :di], u[..., di:]
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"])
    xc = silu(xc)
    y, h = _mamba_core(p, xc, z, cfg)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if want_cache:
        return out, {"conv": conv_state.to(PDT), "ssm": h}
    return out


def mamba_init_cache(cfg, batch, device, lead=()):
    di = cfg.ssm_expand * cfg.d_model
    return {"conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, di),
                                dtype=PDT, device=device),
            "ssm": torch.zeros(lead + (batch, di, cfg.ssm_state), dtype=F32,
                               device=device)}


def mamba_decode(p, x, cache, cfg):
    """x: [B,1,d]; single-step recurrence.  Returns (out, new cache)."""
    di = cfg.ssm_expand * cfg.d_model
    u = torch.einsum("bsd,de->bse", x, p["in_proj"])
    xin, z = u[..., :di], u[..., di:]
    xc, conv_state = _causal_conv(xin, p["conv_w"], p["conv_b"],
                                  cache["conv"])
    xc = silu(xc)
    y, h = _mamba_core(p, xc, z, cfg, h0=cache["ssm"])
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    return out, {"conv": conv_state, "ssm": h}


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


def _mlstm_inputs(p, x, cfg):
    """q, k, v [B,H,S,dh] (bf16) and the f32 gate pre-activations [B,S,2H]."""
    B, S, d = x.shape
    H = cfg.num_heads
    dh = cfg.ssm_expand * d // H
    qkv = torch.einsum("bsd,de->bse", x, p["w_qkv"])
    q, k, v = (t.reshape(B, S, H, dh).transpose(1, 2)
               for t in torch.chunk(qkv, 3, dim=-1))
    gates = torch.einsum("bsd,dg->bsg", x.float(), p["w_gates"])
    return q, k, v, gates


def mlstm_fwd(p, x, cfg, want_cache=False):
    B, S, d = x.shape
    H = cfg.num_heads
    di = cfg.ssm_expand * d
    dh = di // H
    q, k, v, gates = _mlstm_inputs(p, x, cfg)
    li = gates[..., :H].transpose(1, 2)  # log input gate (pre-exp)
    lf = F.logsigmoid(gates[..., H:]).transpose(1, 2)
    C0 = torch.zeros((B, H, dh, dh), dtype=F32, device=x.device)
    n0 = torch.zeros((B, H, dh), dtype=F32, device=x.device)
    h, state = _mlstm_chunk_scan(q, k, v, li, lf, C0, n0,
                                 final_state=want_cache)
    h = h.transpose(1, 2).reshape(B, S, di).to(x.dtype)
    out = torch.einsum("bse,ed->bsd", h, p["out_proj"])
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


def mlstm_decode(p, x, cache, cfg):
    B = x.shape[0]
    H = cfg.num_heads
    di = cfg.ssm_expand * cfg.d_model
    dh = di // H
    q, k, v, gates = _mlstm_inputs(p, x, cfg)
    gates = gates[:, 0]
    li, lf = gates[:, :H], F.logsigmoid(gates[:, H:])
    f = torch.exp(torch.clamp(lf, _LOG_FLOOR, 0.0))[..., None]
    i = torch.exp(torch.clamp(li, _LOG_FLOOR, 20.0))[..., None]
    kf = k[:, :, 0].float()
    C = f[..., None] * cache["C"] + i[..., None] * kf[..., None] * \
        v[:, :, 0].float()[..., None, :]
    n = f * cache["n"] + i * kf
    qf = q[:, :, 0].float() * dh ** -0.5
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)), min=1.0)
    h = (num / den[..., None]).reshape(B, 1, di).to(x.dtype)
    return torch.einsum("bse,ed->bsd", h, p["out_proj"]), {"C": C, "n": n}


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


def _slstm_step(p, di, state, u):
    c, n, m, h = state
    r = p["r_gates"].view(4, di)
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


def slstm_fwd(p, x, cfg, want_cache=False):
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    u = torch.einsum("bsd,de->bse", x, p["w_qkv"])  # [B,S,4di]
    state = tuple(torch.zeros((B, di), dtype=F32, device=x.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        state = _slstm_step(p, di, state, u[:, t])
        hs.append(state[3])
    h = torch.stack(hs, dim=1).to(x.dtype)  # [B,S,di]
    out = torch.einsum("bse,ed->bsd", h, p["out_proj"])
    if want_cache:
        c, n, m, hf = state
        return out, {"c": c, "n": n, "m": m, "h": hf}
    return out


def slstm_init_cache(cfg, batch, device, lead=()):
    di = cfg.ssm_expand * cfg.d_model
    return {k: torch.zeros(lead + (batch, di), dtype=F32, device=device)
            for k in ("c", "n", "m", "h")}


def slstm_decode(p, x, cache, cfg):
    di = cfg.ssm_expand * cfg.d_model
    u = torch.einsum("bsd,de->bse", x, p["w_qkv"])[:, 0]
    state = (cache["c"], cache["n"], cache["m"], cache["h"])
    c, n, m, h = _slstm_step(p, di, state, u)
    out = torch.einsum("be,ed->bd", h.to(x.dtype), p["out_proj"])[:, None]
    return out, {"c": c, "n": n, "m": m, "h": h}
