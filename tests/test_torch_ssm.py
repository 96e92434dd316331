"""The port's sequence mixers (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``), on the CPU.

The twin of ``tests/test_ssm.py``, at its sizes (d_model 32, 4 heads,
state 8, conv 4, expand 2, batch 2), on parameters drawn by the
reference's ``init_*`` and carried across bit for bit, and inputs made
from a seed:

* init: the reference's leaves, shapes and dtypes (the f32 ``w_dt``,
  ``w_gates`` and ``r_gates``), its constants (``b_dt``, ``a_log``,
  ``d_skip``, ``conv_b``) bit for bit;
* forward outputs (bf16): max |err| within 1e-2 of max |ref|, the
  reference's bf16 bound (``tests/test_serve.py:33``); the final states
  (f32): within 1e-3 of max |ref|, the conv state (copied bf16 inputs)
  equal;
* decode, step by step from a zero cache and from the forward's cache:
  every output within 1e-2 of max |ref|, every state within 1e-3;
* the reference's own properties on the port: forward against its own
  decode (``test_ssm``'s tolerances), mamba across the chunk boundary
  (S = 300: two chunks of 256) and at odd length, mLSTM stable over 512
  steps and refusing the lengths the reference's reshape fails on.

Worst cases measured on the CPU: outputs 2.3e-4 of max |ref| (mamba,
S = 300), 1.0e-3 (mLSTM, S = 512), 0 (sLSTM); states 1.0e-5 (mLSTM's C
after 512 steps), 2.4e-6 (mamba).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RS
from repro.models.config import ModelConfig as RConfig
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.config import ModelConfig as TConfig

BF16_BOUND = 1e-2  # tests/test_serve.py:33: "bf16 path, 2 ulp"
STATE_BOUND = 1e-3
_KW = dict(name="t", family="ssm", num_layers=1, d_model=32, num_heads=4,
           num_kv_heads=4, d_ff=0, vocab_size=64,
           layer_pattern=(("mamba", "none"),), ssm_state=8, ssm_conv=4,
           ssm_expand=2, remat="none")
RCFG, TCFG = RConfig(**_KW), TConfig(**_KW)
MIXERS = ("mamba", "mlstm", "slstm")
KEY = {"mamba": 1, "mlstm": 2, "slstm": 4}  # test_ssm's init keys


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    return err / scale if scale else err  # a zero state: equal


def _port(tree):
    return {k: TM._tensor(np.asarray(v)) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _params(mixer):
    rp = getattr(RS, "init_" + mixer)(jax.random.key(KEY[mixer]), RCFG)
    return rp, _port(rp)


def _x(S, seed, B=2):
    """test_ssm's inputs: N(0, 1) in f32 rounded to bf16, for both."""
    r = jax.random.normal(jax.random.key(seed), (B, S, 32),
                          jnp.float32).astype(jnp.bfloat16)
    return r, TM._tensor(np.asarray(r))


@functools.lru_cache(maxsize=None)
def _ref_fwd(mixer):
    fwd = getattr(RS, mixer + "_fwd")
    return jax.jit(lambda p, x: fwd(p, x, RCFG, want_cache=True))


@functools.lru_cache(maxsize=None)
def _ref_decode(mixer):
    dec = getattr(RS, mixer + "_decode")
    return jax.jit(lambda p, x, c: dec(p, x, c, RCFG))


def _check_states(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        assert str(got[k].dtype).removeprefix("torch.") == \
            str(want[k].dtype), (what, k)
        assert _rel(got[k], want[k]) <= STATE_BOUND, (what, k)


def _decode_run(mixer, rx, tx, rc, tc):
    """Teacher-forced decode of every position of ``rx``/``tx`` in both
    packages from the caches given; checks each step."""
    rp, tp = _params(mixer)
    dec = getattr(TS, mixer + "_decode")
    outs = []
    for t in range(rx.shape[1]):
        want, rc = _ref_decode(mixer)(rp, rx[:, t:t + 1], rc)
        got, tc = dec(tp, tx[:, t:t + 1], tc, TCFG)
        assert got.shape == (2, 1, 32) and got.dtype == torch.bfloat16
        assert _rel(got, want) < BF16_BOUND, (mixer, t)
        _check_states(tc, rc, f"{mixer} step {t}")
        outs.append(got)
    return torch.cat(outs, dim=1), tc


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_leaves_equal_reference(mixer):
    rp, _ = _params(mixer)
    init = getattr(TS, "init_" + mixer)
    for tp in (init(TCFG, None, "meta"),
               init(TCFG, torch.Generator().manual_seed(0), "cpu")):
        assert sorted(tp) == sorted(rp)
        for k, r in rp.items():
            assert tuple(tp[k].shape) == tuple(r.shape), k
            assert str(tp[k].dtype).removeprefix("torch.") == str(r.dtype), k
    for k in ("b_dt", "d_skip", "conv_b"):
        if k in rp:
            assert np.array_equal(_np(tp[k]), _np(rp[k])), k
    if "a_log" in rp:  # log(1..N): torch's log and XLA's differ by an ulp
        np.testing.assert_allclose(_np(tp["a_log"]), _np(rp["a_log"]),
                                   rtol=2.4e-7, atol=0)
    # the random leaves at the reference's scales (within a tenth), drawn
    # at d_model 512 so that each leaf has a thousand values or more
    wide = dict(_KW, d_model=512)
    rw = getattr(RS, "init_" + mixer)(jax.random.key(0), RConfig(**wide))
    tw = init(TConfig(**wide), torch.Generator().manual_seed(0), "cpu")
    for k, r in rw.items():
        if k not in ("b_dt", "a_log", "d_skip", "conv_b"):
            want, got = float(_np(r).std()), float(_np(tw[k]).std())
            assert abs(got - want) <= 0.1 * want, k


@pytest.mark.parametrize("mixer,S", [("mamba", 16), ("mamba", 7),
                                     ("mamba", 300), ("mlstm", 16),
                                     ("mlstm", 512), ("slstm", 16)])
def test_fwd_and_cache_vs_reference(mixer, S):
    rp, tp = _params(mixer)
    rx, tx = _x(S, 3)
    want, rc = _ref_fwd(mixer)(rp, rx)
    got, tc = getattr(TS, mixer + "_fwd")(tp, tx, TCFG, want_cache=True)
    assert got.shape == tx.shape and got.dtype == torch.bfloat16
    assert _rel(got, want) < BF16_BOUND
    _check_states(tc, rc, f"{mixer} S={S}")
    if mixer == "mamba":  # the last K-1 inputs, copied
        assert np.array_equal(_np(tc["conv"]), _np(rc["conv"]))
    assert torch.equal(getattr(TS, mixer + "_fwd")(tp, tx, TCFG), got)


@pytest.mark.parametrize("mixer", MIXERS)
def test_decode_vs_reference(mixer):
    """16 steps from a zero cache, then 8 more from the forward's cache
    over those 16 (the prefill a server would hand to decode)."""
    rp, tp = _params(mixer)
    rx, tx = _x(16, 5)
    rc = getattr(RS, mixer + "_init_cache")(RCFG, 2)
    tc = getattr(TS, mixer + "_init_cache")(TCFG, 2, "cpu")
    _check_states(tc, rc, "init")
    _decode_run(mixer, rx, tx, rc, tc)
    rnext, tnext = _x(8, 6)
    _, rc = _ref_fwd(mixer)(rp, rx)
    _, tc = getattr(TS, mixer + "_fwd")(tp, tx, TCFG, want_cache=True)
    _decode_run(mixer, rnext, tnext, rc, tc)


@pytest.mark.parametrize("mixer,tol", [("mamba", 5e-2), ("mlstm", 6e-2),
                                       ("slstm", 5e-2)])
def test_fwd_decode_consistency(mixer, tol):
    """test_ssm's check on the port: the parallel forward equals the
    step-by-step recurrence within the reference's tolerance."""
    _, tp = _params(mixer)
    _, tx = _x(16, 3)
    full = getattr(TS, mixer + "_fwd")(tp, tx, TCFG)
    cache = getattr(TS, mixer + "_init_cache")(TCFG, 2, "cpu")
    outs = []
    for t in range(16):
        o, cache = getattr(TS, mixer + "_decode")(tp, tx[:, t:t + 1], cache,
                                                  TCFG)
        outs.append(o)
    np.testing.assert_allclose(_np(full), _np(torch.cat(outs, 1)),
                               rtol=tol, atol=tol)


def test_mamba_decode_is_one_step_of_the_recurrence():
    """The decode step is ``_mamba_core`` at S = 1 from ``h0``: it must
    equal ``h = exp(dt A) h0 + dt x B`` written out, bit for bit."""
    _, tp = _params("mamba")
    g = torch.Generator().manual_seed(0)
    xc = torch.randn((2, 1, 64), generator=g).to(torch.bfloat16)
    z = torch.randn((2, 1, 64), generator=g).to(torch.bfloat16)
    h0 = torch.randn((2, 64, 8), generator=g)
    y, h = TS._mamba_core(tp, xc, z, TCFG, h0=h0)
    xf = xc[:, 0].float()
    bc = torch.einsum("bd,dn->bn", xc[:, 0], tp["w_bc"]).float()
    dt = torch.nn.functional.softplus(xf * tp["w_dt"] + tp["b_dt"])
    A = -torch.exp(tp["a_log"])
    want = (dt * xf)[..., None] * bc[:, None, :8] + \
        torch.exp(dt[..., None] * A) * h0
    assert torch.equal(h, want)
    yw = torch.einsum("bdn,bn->bd", want, bc[:, 8:]) + tp["d_skip"] * xf
    yw = yw.to(torch.bfloat16).float() * TS.silu(z[:, 0].float())
    assert torch.equal(y[:, 0], yw.to(torch.bfloat16))


def test_mamba_across_the_chunk_boundary_then_decode():
    """S = 300 crosses MAMBA_CHUNK (two chunks, the second padded): the
    forward's state carried into decode matches the reference's."""
    assert TS.MAMBA_CHUNK == RS.MAMBA_CHUNK == 256
    rp, tp = _params("mamba")
    rx, tx = _x(300, 7)
    _, rc = _ref_fwd("mamba")(rp, rx)
    out, tc = TS.mamba_fwd(tp, tx, TCFG, want_cache=True)
    assert not bool(torch.isnan(out.float()).any())
    rnext, tnext = _x(4, 8)
    _decode_run("mamba", rnext, tnext, rc, tc)


def test_mlstm_long_sequence_stability_and_chunking():
    assert TS.MLSTM_CHUNK == RS.MLSTM_CHUNK == 256
    assert TS._LOG_FLOOR == RS._LOG_FLOOR
    _, tp = _params("mlstm")
    _, tx = _x(512, 9)
    out = TS.mlstm_fwd(tp, tx, TCFG)
    assert not bool(torch.isnan(out.float()).any())
    assert float(out.float().abs().max()) < 1e3
    # no padding: a length the reference's reshape refuses, the port
    # refuses too
    rp, _ = _params("mlstm")
    rx, tx = _x(300, 9)
    with pytest.raises(TypeError):
        RS.mlstm_fwd(rp, rx, RCFG)
    with pytest.raises(ValueError, match="multiple of it"):
        TS.mlstm_fwd(tp, tx, TCFG)


@pytest.mark.parametrize("mixer", MIXERS)
def test_init_cache_equal_reference(mixer):
    for lead in ((), (3,)):
        tc = getattr(TS, mixer + "_init_cache")(TCFG, 5, "meta", lead)
        rc = getattr(RS, mixer + "_init_cache")(RCFG, 5)
        assert sorted(tc) == sorted(rc)
        for k in rc:
            assert tuple(tc[k].shape) == lead + tuple(rc[k].shape)
            assert str(tc[k].dtype).removeprefix("torch.") == \
                str(rc[k].dtype)
