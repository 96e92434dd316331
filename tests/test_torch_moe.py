"""The port's sort-by-destination MoE (``repro_torch.models.moe``) against
the JAX reference (``repro.models.moe``), on the CPU.

The twin of ``tests/test_moe.py`` (its configuration: d_model 32, expert
width 48), on parameters drawn by the reference's ``init_moe`` and carried
across bit for bit, and inputs made from a seed:

* the per-token oracle of ``test_moe`` (no capacity) at capacity factor
  8 on f32 parameters: within its 2e-3;
* ``moe_fwd_dense`` in bf16 against the reference's at E/k = 8/2, 4/1,
  16/2 and 384/8, capacity factors 1.25 and 0.01, T = 8 and 64 (drops
  in most cells): the output within 1e-2 of max |ref| (the reference's
  bf16 bound, ``tests/test_serve.py:33``; measured: 0, bit for bit), the
  aux loss within 1e-6 of it; the top-k indices, each slot's rank in its
  expert and the keep mask exact (the top-k where the k-th and the next
  gate are more than 1e-6 apart: a nearer pair may order either way
  under another f32 summation; none in these cells);
* ``_slot_positions`` against the reference's on random ids with the
  dummy bucket, and ``test_moe``'s example; capacity drops shrink the
  output; the uniform routing's aux loss; the capacity formula.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as RMOE
from repro.models.config import ModelConfig as RConfig
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models.config import ModelConfig as TConfig
from test_moe import oracle_moe

BF16_BOUND = 1e-2  # tests/test_serve.py:33: "bf16 path, 2 ulp"
TIE = 1e-6


def make_cfg(cls, E=8, k=2, cf=8.0):
    """test_moe's configuration."""
    return cls(name="t", family="moe", num_layers=2, d_model=32,
               num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
               layer_pattern=(("attn", "moe"),), num_experts=E, top_k=k,
               moe_d_ff=48, capacity_factor=cf, remat="none")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _params(E, k):
    rp = RMOE.init_moe(jax.random.key(0), make_cfg(RConfig, E, k))
    return rp, {n: TM._tensor(np.asarray(a)) for n, a in rp.items()}


def test_init_leaves_equal_reference():
    rp, _ = _params(8, 2)
    for tp in (TMOE.init_moe(make_cfg(TConfig), None, "meta"),
               TMOE.init_moe(make_cfg(TConfig),
                             torch.Generator().manual_seed(0), "cpu")):
        assert sorted(tp) == sorted(rp)
        for n, r in rp.items():
            assert tuple(tp[n].shape) == tuple(r.shape), n
            assert str(tp[n].dtype).removeprefix("torch.") == str(r.dtype), n
    # the reference's scales, within a tenth, at d_model 256 and 16
    # experts (a thousand values or more a leaf)
    wide = dict(d_model=256, num_experts=16)
    rw = RMOE.init_moe(jax.random.key(0),
                       dataclasses.replace(make_cfg(RConfig), **wide))
    tw = TMOE.init_moe(dataclasses.replace(make_cfg(TConfig), **wide),
                       torch.Generator().manual_seed(0), "cpu")
    for n, r in rw.items():
        want, got = float(_np(r).std()), float(_np(tw[n]).std())
        assert abs(got - want) <= 0.1 * want, n


def test_dense_matches_oracle():
    """test_moe's oracle at cf 8 (no drops) on f32 parameters and f32
    inputs: the port's whole path runs in f32 there."""
    rcfg, tcfg = make_cfg(RConfig), make_cfg(TConfig)
    rp, _ = _params(8, 2)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    tp = {n: TM._tensor(np.asarray(a)) for n, a in rp.items()}
    x = jax.random.normal(jax.random.key(1), (2, 8, 32), jnp.float32)
    got, aux = TMOE.moe_fwd_dense(tp, TM._tensor(np.asarray(x)), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), oracle_moe(rp, x, rcfg),
                               rtol=2e-3, atol=2e-3)
    want_out, want_aux = RMOE.moe_fwd_dense(rp, x, rcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    assert float(aux) > 0
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def _check_routing(tv, ti, tg, rv, ri, rg, k):
    """Top-k ids equal where the k-th gate clears the next by TIE; the
    gates, and the normalized top values, within f32 rounding.  Returns
    the number of tokens with a nearer pair."""
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-7)
    g = -np.sort(-np.asarray(rg), axis=-1)
    clear = (g[:, k - 1] - g[:, k]) > TIE
    assert np.array_equal(ti.numpy()[clear], np.asarray(ri)[clear])
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-7)
    return int((~clear).sum())


def _ref_run(p, x, cfg):
    """The reference's output, aux, routing and slot ranks, in one jit."""
    T = x.shape[0] * x.shape[1]
    out, aux = RMOE.moe_fwd_dense(p, x, cfg)
    rv, ri, rg = RMOE._route(x.reshape(T, -1), p["router"], cfg)
    e = ri.reshape(-1).astype(jnp.int32)
    return out, aux, rv, ri, rg, e, RMOE._slot_positions(e, cfg.num_experts)


@pytest.mark.parametrize("E,k,cf,T", [
    (8, 2, 1.25, 64), (4, 1, 1.25, 64), (8, 2, 0.01, 64), (16, 2, 1.25, 8),
    (384, 8, 1.25, 64),
])
def test_dense_vs_reference(E, k, cf, T):
    rcfg, tcfg = make_cfg(RConfig, E, k, cf), make_cfg(TConfig, E, k, cf)
    rp, tp = _params(E, k)
    rx = jax.random.normal(jax.random.key(T + E), (2, T // 2, 32),
                           jnp.float32).astype(jnp.bfloat16)
    tx = TM._tensor(np.asarray(rx))
    want, want_aux, rv, ri, rg, e, rpos = (
        np.array(a) for a in jax.jit(
            lambda p, x: _ref_run(p, x, rcfg))(rp, rx))
    got, aux = TMOE.moe_fwd_dense(tp, tx, tcfg)
    assert got.dtype == torch.bfloat16 and got.shape == tx.shape
    assert _rel(got, want) < BF16_BOUND
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)
    # routing, ranks and the keep mask
    tv, ti, tg = TMOE._route(tx.reshape(T, 32), tp["router"], tcfg)
    assert _check_routing(tv, ti, tg, rv, ri, rg, k) == 0
    C = TMOE.capacity(T, tcfg)
    assert C == RMOE.capacity(T, rcfg)
    pos, keep, flat = TMOE.dispatch_plan(torch.from_numpy(e).long(), E, C)
    assert np.array_equal(pos.numpy(), rpos)
    rkeep = (e < E) & (rpos < C)
    assert np.array_equal(keep.numpy(), rkeep)
    assert np.array_equal(flat.numpy(), np.where(rkeep, e * C + rpos, E * C))
    if cf < 1:
        assert not bool(keep.all())  # the drops this cell is for


def test_slot_positions_are_ranks():
    e = torch.tensor([2, 0, 2, 1, 0, 2])
    assert TMOE._slot_positions(e, 3).tolist() == [0, 0, 1, 0, 1, 2]
    rng = np.random.default_rng(0)
    for n, nb in ((1, 1), (64, 4), (1000, 16), (4096, 384)):
        ids = rng.integers(0, nb + 1, n).astype(np.int32)  # nb: dummy
        got = TMOE._slot_positions(torch.from_numpy(ids).long(), nb)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(),
                              np.asarray(RMOE._slot_positions(
                                  jnp.asarray(ids), nb)))


def test_routing_counts_run_on_meta():
    """``_slot_positions`` and ``_aux_loss`` count into fixed-size zeros
    (``scatter_add_``), not ``torch.bincount``, whose output size is read
    from the ids (a host sync on the card, no ``meta`` kernel): both run
    on ``meta`` tensors, and the counts equal ``bincount``'s."""
    e = torch.empty(4096, dtype=torch.int64, device="meta")
    pos = TMOE._slot_positions(e, 384)
    assert pos.device.type == "meta" and pos.shape == (4096,)
    tcfg = make_cfg(TConfig, E=8, k=2)
    aux = TMOE._aux_loss(torch.empty((64, 8), device="meta"),
                         torch.empty((64, 2), dtype=torch.int64,
                                     device="meta"), tcfg)
    assert aux.device.type == "meta" and aux.shape == ()
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 17, 999))
    assert torch.equal(TMOE._counts(ids, 17),
                       torch.bincount(ids, minlength=17))


def test_capacity_drops_tokens():
    """cf tiny -> most slots dropped -> output far smaller in norm."""
    _, tp = _params(8, 2)
    x = TM._tensor(np.asarray(jax.random.normal(
        jax.random.key(1), (2, 32, 32), jnp.bfloat16)))
    full, _ = TMOE.moe_fwd_dense(tp, x, make_cfg(TConfig, cf=100.0))
    tight, _ = TMOE.moe_fwd_dense(tp, x, make_cfg(TConfig, cf=0.01))
    assert float(tight.float().norm()) < float(full.float().norm())


def test_aux_loss_uniform_routing_is_one():
    tcfg, rcfg = make_cfg(TConfig, E=4, k=1), make_cfg(RConfig, E=4, k=1)
    T = 4096
    idx = np.random.default_rng(0).integers(0, 4, (T, 1))
    gates = np.ones((T, 4), np.float32) / 4
    aux = TMOE._aux_loss(torch.from_numpy(gates), torch.from_numpy(idx),
                         tcfg)
    np.testing.assert_allclose(float(aux), 1.0, rtol=0.1)
    want = RMOE._aux_loss(jnp.asarray(gates), jnp.asarray(idx), rcfg)
    np.testing.assert_allclose(float(aux), float(want), rtol=1e-6)


def test_capacity_formula():
    tcfg = make_cfg(TConfig, E=8, k=2, cf=1.0)
    assert TMOE.capacity(800, tcfg) == 201
    assert TMOE.capacity(1, tcfg) >= tcfg.top_k
    for E, k, cf in ((8, 2, 1.0), (16, 2, 1.25), (16, 1, 1.25),
                     (384, 8, 1.25), (4, 2, 0.01)):
        for T in (1, 2, 8, 33, 2048, 4096):
            assert TMOE.capacity(T, make_cfg(TConfig, E, k, cf)) == \
                RMOE.capacity(T, make_cfg(RConfig, E, k, cf))
    # the decode cells' capacities (T = B = 8) of the configured archs
    for E, k, C in ((16, 1, 1), (16, 2, 2)):
        assert TMOE.capacity(8, make_cfg(TConfig, E, k, 1.25)) == C


def test_moe_fwd_is_the_dense_path():
    """One device: the reference's expert-parallel branch needs a model
    mesh axis, so the port's moe_fwd is the dense path."""
    assert TMOE.moe_fwd is TMOE.moe_fwd_dense
    cfg = dataclasses.replace(make_cfg(TConfig), capacity_factor=1.25)
    _, tp = _params(8, 2)
    x = torch.randn((2, 4, 32), generator=torch.Generator().manual_seed(0))
    out, aux = TMOE.moe_fwd(tp, x.to(torch.bfloat16), cfg)
    assert out.shape == (2, 4, 32) and aux.dtype == torch.float32
