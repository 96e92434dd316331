"""The port's optimizer substrate against the JAX reference, on the CPU.

The twin of ``tests/test_optim.py``, on the same numpy trees for both
packages (f32 and bf16 leaves, 1-D and stacked 2-D/3-D leaves), the
reference run op by op as its own tests run it:

* ``adamw`` (decay skipped on 1-D leaves), ``sgd``, ``clip_by_global_norm``,
  ``scale_by_schedule`` and ``chain`` over five steps: every update,
  parameter and moment within four f32 ulps of the reference's on f32
  leaves (the global norm's and ``cos``'s last bits differ between XLA
  and torch; measured: at most 3 ulps), and bit for bit on bf16 leaves;
* the schedules at every step of a run, within four f32 ulps (measured:
  2 ulps, cosine's ``cos``);
* int8 quantization: payloads and f16 scales bit-equal, the round trip
  within the reference's bound;
* ``compressed_psum`` (replicas stacked on a leading axis) against the sum
  of the reference's dequantized blocks, and error feedback (the
  reference's bias test, at one and at four replicas).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as RO
from repro_torch import optim as TO
from repro_torch.models.model import _tensor

F32_ULPS = 4 * 2.0 ** -23  # four f32 ulps, relative


def _trees(rng):
    """A parameter-like tree as (reference arrays, port tensors)."""
    spec = {"w": ((8, 16), np.float32), "scale": ((16,), np.float32),
            "h": ((16, 8), jnp.bfloat16),
            "slots": {"wq": ((2, 8, 4), jnp.bfloat16),
                      "norm": ((2, 8), np.float32)}}

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        shape, dtype = node
        return jnp.asarray(rng.standard_normal(shape), dtype)

    ref = build(spec)
    return ref, _port(ref)


def _port(tree):
    if isinstance(tree, dict):
        return {k: _port(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_port(v) for v in tree)
    return _tensor(np.asarray(tree))


def _close(got, want, what):
    """bf16 leaves bit for bit; f32 within four f32 ulps of each value
    (and of the leaf's largest magnitude near zero)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}")
        return
    if isinstance(want, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}/{i}")
        return
    w = np.asarray(want).astype(np.float32)
    g = got.float().numpy()
    assert g.shape == w.shape, what
    if got.dtype == torch.bfloat16:
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        tol = F32_ULPS * (np.abs(w) + np.abs(w).max())
        assert np.all(np.abs(g - w) <= tol), (what, np.abs(g - w).max())


def _run(make, steps=5, seed=0):
    """``steps`` updates of the transform ``make(O)`` in both packages on
    the same trees and gradients; every update, parameter and state held
    together after each step."""
    rng = np.random.default_rng(seed)
    rp, tp = _trees(rng)
    ropt, topt = make(RO), make(TO)
    rs, ts = ropt.init(rp), topt.init(tp)
    for i in range(steps):
        rg, tg = _trees(rng)
        ru, rs = ropt.update(rg, rs, rp)
        tu, ts = topt.update(tg, ts, tp)
        _close(tu, ru, f"updates {i}")
        rp, tp = RO.apply_updates(rp, ru), TO.apply_updates(tp, tu)
        _close(tp, rp, f"params {i}")
        _close(ts, rs, f"state {i}")


@pytest.mark.parametrize("name,make", [
    ("adamw", lambda O: O.adamw(O.wsd_schedule(1e-2, 2, 5))),
    ("adamw_bf16_moments", lambda O: O.adamw(
        O.constant_schedule(1e-2), weight_decay=0.5,
        mu_dtype=jnp.bfloat16 if O is RO else torch.bfloat16,
        nu_dtype=jnp.bfloat16 if O is RO else torch.bfloat16)),
    ("sgd", lambda O: O.sgd(O.cosine_schedule(1e-2, 2, 5))),
    ("clip_adamw", lambda O: O.chain(O.clip_by_global_norm(1.0),
                                     O.adamw(O.constant_schedule(3e-3)))),
    ("scale_by_schedule", lambda O: O.chain(
        O.clip_by_global_norm(0.5), O.scale_by_schedule(
            O.wsd_schedule(1.0, 1, 5, decay_frac=0.4)))),
])
def test_transforms_equal_reference(name, make):
    _run(make)


def test_no_weight_decay_on_1d():
    opt = TO.adamw(TO.constant_schedule(1e-2), weight_decay=1.0)
    params = {"scale": torch.ones(8), "w": torch.ones(2, 8)}
    updates, _ = opt.update({k: torch.zeros_like(v) for k, v in
                             params.items()}, opt.init(params), params)
    assert not torch.any(updates["scale"])  # zero grad, no decay
    assert torch.all(updates["w"] < 0)  # a stacked 2-D leaf decays


def test_clip_by_global_norm():
    clip = TO.clip_by_global_norm(1.0)
    g = {"a": torch.full((4,), 10.0), "b": torch.full((4,), -10.0)}
    out, _ = clip.update(g, clip.init(g))
    np.testing.assert_allclose(float(TO.global_norm(out)), 1.0, rtol=1e-5)
    g2 = {"a": torch.full((4,), 0.01), "b": torch.full((4,), 0.01)}
    out2, _ = clip.update(g2, clip.init(g2))
    np.testing.assert_allclose(out2["a"].numpy(), 0.01, rtol=1e-6)


@pytest.mark.parametrize("name,make", [
    ("wsd", lambda O: O.wsd_schedule(1.0, warmup=10, total=100,
                                     decay_frac=0.2)),
    ("wsd_floor", lambda O: O.wsd_schedule(3e-4, warmup=0, total=37,
                                           floor_frac=0.1)),
    ("cosine", lambda O: O.cosine_schedule(1.0, warmup=10, total=100)),
    ("constant", lambda O: O.constant_schedule(2.5e-4)),
])
def test_schedules_equal_reference(name, make):
    rf, tf = make(RO), make(TO)
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.array([float(rf(jnp.asarray(s))) for s in steps], np.float32)
    got = np.array([float(tf(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    assert np.all(np.abs(got - want) <= F32_ULPS * np.abs(want)), name


def test_schedules_reference_points():
    wsd = TO.wsd_schedule(1.0, warmup=10, total=100, decay_frac=0.2)
    at = lambda f, s: float(f(torch.tensor(s, dtype=torch.int32)))
    np.testing.assert_allclose(at(wsd, 0), 0.1)
    np.testing.assert_allclose(at(wsd, 10), 1.0)
    np.testing.assert_allclose(at(wsd, 50), 1.0)
    assert at(wsd, 99) < 0.1
    cos = TO.cosine_schedule(1.0, warmup=10, total=100)
    np.testing.assert_allclose(at(cos, 4), 0.5)
    assert 0.09 < at(cos, 100) < 0.11


@pytest.mark.parametrize("n", [1, 255, 256, 777, 4096])
def test_quantize_equals_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 10).astype(np.float32)
    x[::17] = 0.0
    rq, rs = RO.quantize_int8(jnp.asarray(x))
    tq, ts = TO.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    back = TO.dequantize_int8(tq, ts, (n,))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(RO.dequantize_int8(rq, rs, (n,))))
    bound = np.abs(x).max() * (1 / 254 + 1e-3) + 1e-6
    assert np.abs(back.numpy() - x).max() <= bound


@pytest.mark.parametrize("P", [1, 2, 4])
def test_compressed_psum_equals_sum_of_reference_blocks(P):
    rng = np.random.default_rng(P)
    x = rng.normal(size=(P, 33, 40)).astype(np.float32)
    want = np.zeros((33, 40), np.float32)
    for xi in x:
        q, s = RO.quantize_int8(jnp.asarray(xi))
        want = want + np.asarray(RO.dequantize_int8(q, s, xi.shape))
    got = TO.compressed_psum(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    bf = TO.compressed_psum(torch.from_numpy(x).to(torch.bfloat16))
    assert bf.dtype == torch.bfloat16 and bf.shape == (33, 40)


@pytest.mark.parametrize("P", [1, 4])
def test_error_feedback_reduces_bias(P):
    """tests/test_optim.py's bias test: with EF, 50 steps of tiny grads
    transmit 50 x the grad within 5%, per replica."""
    ef_init, ef_apply = TO.make_error_feedback()
    g = {"w": torch.full((P, 256), 0.001)}
    res = ef_init(g)
    total = torch.zeros(256)
    for _ in range(50):
        sent, res = ef_apply(g, res)
        total = total + sent["w"]
    np.testing.assert_allclose(total.numpy(), P * 50 * 0.001 * np.ones(256),
                               rtol=0.05)
    assert res["w"].shape == (P, 256)
