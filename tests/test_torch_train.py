"""The port's training step against the JAX reference, on the CPU.

The twins of ``tests/test_train.py`` and of the reference's loss and
gradient, at smoke size, on parameters drawn by the reference's
``init_params`` (kept in the reference's layout, the port's
``TrainState.params`` layout) and inputs made from a numpy seed
(``torch_train_cases``; jamba is in ``tests/test_torch_train_ssm.py``,
xlstm in ``tests/test_torch_train_xlstm.py``):

* the loss of gemma3, hubert (encoder: no shift) and paligemma (vision
  prefix): within 1e-3 of the jitted reference's; every gradient leaf:
  max |port - ref| within 3e-2 of max |ref|;
* hubert's embedding table, which its frontend bypasses: a zero gradient,
  and AdamW decays it, as the reference's does;
* the mLSTM chunk scan's backward alone, in f32: within 1e-5 of
  ``jax.vjp``'s (a formula fault would show here, bf16 conditioning not);
* the optimizer on the reference's own gradients: params and moments
  within one bf16 ulp of the reference's update;
* four train steps on both: the losses and gradient norms within 2e-2
  (step 1's Adam update is about -lr * sign(g), so parameters cannot
  agree bit for bit end to end);
* chunked against dense cross-entropy, microbatch equivalence, a falling
  loss, ``remat`` leaving every loss and gradient bit unchanged and the
  meta-device state (the port alone, as the reference's tests hold the
  reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro import optim as RO
from repro.models import ssm as RS
from repro.models import train as RT
from repro_torch import configs as TC
from repro_torch import optim as TO
from repro_torch.checkpoint.store import _leaves
from repro_torch.data import SyntheticLM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models import train as TT
from repro_torch.models.config import ModelConfig
from torch_train_cases import (B, S, as_f32, case, check_loss_and_grads,
                               check_remat_is_bit_neutral, port_leaves,
                               ref_leaves, to_port)

BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to a value's magnitude

CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=64,
                  num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=512)


@pytest.mark.parametrize("arch", ("gemma3-1b", "hubert-xlarge",
                                  "paligemma-3b"))
def test_loss_and_grads_vs_reference(arch):
    check_loss_and_grads(arch)


def test_hubert_embedding_gets_zero_grad_and_decays():
    """hubert's audio frontend bypasses the embedding: its gradient is
    zeros (``jax.grad``'s), and AdamW still decays the table and moves
    its moments, as the reference's does."""
    c = case("hubert-xlarge")
    _, grads = TT.value_and_grad(c.tp, c.tb, c.tcfg)
    assert not torch.any(grads["embed"]["table"])
    assert not np.any(as_f32(c.rgrads["embed"]["table"]))
    # AdamW alone on the table (its clip scale is the whole tree's)
    ropt, topt = (O.adamw(O.constant_schedule(1e-2)) for O in (RO, TO))
    rp, tp = c.rp["embed"], c.tp["embed"]
    want = as_f32(ropt.update(c.rgrads["embed"], ropt.init(rp), rp)[0]
                  ["table"])
    got = as_f32(topt.update(grads["embed"], topt.init(tp), tp)[0]["table"])
    assert np.any(want != 0)  # the decay moves a leaf with a zero grad
    np.testing.assert_array_equal(got, want)


def test_mlstm_chunk_scan_backward_f32():
    """The mLSTM chunk scan's vjp in f32 (two chunks, a carried state):
    torch autograd against ``jax.vjp`` within 1e-5 of each cotangent's
    magnitude.  The gate inputs sit on dyadic grids (input gates in
    [-2, 2] by 2^-6, forget gates in [-0.1, -2^-12] by 2^-12), so the
    gate scan -- a cumsum XLA adds in another order, whose rounding
    ``exp`` turns into relative errors past 1e-5 on continuous gates --
    is exact in either package; forget gates near one (as xLSTM
    initializes them) keep every clip bound untouched, where JAX splits
    a tie's gradient and torch does not.  What is left to differ is the
    formula and the products' rounding."""
    rng = np.random.default_rng(5)
    Bm, H, Sm, dh = 2, 2, 512, 8
    q, k, v = (rng.standard_normal((Bm, H, Sm, dh)).astype(np.float32)
               for _ in range(3))
    li = (rng.integers(-128, 129, (Bm, H, Sm)) / 64).astype(np.float32)
    lf = (-rng.integers(1, 410, (Bm, H, Sm)) / 4096).astype(np.float32)
    C0 = rng.standard_normal((Bm, H, dh, dh)).astype(np.float32)
    n0 = rng.standard_normal((Bm, H, dh)).astype(np.float32)
    arrs = (q, k, v, li, lf, C0, n0)
    out, vjp = jax.vjp(RS._mlstm_chunk_scan, *map(jnp.asarray, arrs))
    cot = jax.tree.map(
        lambda o: rng.standard_normal(o.shape).astype(np.float32), out)
    want = vjp(jax.tree.map(jnp.asarray, cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrs]
    h, (C, n) = TS._mlstm_chunk_scan(*ts)
    got = torch.autograd.grad(
        (h, C, n), ts, [torch.from_numpy(c) for c in (cot[0], *cot[1])])
    for name, g, w in zip(("q", "k", "v", "li", "lf", "C0", "n0"), got, want):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) \
            <= 1e-5 * float(np.abs(w).max()), name


def _ulp_close(got, want, what):
    """Within one bf16 ulp of each value (2^-7 of its magnitude, and 2^-16
    of the leaf's largest magnitude for values near zero)."""
    got, want = as_f32(got), as_f32(want)
    floor = float(np.abs(want).max()) * 2.0 ** -16
    bad = np.abs(got - want) > BF16_ULP * np.abs(want) + floor
    assert not bad.any(), (what, float(np.abs(got - want).max()))


def test_optimizer_on_reference_grads():
    """Two AdamW steps (clip, WSD warmup, decay on >1-D leaves) on the
    reference's own gradients (gemma3: bf16 projections, f32 norm
    scales), the reference's op by op as ``tests/test_optim.py`` runs it:
    params and moments within one bf16 ulp (measured: bf16 leaves bit for
    bit, f32 leaves within one f32 ulp).  Under ``jax.jit`` XLA keeps the
    clipped gradient in f32 into the moment update instead of rounding it
    to bf16 (its excess precision), so moments move by up to 2^-8 of the
    gradient; the port rounds where the reference's source does."""
    c = case("gemma3-1b")
    rp, tp = c.rp, c.tp
    ropt, topt = (T.make_optimizer(peak_lr=1e-3, warmup=2, total=16)
                  for T in (RT, TT))
    rs, ts = ropt.init(rp), topt.init(tp)
    tgrads = to_port(c.rgrads)
    for _ in range(2):
        ru, rs = ropt.update(c.rgrads, rs, rp)
        rp = RO.apply_updates(rp, ru)
        tu, ts = topt.update(tgrads, ts, tp)
        tp = TO.apply_updates(tp, tu)
    assert int(ts[1]["count"]) == int(rs[1]["count"]) == 2
    for name, want, got in (("params", rp, tp),
                            ("mu", rs[1]["mu"], ts[1]["mu"]),
                            ("nu", rs[1]["nu"], ts[1]["nu"])):
        got_flat = port_leaves(got)
        for key, w in ref_leaves(want).items():
            _ulp_close(got_flat[key], w, f"{name}/{key}")


def test_train_steps_loss_trajectory():
    """Four train steps of gemma3 smoke from the same parameters on the
    same batches (the reference's step: its jitted gradient, then its
    jitted optimizer): the losses and gradient norms within 2e-2."""
    c = case("gemma3-1b")
    ropt, topt = (T.make_optimizer(peak_lr=1e-3, warmup=2, total=16)
                  for T in (RT, TT))

    @jax.jit
    def rupdate(grads, opt_state, params):
        updates, opt_state = ropt.update(grads, opt_state, params)
        return RO.apply_updates(params, updates), opt_state

    rp, rs = c.rp, ropt.init(c.rp)
    tstate = TT.TrainState(step=torch.zeros((), dtype=torch.int32),
                           params=c.tp, opt_state=topt.init(c.tp))
    tstep = TT.make_train_step(c.tcfg, topt)
    rng = np.random.default_rng(9)
    for _ in range(4):
        toks = rng.integers(0, c.rcfg.vocab_size, (B, S), dtype=np.int32)
        (rloss, _), rgrads = c.grad_fn(rp, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(toks)})
        rnorm = float(RO.global_norm(rgrads))
        rp, rs = rupdate(rgrads, rs, rp)
        t = torch.from_numpy(toks)
        tstate, tm = tstep(tstate, {"tokens": t, "labels": t})
        assert abs(float(tm["loss"]) - float(rloss)) \
            <= 2e-2 * abs(float(rloss))
        assert abs(float(tm["grad_norm"]) - rnorm) <= 2e-2 * rnorm
    assert int(tstate.step) == 4


# ---------------------------------------------------------------------------
# The port alone (the reference's tests/test_train.py)
# ---------------------------------------------------------------------------


def _state(cfg, opt, seed):
    return TT.init_state(torch.Generator().manual_seed(seed), cfg, opt,
                         device="cpu")


def test_loss_decreases():
    opt = TT.make_optimizer(peak_lr=1e-2, warmup=5, total=100)
    state = _state(CFG, opt, 0)
    step = TT.make_train_step(CFG, opt)
    pipe = SyntheticLM(CFG.vocab_size, batch=8, seq_len=64, seed=0,
                       device="cpu")
    losses = []
    for i in range(25):
        state, m = step(state, pipe.batch_at(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[::6]


def test_microbatch_equivalence():
    opt = TT.make_optimizer(peak_lr=1e-3, warmup=1, total=10)
    pipe = SyntheticLM(CFG.vocab_size, batch=8, seq_len=32, seed=1,
                       device="cpu")
    b = pipe.batch_at(0)
    s1, m1 = TT.make_train_step(CFG, opt)(_state(CFG, opt, 1), b)
    s2, m2 = TT.make_train_step(CFG, opt, microbatches=4)(
        _state(CFG, opt, 1), b)
    # tests/test_train.py:41: grads are f32-accumulated; params are bf16
    for (_, a), (_, c) in zip(_leaves(s1.params), _leaves(s2.params)):
        np.testing.assert_allclose(as_f32(a), as_f32(c), rtol=1e-2, atol=2e-3)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-4)


def test_chunked_xent_matches_dense():
    params = TT.model_params(_state(CFG, TT.make_optimizer(), 0).params, CFG)
    pipe = SyntheticLM(CFG.vocab_size, batch=4, seq_len=48, seed=2,
                       device="cpu")
    batch = pipe.batch_at(0)
    x, _ = TM.backbone(params, batch, CFG)
    x, labels = x[:, :-1], batch["labels"][:, 1:]
    head = TM.head_params(params, CFG)
    want = float(TT._xent(TL.logits_fwd(head, x, 0.0), labels))
    for chunk in (7, 16, 47, 64):
        total, count = TT.chunked_xent(x, head, labels, CFG, chunk=chunk)
        np.testing.assert_allclose(float(total) / count, want, rtol=1e-5)


def test_loss_fn_shift_semantics():
    """loss must compare hidden[t] with labels[t+1] for causal LMs."""
    params = _state(CFG, TT.make_optimizer(), 0).params
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 16), dtype=np.int32))
    loss1, _ = TT.loss_fn(params, {"tokens": tokens, "labels": tokens}, CFG)
    loss2, _ = TT.loss_fn(params, {"tokens": tokens,
                                   "labels": (tokens + 1) % 512}, CFG)
    assert abs(float(loss1) - float(loss2)) > 1e-3


def test_grad_norm_reported():
    opt = TT.make_optimizer()
    pipe = SyntheticLM(CFG.vocab_size, batch=2, seq_len=16, seed=4,
                       device="cpu")
    _, metrics = TT.make_train_step(CFG, opt)(_state(CFG, opt, 0),
                                              pipe.batch_at(0))
    assert float(metrics["grad_norm"]) > 0


def test_remat_is_bit_neutral():
    check_remat_is_bit_neutral("gemma3-1b")


@pytest.mark.parametrize("arch", ("kimi-k2-1t-a32b", "gemma3-1b",
                                  "hubert-xlarge"))
def test_abstract_state_matches_reference(arch):
    """The meta-device TrainState of the full config has the reference's
    leaves: same keys, shapes and dtypes (moments in
    ``cfg.opt_moment_dtype``)."""
    want = ref_leaves(RT.abstract_state(RC.get_config(arch)))
    got = port_leaves(TT.abstract_state(TC.get_config(arch)))
    assert set(got) == set(want)
    for key, w in want.items():
        assert tuple(got[key].shape) == tuple(w.shape), key
        assert str(got[key].dtype).removeprefix("torch.") == str(w.dtype), \
            key
