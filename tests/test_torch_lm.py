"""The port's LM serving path against the JAX reference, on the CPU.

The twins of ``tests/test_configs.py``, ``tests/test_layers.py``,
``tests/test_models_smoke.py`` (forward and decode; training is not ported)
and ``tests/test_serve.py``, at smoke size, on parameters drawn by the
reference's ``init_params`` and carried across with
``params_from_reference``, and on inputs made from a numpy seed:

* configs, parameter counts, cells, shape cells and input specs: equal;
* ``_cache_len`` and the ring buffer's slots: equal;
* ``rope``, ``rmsnorm``, ``softcap`` (f32): within 1e-6 of the values'
  magnitude; ``_mask``: equal;
* bf16 paths -- ``chunked_attention`` over the reference's parameter grid,
  ``attention_decode``, ``mlp_fwd``, ``embed``, ``logits_fwd``, ``forward``
  of the six dense architectures (paligemma with its patch prefix, hubert
  with its frames), decode across a ring-buffer wrap, ``prefill_with_cache``:
  max |err| / max |ref| below ``BF16_BOUND``, the reference's bound for a
  bf16 path (``tests/test_serve.py:33``, "2 ulp");
* greedy tokens of ``generate`` and ``BatchedServer``: equal to the
  reference's at every step of the common trajectory where the reference's
  top-1/top-2 logit margin exceeds twice that bound;
* the SSM/MoE architectures (jamba, kimi-k2, llama4-scout, xlstm): the
  forward's logits (within the bound; measured at most 0.0038 of max
  |logit| over three seeds) and MoE aux loss (within 1e-5 of it;
  measured 5e-7), a teacher-forced run of decode steps against the
  reference's decode and against the port's own forward at a capacity
  that drops nothing, the serving path (prefill, generate,
  ``BatchedServer``, the CLI) and the decode cells' input specs;
* every full configuration's abstract parameters: the reference's leaf
  by leaf.

The reference's forward and decode run under ``jax.jit`` (as its
``BatchedServer`` runs decode), once per configuration, shared through
module-scoped caches.
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch.serve import BatchedServer as RServer
from repro.models import frontends as RF
from repro.models import layers as RL
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models.config import SHAPES as RSHAPES
from repro_torch import configs as TC
from repro_torch.checkpoint.store import _key, _leaves
from repro_torch.launch import serve as TS
from repro_torch.models import frontends as TF
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import serve as TSV
from repro_torch.models.config import SHAPES as TSHAPES
from repro_torch.models.config import ModelConfig

BF16_BOUND = 1e-2  # tests/test_serve.py:33: "bf16 path, 2 ulp"
STATE_BOUND = 1e-3  # an f32 recurrent state on equal inputs
ROUTE_MARGIN = 1e-3  # a clear top-k boundary between two gates
F32_TOL = 1e-6
DENSE = ("gemma3-1b", "qwen1.5-4b", "gemma2-9b", "granite-20b",
         "paligemma-3b", "hubert-xlarge")
SSM_MOE = ("jamba-1.5-large-398b", "kimi-k2-1t-a32b",
           "llama4-scout-17b-a16e", "xlstm-350m")
ARCHS = DENSE + SSM_MOE
B, S = 2, 32


def _np(a):
    """A reference array (bf16 included) or a tensor as f32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32_close(got, want):
    """f32 stages: within 1e-6, scaled by the values' magnitude where it
    passes 1 (one f32 ulp of a value above 8 is already 1e-6: softcap's
    outputs reach its cap of 30-50, the rotated values 10)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= F32_TOL * scale


def _pair(a, dtype=jnp.bfloat16):
    """One numpy f32 array as (reference array, port tensor) in ``dtype``."""
    r = jnp.asarray(a).astype(dtype)
    return r, TM._tensor(np.asarray(r))


# ---------------------------------------------------------------------------
# Shared reference runs
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, reference params, port cfg, port params) at smoke
    size; the port's parameters are the reference's, carried across."""
    rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0), rcfg)
    tp = TM.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                  device="cpu")
    return rcfg, rp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _ref_decode(arch):
    rcfg = _model(arch)[0]
    return jax.jit(lambda p, t, pos, c: RM.decode_step(p, t, pos, c, rcfg))


def _batch(cfg, seed=0):
    """Inputs of the model's contract from a numpy seed, for both packages."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        r, t = _pair(rng.standard_normal((B, S, cfg.d_model)))
        return {"frames": r}, {"frames": t}
    toks = rng.integers(0, cfg.vocab_size, (B, S - cfg.frontend_len),
                        dtype=np.int32)
    rb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.frontend == "vision":
        rb["patches"], tb["patches"] = _pair(
            rng.standard_normal((B, cfg.frontend_len, cfg.d_model)))
    return rb, tb


@functools.lru_cache(maxsize=None)
def _forward(arch):
    rcfg, rp, tcfg, tp = _model(arch)
    rb, tb = _batch(rcfg)
    want, aux = jax.jit(lambda p, b: RM.forward(p, b, rcfg))(rp, rb)
    return np.asarray(want), float(aux), tb


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", RC.list_archs())
def test_configs_equal_reference(arch):
    assert TC.list_archs() == RC.list_archs()
    for get in ("get_config", "smoke_config"):
        t, r = getattr(TC, get)(arch), getattr(RC, get)(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert (t.param_count(), t.active_param_count()) == \
            (r.param_count(), r.active_param_count())
        assert (t.hd, t.repeats, t.expert_ff, t.has_attention,
                t.subquadratic, t.supports_long_context) == \
            (r.hd, r.repeats, r.expert_ff, r.has_attention, r.subquadratic,
             r.supports_long_context)
    assert TC.get_config("gemma3-1b").param_count() == 999_811_584


def test_cells_and_shapes_equal_reference():
    cells = list(TC.all_cells())
    assert cells == list(RC.all_cells()) and len(cells) == 40
    assert {k: dataclasses.asdict(v) for k, v in TSHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RSHAPES.items()}
    for arch in TC.list_archs():
        for shape in TSHAPES.values():
            assert TC.cell_status(TC.get_config(arch), shape) == \
                RC.cell_status(RC.get_config(arch), RSHAPES[shape.name])
    with pytest.raises(KeyError, match="unknown arch"):
        TC.get_config("gpt-5")
    # the post-init check of the pattern's divisibility
    with pytest.raises(ValueError, match="not divisible"):
        TC.get_config("gemma3-1b").__class__(
            name="x", family="dense", num_layers=5, d_model=8, num_heads=1,
            num_kv_heads=1, d_ff=8, vocab_size=8,
            layer_pattern=(("attn", "dense"),) * 2)


@pytest.mark.parametrize("shape_name", list(RSHAPES))
def test_input_specs_equal_reference(shape_name):
    """Every architecture's input specs, leaf by leaf (paths, shapes,
    dtypes) against the reference's ShapeDtypeStructs: the decode caches
    of the SSM mixers (mamba's conv and ssm, mLSTM's C and n, sLSTM's c,
    n, m and h) stacked over repeats, beside the attention caches."""
    for arch in RC.list_archs():
        rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
        shape = TSHAPES[shape_name]
        if RC.cell_status(rcfg, RSHAPES[shape_name]) != "run":
            continue
        want = RC.input_specs(rcfg, RSHAPES[shape_name])
        got = TC.input_specs(tcfg, shape)
        rleaves = jax.tree_util.tree_flatten_with_path(want)[0]
        rkeys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                          for p in path) for path, _ in rleaves]
        tleaves = list(_leaves(got))
        assert [_key(p) for p, _ in tleaves] == rkeys, arch
        for (_, t), (_, r) in zip(tleaves, rleaves):
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(r.shape), arch
            assert str(t.dtype).removeprefix("torch.") == str(r.dtype), arch


def test_cache_len_equal_reference():
    for arch in DENSE:
        cfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
        for mixer in ("attn", "local"):
            for max_len in (1, 8, 16, 17, 64):
                assert TM._cache_len(tcfg, mixer, max_len) == \
                    RM._cache_len(cfg, mixer, max_len)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def test_rope_rmsnorm_softcap_mask_f32():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 3, 32)).astype(np.float32) * 3
    pos = np.arange(24, dtype=np.int32) * 7
    for theta in (10_000.0, 1_000_000.0):
        want = RL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        _f32_close(got, want)
    # per-row positions (the decode form, [B, 1])
    bpos = np.full((2, 1), 13, np.int32)
    want = RL.rope(jnp.asarray(x[:, :1]), jnp.asarray(bpos))
    got = TL.rope(torch.from_numpy(x[:, :1]), torch.from_numpy(bpos))
    _f32_close(got, want)
    h = rng.standard_normal((4, 32)).astype(np.float32) * 10
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    want = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(h))
    got = TL.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(h))
    _f32_close(got, want)
    s = np.linspace(-1000, 1000, 101, dtype=np.float32)
    for cap in (0.0, 30.0, 50.0):
        _f32_close(TL.softcap(torch.from_numpy(s), cap),
                   RL.softcap(jnp.asarray(s), cap))
    assert float(TL.softcap(torch.from_numpy(s), 30.0).abs().max()) <= 30.0
    qp, kp = np.arange(5, 21, dtype=np.int32), np.arange(24, dtype=np.int32)
    for causal in (True, False):
        for window in (0, 4):
            assert np.array_equal(
                TL._mask(torch.from_numpy(qp), torch.from_numpy(kp), causal,
                         window).numpy(),
                np.asarray(RL._mask(jnp.asarray(qp), jnp.asarray(kp), causal,
                                    window)))


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 8, 0.0), (False, 0, 0.0), (True, 0, 30.0),
    (True, 16, 50.0),
])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1)])
def test_chunked_attention_vs_reference(causal, window, cap, H, KV):
    """test_layers' grid, chunked (q 16, kv 8: the banded path where there
    is a window): bf16 within the bf16 bound, f32 within the reference's
    own chunked-vs-naive tolerance (tests/test_layers.py:45)."""
    Bq, Sq, hd = 2, 64, 16
    rng = np.random.default_rng(hash((causal, window, cap, H, KV)) % 2**32)
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    pos = np.arange(Sq, dtype=np.int32)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_chunk=16,
              kv_chunk=8)
    for dtype in (jnp.bfloat16, jnp.float32):
        (rq, tq), (rk, tk), (rv, tv) = (_pair(a, dtype) for a in (q, k, v))
        want = RL.chunked_attention(rq, rk, rv, jnp.asarray(pos),
                                    jnp.asarray(pos), **kw)
        got = TL.chunked_attention(tq, tk, tv, torch.from_numpy(pos),
                                   torch.from_numpy(pos), **kw)
        assert got.dtype == tq.dtype
        if dtype == jnp.bfloat16:
            assert _rel(got, want) < BF16_BOUND
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=2e-5, atol=2e-5)
    # one chunk against the banded chunks: the band changes no value
    one = TL.chunked_attention(tq, tk, tv, torch.from_numpy(pos),
                               torch.from_numpy(pos), causal=causal,
                               window=window, logit_softcap=cap)
    np.testing.assert_allclose(one.numpy(), got.numpy(), rtol=2e-5, atol=2e-5)


def test_attention_decode_and_ring_slots_vs_reference():
    """Decode against a window-sized ring (W=8) past its wrap: every step's
    output and the whole cache (which slot holds which position)."""
    rcfg, rp, tcfg, tp = _model("gemma2-9b")
    rcfg = dataclasses.replace(rcfg, window=8)
    tcfg = dataclasses.replace(tcfg, window=8)
    ra, ta = jax.tree.map(lambda a: a[0], rp["slots"]["slot00"]["attn"]), \
        tp["layers"][0]["attn"]
    W, d = 8, rcfg.d_model
    rk = rv = jnp.zeros((B, W, rcfg.num_kv_heads, rcfg.hd), jnp.bfloat16)
    tk, tv = torch.zeros(tuple(rk.shape), dtype=torch.bfloat16), \
        torch.zeros(tuple(rk.shape), dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    step = jax.jit(lambda p, x, pos, k, v: RL.attention_decode(
        p, x, pos, k, v, rcfg, "local"))
    for pos in range(19):
        rx, tx = _pair(rng.standard_normal((B, 1, d)))
        want, (rk, rv) = step(ra, rx, pos, rk, rv)
        got, (tk, tv) = TL.attention_decode(ta, tx, pos, tk, tv, tcfg,
                                            "local")
        assert _rel(got, want) < BF16_BOUND, pos
        assert _rel(tk, rk) < BF16_BOUND and _rel(tv, rv) < BF16_BOUND
        # the slot just written holds this step's K: same slot in both
        assert np.abs(_np(tk[:, pos % W]) - _np(rk[:, pos % W])).max() <= \
            BF16_BOUND * np.abs(_np(rk)).max()


def test_mlp_embed_logits_vs_reference():
    rcfg, rp, tcfg, tp = _model("gemma3-1b")
    rng = np.random.default_rng(4)
    rx, tx = _pair(rng.standard_normal((B, S, rcfg.d_model)))
    rm = jax.tree.map(lambda a: a[0], rp["slots"]["slot01"]["mlp"])
    tm = tp["layers"][1]["mlp"]  # repeat 0, slot 1
    assert _rel(TL.mlp_fwd(tm, tx), jax.jit(RL.mlp_fwd)(rm, rx)) < BF16_BOUND
    toks = rng.integers(0, rcfg.vocab_size, (B, S), dtype=np.int32)
    want = RL.embed(rp["embed"], jnp.asarray(toks), rcfg.d_model)
    got = TL.embed(tp["embed"], torch.from_numpy(toks), rcfg.d_model)
    assert got.dtype == torch.bfloat16 and _rel(got, want) < BF16_BOUND
    # the scale is d ** 0.5 rounded to bf16 (128 ** 0.5 = 11.3137 -> 11.3125)
    for d in (128, 1152, 2048):
        assert TL.embed_scale(d) == float(jnp.asarray(d ** 0.5, jnp.bfloat16))
    for cap in (0.0, 30.0):
        want = jax.jit(RL.logits_fwd, static_argnums=2)(rp["embed"], rx, cap)
        got = TL.logits_fwd(tp["embed"], tx, cap)
        assert got.dtype == torch.float32 and _rel(got, want) < BF16_BOUND
    rg = np.asarray(jax.nn.silu(rx))
    assert np.array_equal(_np(TL.silu(tx)), rg.astype(np.float32))


# ---------------------------------------------------------------------------
# Frontends
# ---------------------------------------------------------------------------


def test_frontends_specs_and_synthesis():
    for arch in ("paligemma-3b", "hubert-xlarge"):
        rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
        pairs = [(TF.vision_spec(tcfg, 3), RF.vision_spec(rcfg, 3)),
                 (TF.audio_spec(tcfg, 3, 20), RF.audio_spec(rcfg, 3, 20))]
        for t, r in pairs:
            assert t.device.type == "meta" and t.dtype == torch.bfloat16
            assert tuple(t.shape) == tuple(r.shape)
        for seed in (0, 1):
            for train in (True, False):
                tb = TF.make_batch(tcfg, 3, 24, seed=seed, train=train,
                                   device="cpu")
                rb = RF.make_batch(rcfg, 3, 24, seed=seed, train=train)
                assert sorted(tb) == sorted(rb)
                for k in tb:
                    assert tuple(tb[k].shape) == tuple(rb[k].shape)
                    assert str(tb[k].dtype).removeprefix("torch.") == \
                        str(rb[k].dtype)
                again = TF.make_batch(tcfg, 3, 24, seed=seed, train=train,
                                      device="cpu")
                assert all(torch.equal(tb[k], again[k]) for k in tb)
                for k in ("tokens", "labels"):
                    if k in tb:
                        assert int(tb[k].min()) >= 0
                        assert int(tb[k].max()) < tcfg.vocab_size
        a = TF.synth_frames(tcfg, 2, 64, seed=0, device="cpu").float()
        b = TF.synth_frames(tcfg, 2, 64, seed=1, device="cpu").float()
        assert not torch.equal(a, b)
        assert abs(float(a.std()) - 1.0) < 0.05
    gem = TC.smoke_config("gemma3-1b")
    assert sorted(TF.make_batch(gem, 2, 8, device="cpu")) == \
        ["labels", "tokens"]
    if not torch.cuda.is_available():
        # The entry points draw on the card unless asked for the CPU.
        for make in (lambda: TF.make_batch(gem, 2, 8),
                     lambda: TF.synth_frames(gem, 2, 8),
                     lambda: TF.synth_patches(TC.smoke_config("paligemma-3b"),
                                              2)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_params_layouts_equal_reference(arch):
    """The reference tree -> the port's layers -> the reference tree, bit
    for bit; ``abstract_params`` and ``init_params`` have the reference's
    shapes and dtypes in the reference's layout."""
    rcfg, rp, tcfg, tp = _model(arch)
    back = TM.params_to_reference(tp, tcfg)
    rleaves = jax.tree_util.tree_flatten_with_path(rp)[0]
    tl = [(_key(p), l) for p, l in _leaves(back)]
    rk = ["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in pth)
          for pth, _ in rleaves]
    assert [k for k, _ in tl] == rk
    for (_, t), (_, r) in zip(tl, rleaves):
        r = np.asarray(r)
        if r.dtype.name == "bfloat16":
            assert np.array_equal(t.view(torch.int16).numpy(),
                                  r.view(np.int16))
        else:
            assert np.array_equal(t.numpy(), r)
    assert len(tp["layers"]) == tcfg.num_layers
    for spec in (TM.abstract_params(tcfg),
                 TM.init_params(tcfg, torch.Generator().manual_seed(1),
                                "cpu")):
        spec = [l for _, l in _leaves(TM.params_to_reference(spec, tcfg))]
        assert [(tuple(a.shape), a.dtype) for a in spec] == \
            [(tuple(t.shape), t.dtype) for _, t in tl]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_vs_reference(arch):
    """Full forward of each smoke config (paligemma with its patch
    prefix, hubert encoder-only on its frames): the logits, and the aux
    loss (an f32 zero without MoE; the MoE blocks' sum, in layer order,
    with it)."""
    want, want_aux, tb = _forward(arch)
    tcfg, tp = _model(arch)[2:]
    got, aux = TM.forward(tp, tb, tcfg)
    assert got.shape == (B, S, tcfg.vocab_size) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all()) and aux.dtype == torch.float32
    if tcfg.num_experts:
        assert float(aux) > 0
        assert abs(float(aux) - want_aux) <= 1e-5 * want_aux, arch
    else:
        assert float(aux) == 0.0 == want_aux
    assert _rel(got, want) < BF16_BOUND, arch
    last, _ = TM.forward_last(tp, tb, tcfg)
    assert torch.equal(last, got[:, -1:])
    assert torch.equal(TM.prefill(tp, tb, tcfg, S)[0], last)
    if tcfg.encoder_only:  # no decode step
        assert TC.get_config(arch).encoder_only


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if not RC.get_config(a).encoder_only])
def test_one_decode_step_vs_reference(arch):
    """One decode step at pos 3 into a zero cache of 16 (the smoke test's
    step): logits and every cache leaf."""
    rcfg, rp, tcfg, tp = _model(arch)
    tok = np.random.default_rng(5).integers(0, rcfg.vocab_size, (B, 1),
                                            dtype=np.int32)
    rc = RM.init_cache(rcfg, B, 16)
    tc = TM.init_cache(tcfg, B, 16, device="cpu")
    want, rc = _ref_decode(arch)(rp, jnp.asarray(tok), 3, rc)
    got, tc = TM.decode_step(tp, torch.from_numpy(tok), 3, tc, tcfg)
    assert got.shape == (B, 1, tcfg.vocab_size)
    assert _rel(got, want) < BF16_BOUND
    rl = jax.tree_util.tree_flatten_with_path(rc)[0]
    tl = list(_leaves(tc))
    assert len(rl) == len(tl)
    for (_, t), (_, r) in zip(tl, rl):
        assert tuple(t.shape) == tuple(r.shape)
        assert _rel(t, r) < BF16_BOUND


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-9b"])
def test_decode_across_ring_wrap_vs_reference(arch):
    """24 decode steps with a cache of 24: the local layers' ring (window
    16) wraps at step 16.  Every step's logits against the reference's,
    and against the port's own teacher-forced forward."""
    rcfg, rp, tcfg, tp = _model(arch)
    steps = 24
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size, (B, steps),
                                             dtype=np.int32)
    rc = RM.init_cache(rcfg, B, steps)
    tc = TM.init_cache(tcfg, B, steps, device="cpu")
    assert tc["slot00"]["k"].shape[2] == 16  # the ring
    full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    scale = float(full.abs().max())
    for t in range(steps):
        want, rc = _ref_decode(arch)(rp, jnp.asarray(toks[:, t:t + 1]), t, rc)
        got, tc = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t,
                                 tc, tcfg)
        assert _rel(got, want) < BF16_BOUND, t
        assert float((got[:, 0] - full[:, t]).abs().max()) / scale < \
            BF16_BOUND, t
    for (_, t), (_, r) in zip(_leaves(tc),
                              jax.tree_util.tree_flatten_with_path(rc)[0]):
        assert _rel(t, r) < BF16_BOUND


def test_prefill_with_cache_vs_reference():
    rcfg, rp, tcfg, tp = _model("gemma3-1b")
    toks = np.random.default_rng(7).integers(0, rcfg.vocab_size, (B, 10),
                                             dtype=np.int32)
    want, rc = RSV.prefill_with_cache(rp, {"tokens": jnp.asarray(toks)},
                                      rcfg, 20)
    got, tc = TSV.prefill_with_cache(tp, {"tokens": torch.from_numpy(toks)},
                                     tcfg, 20)
    assert _rel(got, want) < BF16_BOUND
    for (_, t), (_, r) in zip(_leaves(tc),
                              jax.tree_util.tree_flatten_with_path(rc)[0]):
        assert _rel(t, r) < BF16_BOUND
    # the prefill step is the forward's last position
    full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    step = TSV.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(step, full[:, -1:])
    assert float((got[:, 0] - full[:, -1]).abs().max()) / \
        float(full.abs().max()) < BF16_BOUND
    dec = TSV.make_decode_step(tcfg)(tp, torch.from_numpy(toks[:, :1]), 10,
                                     tc)[0]
    assert dec.shape == (B, 1, tcfg.vocab_size)


def _ref_trajectory(arch, prompts, steps, max_len):
    """The reference's greedy trajectory, step by step: its tokens [B,
    steps + 1] (the first sampled from the prompt's last logits) and the
    logits each was chosen from [B, steps + 1, V]."""
    rcfg, rp = _model(arch)[:2]
    P = prompts.shape[1]
    rc = RM.init_cache(rcfg, prompts.shape[0], max_len)
    tok, toks, logits = None, [], []
    for t in range(P + steps):
        inp = prompts[:, t:t + 1] if t < P else tok
        lg, rc = _ref_decode(arch)(rp, jnp.asarray(inp), t, rc)
        if t >= P - 1:
            logits.append(np.asarray(lg[:, 0]))
            tok = np.asarray(RSV.sample_greedy(lg))
            toks.append(tok[:, 0])
    return np.stack(toks, axis=1), np.stack(logits, axis=1)


def _check_greedy(got, want, logits):
    """``got`` equals ``want`` at every step of the common trajectory
    where the reference's top-1/top-2 margin exceeds twice the bound; a
    row that splits at a step within it is not compared further.
    Returns the number of token pairs compared equal."""
    compared = 0
    for b in range(want.shape[0]):
        for t in range(want.shape[1]):
            top2 = np.sort(logits[b, t])[-2:]
            margin = float(top2[1] - top2[0])
            tol = 2 * BF16_BOUND * float(np.abs(logits[:, t]).max())
            if got[b, t] != want[b, t]:
                assert margin <= tol, (b, t, margin, tol)
                break
            compared += 1
    return compared


def test_generate_greedy_vs_reference():
    """gemma3-smoke, prompt 8, 12 new tokens, cache 21: the local layers'
    ring (16) wraps during generation."""
    rcfg, rp, tcfg, tp = _model("gemma3-1b")
    prompts = np.random.default_rng(8).integers(0, rcfg.vocab_size, (B, 8),
                                                dtype=np.int32)
    want = np.asarray(RSV.generate(rp, {"tokens": jnp.asarray(prompts)}, rcfg,
                                   steps=12, max_len=24))
    got = TSV.generate(tp, {"tokens": torch.from_numpy(prompts)}, tcfg,
                       steps=12, max_len=24)
    assert got.shape == (B, 12) and got.dtype == torch.int32
    again = TSV.generate(tp, {"tokens": torch.from_numpy(prompts)}, tcfg,
                         steps=12, max_len=24)
    assert torch.equal(got, again)  # deterministic
    toks, logits = _ref_trajectory("gemma3-1b", prompts, 12, 24)
    assert np.array_equal(toks[:, 1:], want)  # its steps are generate's
    assert _check_greedy(got.numpy(), want, logits[:, 1:]) > 0


def test_temperature_sampling():
    """test_serve's small config (logits of order 1, so a temperature of 5
    spreads the draws): other generator seeds, other tokens; the same
    seed, the same tokens."""
    tcfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=32,
                       num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                       remat="none")
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompts = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (4, 8), dtype=np.int32))
    run = lambda seed: TSV.generate(
        tp, {"tokens": prompts}, tcfg, steps=8, max_len=20, temperature=5.0,
        generator=torch.Generator().manual_seed(seed))
    a, b = run(10), run(11)
    assert not torch.equal(a, b)
    assert torch.equal(a, run(10))
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab_size


def test_batched_server_vs_reference():
    """The reference's BatchedServer and the port's on the same prompts:
    the first tokens and 10 decode steps (the ring wraps at 16)."""
    rcfg, rp, tcfg, tp = _model("gemma3-1b")
    prompts = np.random.default_rng(0).integers(0, rcfg.vocab_size, (B, 8),
                                                dtype=np.int32)
    rs = RServer(rcfg, rp, batch_slots=B, max_len=24)
    ts = TS.BatchedServer(tcfg, tp, batch_slots=B, max_len=24, device="cpu")
    rfirst, tfirst = np.asarray(rs.prefill(prompts)), ts.prefill(prompts)
    assert tfirst.shape == (B, 1) and ts.pos == 8
    want = np.concatenate([rfirst, rs.decode(10)], axis=1)
    got = np.concatenate([tfirst.numpy(), ts.decode(10)], axis=1)
    assert got.shape == (B, 11) and ts.pos == 18
    assert ts.logits.shape == (B, 1, tcfg.vocab_size)
    assert got.min() >= 0 and got.max() < rcfg.vocab_size
    toks, logits = _ref_trajectory("gemma3-1b", prompts, 10, 24)
    assert np.array_equal(toks, want)
    assert _check_greedy(got, want, logits) > 0


def _no_drops(cfg):
    """``cfg`` at a capacity that no routing can overflow (every token's
    k slots fit any expert: C > T), where the forward and decode steps
    route each token alike."""
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.top_k)


def _recording_margins(monkeypatch):
    """Record each call of the port's router: every token's margin
    between its k-th and (k+1)-th gate (one tensor [T] per MoE layer)."""
    margins, route = [], TMOE._route

    def recording(xt, router, cfg):
        out = route(xt, router, cfg)
        g = torch.sort(out[2], dim=-1, descending=True).values
        margins.append(g[:, cfg.top_k - 1] - g[:, cfg.top_k])
        return out

    monkeypatch.setattr(TMOE, "_route", recording)
    return margins


@pytest.mark.parametrize("arch", SSM_MOE)
def test_teacher_forced_decode_vs_reference(arch, monkeypatch):
    """32 decode steps of a seeded token stream from an empty cache: each
    step's logits against the reference's decode step, and against the
    port's own forward over the stream at a capacity that drops nothing
    (each row whose routing is clear: at every MoE layer its k-th gate
    exceeds the next by more than ``ROUTE_MARGIN``, since the two paths
    reach a router by different bf16 sums and a nearer pair may route
    either way; 62 of 64 rows for jamba and kimi-k2, all for llama4, and
    the check holds on all 64 at a margin of 1e-4).  The cache: updated
    in place, every leaf with the reference's path, shape and dtype, and
    the first layer's states -- the layer whose inputs are equal in both
    packages -- within 1e-3 of the reference's (f32; deeper states sit
    behind bf16 layers, and the logits hold them)."""
    rcfg, rp, tcfg, tp = _model(arch)
    steps = 32
    toks = np.random.default_rng(10).integers(0, rcfg.vocab_size,
                                              (B, steps), dtype=np.int32)
    rc = RM.init_cache(rcfg, B, steps)
    tc = TM.init_cache(tcfg, B, steps, device="cpu")
    leaves = [l for _, l in _leaves(tc)]
    for t in range(steps):
        want, rc = _ref_decode(arch)(rp, jnp.asarray(toks[:, t:t + 1]), t, rc)
        got, tc = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t,
                                 tc, tcfg)
        assert _rel(got, want) < BF16_BOUND, t
    # the same stream against the port's forward, neither dropping
    cfg = _no_drops(tcfg)
    full, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, cfg)
    scale = float(full.abs().max())
    margins = _recording_margins(monkeypatch)
    own = TM.init_cache(cfg, B, steps, device="cpu")
    compared = 0
    for t in range(steps):
        margins.clear()
        got, own = TM.decode_step(tp, torch.from_numpy(toks[:, t:t + 1]), t,
                                  own, cfg)
        clear = torch.ones(B, dtype=torch.bool)
        for m in margins:
            clear &= m > ROUTE_MARGIN
        err = (got[clear, 0] - full[clear, t]).abs()
        assert err.numel() == 0 or float(err.max()) / scale < BF16_BOUND, t
        compared += int(clear.sum())
    assert compared >= steps * B // 2
    assert all(a is b for a, (_, b) in zip(leaves, _leaves(tc)))
    rl = jax.tree_util.tree_flatten_with_path(rc)[0]
    assert len(rl) == len(leaves)
    for (path, t), (_, r) in zip(_leaves(tc), rl):
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype)
        assert tuple(t.shape) == tuple(r.shape)
        if path[0] == "slot00":
            bound = STATE_BOUND if t.dtype == torch.float32 else BF16_BOUND
            assert _rel(t[0], r[0]) < bound, path


@pytest.mark.parametrize("arch", SSM_MOE)
def test_serving_path_vs_reference(arch):
    """prefill_with_cache, generate and BatchedServer on the SSM/MoE
    archs: the prompt's last logits against the reference's, the greedy
    tokens against the reference's trajectory under the margin rule."""
    rcfg, rp, tcfg, tp = _model(arch)
    prompts = np.random.default_rng(11).integers(0, rcfg.vocab_size, (B, 8),
                                                 dtype=np.int32)
    toks, logits = _ref_trajectory(arch, prompts, 8, 20)
    got, _ = TSV.prefill_with_cache(tp, {"tokens": torch.from_numpy(prompts)},
                                    tcfg, 20)
    assert _rel(got[:, 0], logits[:, 0]) < BF16_BOUND
    gen = TSV.generate(tp, {"tokens": torch.from_numpy(prompts)}, tcfg,
                       steps=8, max_len=20)
    assert gen.shape == (B, 8)
    assert _check_greedy(gen.numpy(), toks[:, 1:], logits[:, 1:]) > 0
    server = TS.BatchedServer(tcfg, tp, batch_slots=B, max_len=20,
                              device="cpu")
    first = server.prefill(prompts)
    served = np.concatenate([first.numpy(), server.decode(8)], axis=1)
    assert server.pos == 16 and served.shape == (B, 9)
    assert np.array_equal(served[:, 1:], gen.numpy())  # one trajectory
    assert _check_greedy(served, toks, logits) > 0


@pytest.mark.parametrize("arch", RC.list_archs())
def test_abstract_params_equal_reference_full_configs(arch):
    """The full configurations' parameters on the meta device, in the
    reference's layout, against ``abstract_params`` of the reference:
    paths, shapes and dtypes, leaf by leaf (kimi-k2's 384 experts of 60
    layers, jamba's f32 SSM leaves and routers among them)."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(RM.abstract_params(rcfg))[0]
    got = list(_leaves(TM.params_to_reference(TM.abstract_params(tcfg),
                                              tcfg)))
    assert [_key(p) for p, _ in got] == \
        ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                  for p in path) for path, _ in want]
    for (_, t), (_, r) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(r.shape)
        assert str(t.dtype).removeprefix("torch.") == str(r.dtype)


@pytest.mark.parametrize("arch", SSM_MOE)
def test_cli_serves_the_ssm_and_moe_archs(arch, capsys):
    out = TS.main(["--arch", arch, "--smoke", "--device", "cpu",
                   "--requests", "2", "--prompt-len", "4", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 2 reqs: prefill ")
    assert lines[1].startswith("[serve] sample output tokens:")
    assert out["tokens"].shape == (2, 3) and out["arch"] == \
        TC.smoke_config(arch).name
    assert 0 <= out["tokens"].min() and \
        out["tokens"].max() < TC.smoke_config(arch).vocab_size


def test_cli_serves_a_smoke_arch(capsys):
    out = TS.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                   "--requests", "2", "--prompt-len", "4", "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] 2 reqs: prefill ")
    assert "decode 3 steps in" in lines[0] and "tok/s" in lines[0]
    assert lines[1].startswith("[serve] sample output tokens:")
    assert out["tokens"].shape == (2, 3)
    with pytest.raises(SystemExit, match="encoder-only"):
        TS.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):  # argparse: --arch or --graph
        with contextlib.redirect_stderr(io.StringIO()):
            TS.main(["--device", "cpu"])
