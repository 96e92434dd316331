"""Shared cases of the port's training tests (``test_torch_train*.py``):
one smoke-size architecture's parameters (the reference's ``init_params``,
carried across in the reference's layout, the port's
``TrainState.params`` layout), a batch from a numpy seed, and the jitted
reference's loss and gradients, computed once per architecture and
process."""

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as RC
from repro.models import model as RM
from repro.models import train as RT
from repro_torch import configs as TC
from repro_torch.checkpoint.store import _key, _leaves
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import train as TT

ROUTE_MARGIN = 1e-3  # a clear top-k boundary between two gates
B, S = 2, 32

Case = collections.namedtuple(
    "Case", "rcfg rp tcfg tp rb tb rloss rgrads grad_fn")


def as_f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a).astype(np.float32)


def ref_leaves(tree):
    """``{'/'-joined path: leaf}`` of a reference tree (dicts, dataclass)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
        p, "name", p)))) for p in path): leaf for path, leaf in flat}


def port_leaves(tree):
    return {_key(path): leaf for path, leaf in _leaves(tree)}


def to_port(tree):
    """A reference tree of arrays as tensors with the same bits."""
    return jax.tree.map(lambda a: TM._tensor(np.asarray(a)), tree)


def make_batch(cfg, seed=0):
    """One training batch of the model's contract from a numpy seed, for
    both packages."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    if cfg.frontend == "audio":
        frames = jnp.asarray(rng.standard_normal((B, S, cfg.d_model)),
                             jnp.bfloat16)
        return ({"frames": frames, "labels": jnp.asarray(labels)},
                {"frames": TM._tensor(np.asarray(frames)),
                 "labels": torch.from_numpy(labels)})
    toks = rng.integers(0, cfg.vocab_size, (B, S - cfg.frontend_len),
                        dtype=np.int32)
    if cfg.frontend != "vision":
        labels = toks  # the LM convention: labels are the tokens
    rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.frontend == "vision":
        patches = jnp.asarray(
            rng.standard_normal((B, cfg.frontend_len, cfg.d_model)),
            jnp.bfloat16)
        rb["patches"], tb["patches"] = patches, TM._tensor(np.asarray(patches))
    return rb, tb


def min_route_margin(tcfg, tp, tb):
    """The smallest margin between a token's k-th and (k+1)-th gate over
    every MoE layer of the port's forward (inf without MoE)."""
    margins = [float("inf")]
    route = TMOE._route

    def recording(xt, router, cfg):
        got = route(xt, router, cfg)
        g = torch.sort(got[2], dim=-1, descending=True).values
        margins.append(float((g[:, cfg.top_k - 1] - g[:, cfg.top_k]).min()))
        return got

    TMOE._route = recording
    try:
        with torch.no_grad():
            TM.backbone(TT.model_params(tp, tcfg), tb, tcfg)
    finally:
        TMOE._route = route
    return min(margins)


@functools.lru_cache(maxsize=None)
def case(arch):
    """The ``Case`` of ``arch`` at smoke size: the jitted reference once
    per architecture.

    The batch comes from the first numpy seed whose every routing
    decision clears the next gate by ``ROUTE_MARGIN`` (the margin rule of
    ``tests/test_torch_lm.py``; every seed for the archs without MoE): at
    a smaller margin the two packages' bf16 sums may send a token to
    another expert, which moves whole expert gradients (jamba's seed 0
    has a 9.4e-5 margin, and the flipped token moves slot05's expert
    ``w_gate`` gradient by 0.38 of its max)."""
    rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0), rcfg)
    tp = to_port(rp)
    seed = next(s for s in range(64)
                if min_route_margin(tcfg, tp, make_batch(rcfg, s)[1])
                >= ROUTE_MARGIN)
    rb, tb = make_batch(rcfg, seed)
    grad_fn = jax.jit(jax.value_and_grad(
        functools.partial(RT.loss_fn, cfg=rcfg), has_aux=True))
    (loss, _), grads = grad_fn(rp, rb)
    return Case(rcfg, rp, tcfg, tp, rb, tb, loss, grads, grad_fn)


def grad_errors(got, want):
    """Per leaf max |got - want| / max |want| (0 where both are zero)."""
    want_flat, got_flat = ref_leaves(want), port_leaves(got)
    assert set(want_flat) == set(got_flat)
    out = {}
    for key, w in want_flat.items():
        g, w = as_f32(got_flat[key]), as_f32(w)
        assert g.shape == w.shape, key
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        out[key] = err / scale if scale else (0.0 if err == 0 else np.inf)
    return out


LOSS_RTOL = 1e-3
GRAD_BOUND = 3e-2  # max |port - ref| / max |ref| per leaf


def check_loss_and_grads(arch, bound=GRAD_BOUND):
    """The port's loss within ``LOSS_RTOL`` of the jitted reference's, and
    every gradient leaf within ``bound`` of its max |ref|.  Returns the
    per-leaf errors."""
    c = case(arch)
    metrics, grads = TT.value_and_grad(c.tp, c.tb, c.tcfg)
    assert abs(float(metrics["loss"]) - float(c.rloss)) \
        <= LOSS_RTOL * abs(float(c.rloss))
    errors = grad_errors(grads, c.rgrads)
    worst = max(errors, key=errors.get)
    assert errors[worst] <= bound, (worst, errors[worst], bound)
    return errors


def check_remat_is_bit_neutral(arch):
    """``remat`` "dots" and "full" against "none": every loss and gradient
    bit equal (the reference's remat changes none either)."""
    c = case(arch)
    runs = {remat: TT.value_and_grad(
        c.tp, c.tb, dataclasses.replace(c.tcfg, remat=remat))
        for remat in ("none", "dots", "full")}
    m0, g0 = runs["none"]
    for remat in ("dots", "full"):
        m, g = runs[remat]
        assert torch.equal(m["loss"], m0["loss"]), remat
        for (path, a), (_, b) in zip(_leaves(g), _leaves(g0)):
            assert torch.equal(a, b), (remat, path)
