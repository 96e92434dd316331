"""Gradient transforms: AdamW, SGD, clipping, chaining.

The port of ``repro/optim/transforms.py``: the same ``(init, update)``
contract, over trees of tensors (dicts, lists, tuples), with the
reference's arithmetic step by step -- moments updated in f32, the update
rounded to the parameter's dtype, ``apply_updates`` adding in f32 and
rounding again, the clip's scale cast to the gradient's dtype before the
multiply.  States mirror the parameter tree, so the sharding rules place
optimizer moments exactly like their parameters
(``repro_torch.models.train.train_state_specs``).  Updates run without
autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); dicts, lists and tuples are
    structure, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _unzip(tree, n):
    """A tree (dicts and lists) whose leaves are ``n``-tuples as ``n``
    trees."""
    def pick(sub, i):
        if isinstance(sub, dict):
            return {k: pick(v, i) for k, v in sub.items()}
        if isinstance(sub, list):
            return [pick(v, i) for v in sub]
        return sub[i]

    return tuple(pick(tree, i) for i in range(n))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, leaf by leaf."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(max_norm: float) -> Optimizer:
    def init(params):
        return ()

    @torch.no_grad()
    def update(grads, state, params=None):
        norm = global_norm(grads)
        scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), state

    return Optimizer(init, update)


def _count(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


def scale_by_schedule(schedule: Callable) -> Optimizer:
    """Multiplies updates by -schedule(count) (descent sign included)."""

    def init(params):
        return {"count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params=None):
        lr = schedule(state["count"])
        out = tree_map(lambda g: (-lr * g.float()).to(g.dtype), grads)
        return out, {"count": state["count"] + 1}

    return Optimizer(init, update)


def adamw(schedule: Callable, b1=0.9, b2=0.95, eps=1e-8,
          weight_decay=0.1, mu_dtype=F32, nu_dtype=F32) -> Optimizer:
    """AdamW with decoupled weight decay and bias correction.

    Moments are stored in ``mu_dtype``/``nu_dtype`` and sharded like their
    params (bf16 moments halve optimizer state, as the kimi-k2 config
    asks).  Weight decay is skipped for 1-D leaves (norm scales, biases);
    a leaf stacked over a pattern's repeats is 2-D and decays, as in the
    reference, so the caller's tree must be in the reference's layout
    (``repro_torch.models.train``).
    """

    def init(params):
        return {"count": _count(params),
                "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=mu_dtype,
                                                     device=p.device), params),
                "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=nu_dtype,
                                                     device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        c1 = 1.0 - torch.pow(b1, count.float())
        c2 = 1.0 - torch.pow(b2, count.float())
        lr = schedule(state["count"])

        def upd(g, mu, nu, p):
            gf = g.float()
            mu_new = b1 * mu.float() + (1 - b1) * gf
            nu_new = b2 * nu.float() + (1 - b2) * gf * gf
            step = (mu_new / c1) / (torch.sqrt(nu_new / c2) + eps)
            if p.ndim > 1 and weight_decay:
                step = step + weight_decay * p.float()
            return ((-lr * step).to(p.dtype), mu_new.to(mu_dtype),
                    nu_new.to(nu_dtype))

        updates, mu, nu = _unzip(
            tree_map(upd, grads, state["mu"], state["nu"], params), 3)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def sgd(schedule: Callable, momentum=0.9) -> Optimizer:
    def init(params):
        return {"count": _count(params),
                "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                     device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params):
        lr = schedule(state["count"])

        def upd(g, mu, p):
            mu_new = momentum * mu + g.float()
            return (-lr * mu_new).to(p.dtype), mu_new

        updates, mu = _unzip(tree_map(upd, grads, state["mu"], params), 2)
        return updates, {"count": state["count"] + 1, "mu": mu}

    return Optimizer(init, update)


def chain(*transforms: Optimizer) -> Optimizer:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        new_states = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)
