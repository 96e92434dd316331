"""Sharding rules: logical axis names -> mesh partition specs.

The port of ``repro/models/sharding.py``.  On one card nothing is placed,
so the rules are kept as data: the spec tables say where each tensor
would live on a mesh (the dry run, the elastic planner and the tests read
them), and ``constrain`` / ``named_shardings`` are identities.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the reference's ``PartitionSpec``
entries).  A mesh is any object with ``.shape`` (axis name -> size) and
``.axis_names`` (``repro_torch.launch.mesh.MeshSpec``).

Logical axes used by the model code:
    "batch"   -> ("pod", "data")   activations' batch dim
    "seq"     -> "model"           sequence parallelism (KV caches, long ctx)
    "heads"   -> "model"           attention-head tensor parallelism
    "ff"      -> "model"           FFN hidden tensor parallelism
    "expert"  -> "model"           expert parallelism
    "vocab"   -> "model"           embedding/logits sharding
    "data"    -> "data"            dispatch-buffer token sharding
    "fsdp"    -> ("pod", "data")   ZeRO/FSDP param dim (the sortdest grad sync)

Rules silently fall back to replication when a dim is not divisible by the
assigned mesh axes (e.g. hubert's vocab=504 on model=16, gemma3's 4 heads).
"""

from __future__ import annotations

import math

from repro_torch.checkpoint.store import _leaves, _rebuild

LOGICAL = {
    "batch": ("pod", "data"),
    "seq": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "expert": ("model",),
    "vocab": ("model",),
    "data": ("data",),
    "fsdp": ("pod", "data"),
    None: (),
}


def _mesh_axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def resolve(logical_axes, dims, mesh) -> tuple:
    """Map logical axis names to a spec, dropping non-divisible or absent
    mesh axes (replication fallback).  A mesh axis is used at most once per
    spec (first dim wins)."""
    sizes = _mesh_axis_sizes(mesh)
    used: set = set()
    spec = []
    for ax, dim in zip(logical_axes, dims):
        names = [n for n in LOGICAL.get(ax, ()) if n in sizes and n not in used]
        total = math.prod(sizes[n] for n in names)
        if names and dim % total == 0 and total > 1:
            spec.append(tuple(names) if len(names) > 1 else names[0])
            used.update(names)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical_axes):
    """The reference's ``with_sharding_constraint`` by logical names: on one
    device there is nothing to constrain."""
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules (keyed by leaf path names)
# ---------------------------------------------------------------------------

# name -> logical axes per dim (excluding any leading scan/stack dim)
_PARAM_RULES = {
    "table": ("vocab", None),
    "wq": (None, "heads", None),
    "wk": (None, "heads", None),
    "wv": (None, "heads", None),
    "wo": ("heads", None, None),
    "bq": ("heads", None),
    "bk": ("heads", None),
    "bv": ("heads", None),
    "w_gate": (None, "ff"),
    "w_in": (None, "ff"),
    "w_out": ("ff", None),
    "router": (None, None),
    "scale": (None,),
    # mamba
    "in_proj": (None, "ff"),
    "out_proj": ("ff", None),
    "conv_w": ("ff", None),
    "conv_b": ("ff",),
    "a_log": ("ff", None),
    "d_skip": ("ff",),
    "w_bc": ("ff", None),
    "w_dt": ("ff",),
    "b_dt": ("ff",),
    # xlstm
    "w_qkv": (None, "ff"),
    "w_gates": (None, None),
    "r_gates": (None,),
}

# MoE expert tensors carry a leading expert dim; the expert axis takes the
# model mesh axis, so inner dims are left for fsdp (d or ff is picked by
# _fsdp_axes) -- mapping ff to model too would double-book the axis.
_MOE_RULES = {
    "w_gate": ("expert", None, None),
    "w_in": ("expert", None, None),
    "w_out": ("expert", None, None),
}


def _rule_for(path_names, leaf_ndim):
    name = path_names[-1]
    # MoE expert tensors share leaf names with the dense MLP; they are
    # distinguished by their path (the model nests them under "moe").  Do
    # NOT key on rank: a stacked dense w_gate [repeats, d, ff] and an
    # unstacked expert w_gate [E, d, ff] have the same rank.
    in_moe = any("moe" in p for p in path_names)
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _PARAM_RULES
    axes = rules.get(name)
    if axes is None:
        return (None,) * leaf_ndim
    # stacked params have one extra leading repeat dim
    extra = leaf_ndim - len(axes)
    return (None,) * extra + tuple(axes)


def _fsdp_axes(axes, dims, sizes):
    """Add the fsdp logical axis on the first large, divisible, unsharded dim
    (the ZeRO-3 / sort-destination parameter sharding)."""
    total = math.prod(sizes[n] for n in LOGICAL["fsdp"] if n in sizes)
    if total <= 1:
        return axes
    out = list(axes)
    for i, (ax, dim) in enumerate(zip(axes, dims)):
        if ax is None and dim % total == 0 and dim >= 1024:
            out[i] = "fsdp"
            break
    return tuple(out)


def param_specs(params_shape, mesh, zero=True):
    """Spec tree for a params tree whose leaves have ``.shape`` (tensors on
    the ``meta`` device, or any array)."""
    sizes = _mesh_axis_sizes(mesh)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        axes = _rule_for(tuple(map(str, path)), len(shape))
        if zero:
            axes = _fsdp_axes(axes, shape, sizes)
        return resolve(axes, shape, mesh)

    return map_leaves(leaf_spec, params_shape)


def map_leaves(fn, tree):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``
    (``path``: the dict keys and list indices from the root)."""
    return _rebuild(tree, {path: fn(path, leaf)
                           for path, leaf in _leaves(tree)})


def named_shardings(spec_tree, mesh):
    """The reference's ``NamedSharding`` tree: on one device every leaf
    stays where it is, so the spec tree is returned as it is."""
    return spec_tree
