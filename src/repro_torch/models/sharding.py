"""Sharding rules: logical axis names -> mesh partition specs.

The port of ``repro/models/sharding.py``.  The spec tables say where
each tensor lives on a mesh; on an ``LmMesh`` (``repro_torch.launch.mesh``:
named axes over the ranks of a process group) ``shard_leaf`` places a
whole tensor by its spec -- each rank keeps its block -- and
``gather_leaf`` puts the blocks back together with all-gathers over the
named dims (``shard_tree`` / ``gather_tree`` over a whole tree, a train
state's included).  The dry run and the elastic planner read the same
tables for a ``MeshSpec``, which places nothing.  The port's sharding is
explicit (the model's mesh paths take the mesh), so ``constrain`` and
``named_shardings`` are identities.

A spec is a plain tuple with one entry per dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the reference's ``PartitionSpec``
entries); a stacked leaf's spec has a leading ``None`` for its repeat
dim.  A mesh is any object with ``.shape`` (axis name -> size) and
``.axis_names``.  Where a block is not one contiguous slice per split
dim, the spec is a ``Spec`` (a tuple, equal to the plain one) that says
how: the SSM mixers' fused projections (``_PARTS``: each rank keeps its
channels of every part) and mLSTM's state on a model axis wider than
its heads (``within``).

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
    """The reference's ``with_sharding_constraint`` by logical names: the
    port places tensors explicitly, so there is nothing to constrain."""
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

# leaves whose split dim (the last) concatenates equal parts, keyed by the
# mixer that holds them (mLSTM and sLSTM share the leaf name w_qkv): a
# rank's block is its channels of every part
_PARTS = {
    ("mamba", "in_proj"): 2,   # [xin | z]
    ("mlstm", "w_qkv"): 3,     # [q | k | v]
    ("slstm", "w_qkv"): 4,     # [z | i | f | o] gates
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


def _parts_for(path_names) -> int:
    return _PARTS.get(tuple(path_names[-2:]), 1)


def param_specs(params_shape, mesh, zero=True):
    """Spec tree for a params tree whose leaves have ``.shape`` (tensors on
    the ``meta`` device, or any array).  A leaf of ``_PARTS`` gets a
    ``Spec`` with its part count, its last dim split only where each part
    divides."""
    sizes = _mesh_axis_sizes(mesh)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        names = tuple(map(str, path))
        axes = _rule_for(names, len(shape))
        if zero:
            axes = _fsdp_axes(axes, shape, sizes)
        parts = _parts_for(names)
        if parts == 1:
            return resolve(axes, shape, mesh)
        return Spec(resolve(axes, shape[:-1] + (shape[-1] // parts,), mesh),
                    parts=parts)

    return map_leaves(leaf_spec, params_shape)


def map_leaves(fn, tree):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``
    (``path``: the dict keys and list indices from the root)."""
    return _rebuild(tree, {path: fn(path, leaf)
                           for path, leaf in _leaves(tree)})


def named_shardings(spec_tree, mesh):
    """The reference's ``NamedSharding`` tree: the port places leaves
    with ``shard_tree``, so the spec tree is returned as it is."""
    return spec_tree


# ---------------------------------------------------------------------------
# Placement on an LmMesh
# ---------------------------------------------------------------------------


class Spec(tuple):
    """A spec whose blocks are not one contiguous slice per split dim; as
    a tuple it equals the plain spec (the spec tables' entries).

    ``parts``   the last dim concatenates ``parts`` equal parts, and the
                axes that split it split each part: a rank's block is its
                block of every part, in part order.
    ``within``  ``(dim, count, names)``: dim ``dim`` (counted from the
                end) holds ``count`` blocks, each on ``size // count``
                consecutive ranks along ``names`` (``size`` their total):
                the rank at index ``i`` over them keeps block ``i // m``
                (``m = size // count``), and the dim whose entry names
                the same axes is split ``m`` ways, at ``i % m``; without
                such a dim the block is whole on each of its ``m`` ranks.
                mLSTM's state where the model axis is wider than the
                heads: a head on each group of ``m`` ranks, its value dim
                split among them (``C``) or kept whole (``n``).
    """

    def __new__(cls, entries, parts=1, within=None):
        self = super().__new__(cls, entries)
        self.parts, self.within = parts, within
        return self

    def __reduce__(self):
        return Spec, (tuple(self), self.parts, self.within)

    def __repr__(self):
        return f"Spec({tuple(self)}, parts={self.parts}, " \
            f"within={self.within})"


def _parts_of(spec, dim) -> int:
    return getattr(spec, "parts", 1) if dim == len(spec) - 1 else 1


def _within_of(spec, ndim):
    """``(dim, count, names)`` of a ``within`` spec (dim from the front),
    or None."""
    within = getattr(spec, "within", None)
    if within is None:
        return None
    dim, count, names = within
    return dim % ndim, count, _axes_of(names)


def block_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec`` (``mesh``: anything with ``.shape``; trailing dims past the
    spec replicated)."""
    sizes = _mesh_axis_sizes(mesh)
    within = _within_of(spec, len(shape))
    out = list(shape)
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        if names:
            g = math.prod(sizes[n] for n in names)
            if within and names == within[2]:
                g //= within[1]
            if out[dim] % (g * _parts_of(spec, dim)):
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"split {g} ways over {names}")
            out[dim] //= g
    if within:
        out[within[0]] //= within[1]
    return tuple(out)


def _axes_of(entry) -> tuple:
    """A spec entry's mesh axis names (``()`` for a replicated dim)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def sharded_axes(spec) -> tuple:
    """Every mesh axis a spec splits a dim over, in dim order."""
    return tuple(n for entry in spec for n in _axes_of(entry))


def _block(t, dim, g, i, parts=1):
    """Block ``i`` of ``g`` along ``dim`` of each of its ``parts``."""
    if t.shape[dim] % (g * parts):
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"into {parts} parts of {g} blocks")
    n = t.shape[dim] // (g * parts)
    if parts == 1:
        return t.narrow(dim, i * n, n)
    return t.unflatten(dim, (parts, g * n)).narrow(dim + 1, i * n, n) \
        .flatten(dim, dim + 1)


def shard_leaf(whole, spec, mesh):
    """This rank's block of ``whole`` under ``spec``: each dim split over
    its axes, the block at this rank's row-major index over them (of each
    part, and inside its ``within`` block, for a ``Spec``)."""
    out = whole
    within = _within_of(spec, whole.dim())
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        if names:
            g, i = mesh.axis_size(names), mesh.axis_index(names)
            if within and names == within[2]:
                g //= within[1]
                i %= g
            out = _block(out, dim, g, i, _parts_of(spec, dim))
    if within:
        dim, count, names = within
        m = mesh.axis_size(names) // count
        out = _block(out, dim, count, mesh.axis_index(names) // m)
    return out.clone() if out is not whole else out


def gather_leaf(shard, spec, mesh):
    """The whole tensor from each rank's block under ``spec``: one
    all-gather over the axes of each split dim (the parts of a ``Spec``'s
    last dim put back in order; a ``within`` block gathered with the dim
    split inside it, or from one rank of each block)."""
    out = shard
    within = _within_of(spec, shard.dim())
    inner = None
    for dim, entry in enumerate(spec):
        names = _axes_of(entry)
        if not names:
            continue
        if within and names == within[2]:
            inner = dim
            continue
        g, parts = mesh.axis_size(names), _parts_of(spec, dim)
        out = mesh.all_gather(out, names, dim)
        if parts > 1:  # [rank, part, block] -> [part, rank, block]
            out = out.unflatten(dim, (g, parts, -1)).transpose(
                dim, dim + 1).flatten(dim, dim + 2)
    if within:
        dim, count, names = within
        if inner is None:  # every rank of a block holds it whole: take one
            m = mesh.axis_size(names) // count
            out = mesh.all_gather(out, names, dim).unflatten(
                dim, (count, m, -1)).select(dim + 1, 0).flatten(dim, dim + 1)
        else:  # the ranks' blocks along ``inner``: [count, m * block]
            out = mesh.all_gather(out, names, inner).unflatten(
                inner, (count, -1)).movedim(inner, dim).flatten(dim, dim + 1)
    return out


def map_specs(fn, tree, specs):
    """``tree``'s structure (dicts, lists, tuples, dataclasses) with each
    leaf replaced by ``fn(leaf, spec)``, ``spec`` the object at the same
    place in ``specs`` (a spec tree's own tuples are its leaves, so it is
    walked along ``tree``)."""
    return _rebuild(tree, {path: fn(leaf, _spec_at(specs, path))
                           for path, leaf in _leaves(tree)})


def _spec_at(specs, path):
    node = specs
    for step in path:
        node = node[step] if isinstance(node, (dict, list, tuple)) \
            else getattr(node, step)
    return node


def shard_tree(tree, specs, mesh):
    """``shard_leaf`` over every leaf of ``tree``."""
    return map_specs(lambda t, s: shard_leaf(t, s, mesh), tree, specs)


def gather_tree(tree, specs, mesh):
    """``gather_leaf`` over every leaf of ``tree``."""
    return map_specs(lambda t, s: gather_leaf(t, s, mesh), tree, specs)
