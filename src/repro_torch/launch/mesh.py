"""Meshes: the production descriptors and the LM's process-group mesh.

The port of ``repro/launch/mesh.py``.  Two kinds of mesh, both with
``.shape`` (axis name -> size) and ``.axis_names``, so the sharding rules
(``repro_torch.models.sharding``) take either:

  ``MeshSpec``  a description: axis names and sizes and nothing placed.
                ``make_production_mesh`` gives the reference's production
                shapes (for the spec tables and the dry run),
                ``make_host_mesh`` a one-device descriptor.
  ``LmMesh``    named axes over the ranks of one ``torch.distributed``
                process group (NCCL on the card, one rank per card; gloo
                on the CPU), rank ``r`` at the row-major coordinates of
                ``r`` (the reference's device order).  Each rank holds
                its subgroup along every axis, and the collectives the
                LM's mesh paths call: the autograd pairs of
                ``copy_to`` / ``reduce_from`` (Megatron's f and g),
                ``gather_from`` / ``scatter_to`` (a dim split over
                axes) and ``ring_shift`` (one hop of the model-axis
                ring), plus the plain ``all_reduce``, ``all_gather`` and
                ``reduce_scatter`` of the sharded train step.  A
                collective over axes of total size 1 is no op at all, so
                a one-rank mesh runs the one-device arithmetic.

Start ranks with ``repro_torch.core.mesh.spawn`` (or join one group with
``pe_group``) and build meshes with ``make_lm_mesh``; one process group
serves several meshes in turn (each call creates its subgroups, on every
rank in one order).

Axis roles (DESIGN.md section 5):
    pod    pure data parallelism across pods (gradient sync crosses the
           inter-pod links exactly once per step)
    data   in-pod data parallelism + ZeRO/fsdp parameter sharding
    model  tensor parallelism (heads / ff / experts / vocab) and sequence
           parallelism for long-context cells
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

# The card's constants for the roofline (``launch/dryrun.py``) and the
# graph kernels' cost model (``benchmarks/kernelbench.py``): the NVIDIA
# H100 SXM data sheet's figures at its 700 W limit.  A card set to a lower
# power limit runs slower under load; ``nvidia-smi`` reports the limit.
PEAK_FLOPS_BF16 = 989e12  # dense bf16 on the tensor cores, FLOP/s
PEAK_FLOPS_F32 = 67e12    # float32 on the CUDA cores (TF32 off), FLOP/s
HBM_BW = 3.35e12          # HBM3, bytes/s
HBM_BYTES = 80e9          # device memory, bytes


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Axis names in order, with their sizes."""

    axes: tuple  # ((name, size), ...)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)


def make_mesh(shape, axis_names) -> MeshSpec:
    return MeshSpec(tuple(zip(axis_names, (int(s) for s in shape))))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_host_mesh(num_devices: int | None = None,
                   name: str = "data") -> MeshSpec:
    """1-D mesh over the devices the port runs on: the one card (or the
    CPU) unless the caller names a count."""
    return make_mesh((num_devices or 1,), (name,))


def mesh_chips(mesh) -> int:
    return math.prod(dict(mesh.shape).values())


# ---------------------------------------------------------------------------
# The LM's mesh over a process group
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")  # the batch and ZeRO axes, outermost first


def _names(names) -> tuple:
    return (names,) if isinstance(names, str) else tuple(names)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(eq=False)
class LmMesh:
    """Named axes over the ranks of the default process group.

    ``axes``: ``((name, size), ...)`` in order, their product the world
    size; this ``rank`` sits at ``coords`` (row-major).  ``groups`` maps
    a tuple of axis names to this rank's subgroup along them (the ranks
    that differ from it only there), for every single axis and for the
    batch axes together; ``calls`` and ``bytes`` count this rank's
    collectives by kind and the bytes each put on the wire by the ring
    model (``repro_torch.core.mesh.PeMesh``'s), for the caller to zero
    and read."""

    axes: tuple
    rank: int
    device: torch.device
    backend: str
    coords: dict
    groups: dict
    split_batch: bool = True
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def axis_size(self, names) -> int:
        """The product of the named axes' sizes (1 for an absent axis)."""
        return math.prod(self.shape.get(n, 1) for n in _names(names))

    def axis_index(self, names) -> int:
        """This rank's row-major index over the named axes (absent axes
        count as size 1)."""
        idx = 0
        for n in _names(names):
            idx = idx * self.shape.get(n, 1) + self.coords.get(n, 0)
        return idx

    def batch_axes(self) -> tuple:
        """The axes this mesh splits a batch over, outermost first: none
        on a ``for_batch`` mesh that keeps the batch replicated."""
        if not self.split_batch:
            return ()
        return tuple(n for n in BATCH_AXES if n in self.shape)

    def for_batch(self, batch: int) -> "LmMesh":
        """This mesh for a global batch of ``batch`` rows: itself where
        the rows split over the batch axes, else a mesh (sharing the
        groups and counters) that keeps the batch replicated on every
        rank -- the reference's fallback (``batch_specs``)."""
        n = self.axis_size(self.batch_axes())
        if n == 1 or batch % n == 0:
            return self
        return dataclasses.replace(self, split_batch=False, calls=self.calls,
                                   bytes=self.bytes)

    def group(self, names):
        """This rank's process group along the named axes (the default
        group where they span the mesh)."""
        names = tuple(n for n in _names(names) if n in self.shape)
        if set(names) == set(self.axis_names):
            return dist.group.WORLD
        return self.groups[names]

    def peers(self, name):
        """The global ranks one step up and one step down axis ``name``
        (cyclic): the ring's next and previous rank."""
        def at(step):
            c = dict(self.coords, **{name: (self.coords[name] + step)
                                     % self.shape[name]})
            return self._rank_of(c)
        return at(1), at(-1)

    def _rank_of(self, coords) -> int:
        r = 0
        for n, size in self.axes:
            r = r * size + coords[n]
        return r

    def reset_calls(self):
        self.calls.clear()
        self.bytes.clear()

    def _count(self, kind, nbytes, g, share):
        self.calls[kind] += 1
        self.bytes[kind] += nbytes * share * (g - 1) / g if g > 1 \
            else nbytes * share

    # -- plain collectives (no autograd); no op over size-1 axes ----------

    def all_reduce(self, t, names, op="sum"):
        """``t`` summed (or maxed) over the named axes, in place."""
        g = self.axis_size(names)
        if g == 1:
            return t
        self._count("all_reduce", _nbytes(t), g, 2.0)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.group(names))
        return t

    def all_gather(self, t, names, dim=0):
        """The named axes' blocks of ``t`` concatenated along ``dim`` in
        their row-major order."""
        g = self.axis_size(names)
        if g == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(g)]
        self._count("all_gather", _nbytes(t) * g, g, 1.0)
        dist.all_gather(parts, t, group=self.group(names))
        return torch.cat(parts, dim=dim)

    def reduce_scatter(self, t, names, dim=0):
        """This rank's block along ``dim`` of ``t`` summed over the named
        axes."""
        g = self.axis_size(names)
        if g == 1:
            return t
        blocks = t.movedim(dim, 0).contiguous()
        out = blocks.new_empty((blocks.shape[0] // g,) + blocks.shape[1:])
        self._count("reduce_scatter", _nbytes(blocks), g, 1.0)
        dist.reduce_scatter_tensor(out, blocks, group=self.group(names))
        return out.movedim(0, dim)

    def shift(self, t, name, step=1):
        """Send ``t`` ``step`` (+1 or -1) along axis ``name``'s ring and
        return what the rank ``-step`` away sent: one
        ``batch_isend_irecv`` hop."""
        nxt, prv = self.peers(name)
        to, frm = (nxt, prv) if step == 1 else (prv, nxt)
        send = t.contiguous()
        recv = torch.empty_like(send)
        grp = self.group(name)
        self._count("ring_hop", _nbytes(send), 1, 1.0)
        ops = [dist.P2POp(dist.isend, send, to, grp),
               dist.P2POp(dist.irecv, recv, frm, grp)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv

    def barrier(self):
        if self.size > 1:
            dist.barrier()


def make_lm_mesh(shape, axis_names=("data", "model"), device=None) -> LmMesh:
    """The ``LmMesh`` of ``shape`` over the default process group, which
    this process has joined (``repro_torch.core.mesh.spawn`` or
    ``pe_group``).  ``device`` is CUDA unless the caller names the CPU:
    NCCL on the card (one rank per card, this rank's current device),
    gloo on the CPU.  It raises when the shape's product is not the world
    size or the group's backend is not the device's; it never falls back.
    Every rank creates every subgroup, once and in one order."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.core.mesh import _backend, _check_cards

    axes = tuple(zip(tuple(axis_names), (int(s) for s in shape)))
    device = resolve_device(device)
    size = math.prod(s for _, s in axes)
    _check_cards(size, device)
    if not dist.is_initialized():
        raise RuntimeError("make_lm_mesh needs a process group: start the "
                           "ranks with spawn(...) or join one with "
                           "pe_group(...)")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise ValueError(f"a {device.type} mesh runs {_backend(device)}, "
                         f"and this process group is {backend}")
    if size != dist.get_world_size():
        raise ValueError(f"a mesh of {dict(axes)} needs {size} ranks; the "
                         f"process group has {dist.get_world_size()}")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    sizes = [s for _, s in axes]
    coords = dict(zip((n for n, _ in axes),
                      _unravel(rank, sizes)))
    names = [n for n, _ in axes]
    wanted = [(n,) for n in names]
    batch = tuple(n for n in BATCH_AXES if n in names)
    if len(batch) > 1:
        wanted.append(batch)
    groups = {}
    for key in wanted:
        if set(key) == set(names) or math.prod(
                dict(axes)[n] for n in key) == 1:
            continue
        rest = [n for n in names if n not in key]
        for fixed in itertools.product(*(range(dict(axes)[n])
                                         for n in rest)):
            members = [r for r in range(size)
                       if [dict(zip(names, _unravel(r, sizes)))[n]
                           for n in rest] == list(fixed)]
            grp = dist.new_group(members)
            if rank in members:
                groups[key] = grp
    return LmMesh(axes=axes, rank=rank, device=device, backend=backend,
                  coords=coords, groups=groups)


def _unravel(r, sizes):
    out = []
    for s in reversed(sizes):
        out.append(r % s)
        r //= s
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# Autograd pairs over mesh axes (the conjugate collectives)
# ---------------------------------------------------------------------------


class _CopyTo(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward (Megatron's
    f: a replicated input entering a region whose ranks each compute a
    part)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), ctx.names), \
            None, None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's g: each rank's
    partial summed into the replicated result)."""

    @staticmethod
    def forward(ctx, x, mesh, names):
        return mesh.all_reduce(x.contiguous().clone(), names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    """All-gather along ``dim`` forward.  Backward, this rank's block of
    the gradient where every rank holds the same (replicated) gradient,
    or the block of its sum over the ranks (a reduce-scatter) where each
    rank's is a part (``summed``)."""

    @staticmethod
    def forward(ctx, x, mesh, names, dim, summed):
        ctx.mesh, ctx.names, ctx.dim, ctx.n = mesh, names, dim, x.shape[dim]
        ctx.summed = summed
        return mesh.all_gather(x, names, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return (ctx.mesh.reduce_scatter(g, ctx.names, ctx.dim), None,
                    None, None, None)
        i = ctx.mesh.axis_index(ctx.names)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None, None, None


class _ScatterTo(torch.autograd.Function):
    """This rank's block along ``dim`` forward; all-gather of the block
    gradients backward (the replicated input's whole gradient)."""

    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        n = x.shape[dim] // mesh.axis_size(names)
        return x.narrow(dim, mesh.axis_index(names) * n, n).clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_gather(g, ctx.names, ctx.dim), None, None, None


class _Shift(torch.autograd.Function):
    """One ring hop along an axis forward (send up, receive from below);
    the gradient travels the other way backward."""

    @staticmethod
    def forward(ctx, x, mesh, name):
        ctx.mesh, ctx.name = mesh, name
        return mesh.shift(x, name, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shift(g, ctx.name, -1), None, None


def _trivial(mesh, names) -> bool:
    return mesh is None or mesh.axis_size(names) == 1


def copy_to(x, mesh, names="model"):
    return x if _trivial(mesh, names) else _CopyTo.apply(x, mesh, names)


def reduce_from(x, mesh, names="model"):
    return x if _trivial(mesh, names) else _ReduceFrom.apply(x, mesh, names)


def gather_from(x, mesh, names, dim, summed=False):
    """The named axes' blocks of ``x`` along ``dim``; ``summed``: each
    rank's gradient of the result is a part of the whole (see
    ``_GatherFrom``)."""
    return x if _trivial(mesh, names) else \
        _GatherFrom.apply(x, mesh, names, dim, summed)


def scatter_to(x, mesh, names, dim):
    return x if _trivial(mesh, names) else \
        _ScatterTo.apply(x, mesh, names, dim)


def ring_shift(x, mesh, name="model"):
    return x if _trivial(mesh, name) else _Shift.apply(x, mesh, name)


def model_size(mesh) -> int:
    """The mesh's model-axis size (1 without a mesh)."""
    return 1 if mesh is None else mesh.axis_size("model")
