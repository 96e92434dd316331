"""The PE mesh: one chare per process, and the collectives phase 2 needs.

The twin of ``make_pe_mesh`` in ``repro/core/engine.py`` and of the
collectives the reference's strategies get from XLA inside ``shard_map``
over axis ``"pe"``.  The port has two implementations of one small
interface, which ``core/strategies.py``'s phase 2s and the engine's
superstep loop call:

  ``AXIS0``   every chare on one device, as the leading axis of
              ``[C, ...]`` tensors; each collective is a tensor op on that
              axis (the engine's ``mesh=None``)
  ``PeMesh``  one chare per rank of a ``torch.distributed`` process group
              (NCCL on the card, gloo on the CPU); each rank holds its own
              chare row, ``[1, ...]``, and each collective is a real one

The interface, for a phase-2 input ``x`` whose leading axis is the chare
rows this process holds (all C, or one):

  ``chare_ids``      the global chare ids of those rows
  ``own``            those rows of a ``[C, ...]`` tensor every chare holds
  ``preduce``        ``psum``/``pmin``: ``[rows, ...]`` -> ``[...]``, the
                     reduction over every chare
  ``reduce_scatter`` ``psum_scatter`` (add), or per-chunk blocks +
                     ``all_to_all`` + a local min (min): ``[rows, C, K...]``
                     -> ``[rows, K...]``, chare k gets block k of every chare
  ``all_to_all``     ``[rows, C, ...]`` -> ``[rows, C, ...]``: row k, slot c
                     is what chare c sent chare k
  ``ppermute_ring``  chare m receives chare m-1's ``[rows, ...]``
  ``grid_reduce``    the grid's column-group (axis 0) or row-group (axis 1)
                     reduce over ``grid_groups(R, C)``: ``(red, slot)``,
                     one reduced row per group this process holds a member
                     of (C or R on one device, one on a rank), and for each
                     held row the index of its group's row in ``red``
  ``vote``           MAX of a per-chare flag vector over every chare
  ``any_changed``    the quiescence vote as one host bool
  ``gather_rows``    every chare's ``[1, ...]`` rows into ``[C, ...]``
  ``broadcast``      rank 0's picklable host object, on every rank
  ``sum_counts``     the SUM over every rank of a small host int vector
                     (a run's accounting)

A mesh engine's phase-2 input is consumed: ``PeMesh`` reduces it in place.

Ranks are started by ``spawn`` (``torch.multiprocessing`` and a ``file://``
store in a fresh temporary directory, so concurrent runs never contend for
a port), or joined in-process with ``pe_group``.  A CUDA mesh runs one rank
per card under NCCL; a CPU mesh runs gloo.  Nothing falls back from one to
the other.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

# init and every collective of a rank group; gloo's default is 30 minutes
TIMEOUT = timedelta(seconds=60)


def grid_groups(R, C):
    """The reference's static ``axis_index_groups`` for an R x C rectangle
    grid over chare ids ``r*C + c``: column group c = the R chares
    {r*C+c}, row group r = the C contiguous chares r*C..r*C+C-1.  On one
    device they are the two axes of an ``[R, C, ...]`` view."""
    cols = [[r * C + c for r in range(R)] for c in range(C)]
    rows = [[r * C + c for c in range(C)] for r in range(R)]
    return cols, rows


def reduce_dim(x, dim, combine):
    """One reduce of the monoid ``combine`` (``"add"`` or ``"min"``) over
    ``dim``, in ``x``'s dtype."""
    if combine == "add":
        return x.sum(dim=dim, dtype=x.dtype)
    return x.amin(dim=dim)


class AxisZero:
    """The one-device collectives: the chares are the leading axis of every
    ``[C, ...]`` tensor, and each collective is a tensor op on it."""

    @staticmethod
    def chare_ids(num_chunks, device):
        return torch.arange(num_chunks, device=device)

    @staticmethod
    def own(x):
        return x

    @staticmethod
    def preduce(x, combine):
        return reduce_dim(x, 0, combine)

    @staticmethod
    def reduce_scatter(blocks, combine):
        return reduce_dim(blocks, 0, combine)

    @staticmethod
    def all_to_all(x):
        return x.transpose(0, 1)

    @staticmethod
    def ppermute_ring(x):
        return torch.roll(x, 1, dims=0)

    @staticmethod
    def grid_reduce(x, R, C, axis, combine):
        v = x.reshape((R, C) + tuple(x.shape[1:]))
        ids = torch.arange(R * C, device=x.device)
        return reduce_dim(v, axis, combine), (ids % C if axis == 0
                                             else ids // C)

    @staticmethod
    def vote(flags):
        return flags

    @staticmethod
    def any_changed(delta):
        return bool(delta.any())

    @staticmethod
    def gather_rows(x):
        return x

    @staticmethod
    def broadcast(obj):
        return obj

    @staticmethod
    def sum_counts(vec):
        return [int(v) for v in vec]


AXIS0 = AxisZero()

_OPS = {"add": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(eq=False)
class PeMesh:
    """One chare per rank of the default process group.

    ``size`` ranks, this one ``rank``, its ``device`` (``cuda:<rank's
    card>`` under NCCL, ``cpu`` under gloo), the grid subgroups by member
    tuple (``make_pe_mesh`` creates them, on every rank in one order),
    ``calls``: the collectives this rank issued, by kind (one a
    ``batch_isend_irecv`` hop), and ``bytes``: the bytes each kind put on
    the wire from this rank, for the caller to zero and read.

    A call's bytes follow the ring model the reference's HLO count uses
    (``repro/launch/hloanalysis.py``): of an ``n``-byte payload over a
    group of ``g`` ranks, an all-reduce moves ``2 n (g-1)/g``, a
    reduce-scatter (of its ``n``-byte input), an all-gather (of its
    ``n``-byte output) and an all-to-all ``n (g-1)/g``, a ring hop and a
    broadcast ``n``."""

    size: int
    rank: int
    device: torch.device
    backend: str
    groups: dict
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    bytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def rows(self) -> tuple[int, int]:
        """The chare rows this rank holds, as ``(lo, hi)``."""
        return self.rank, self.rank + 1

    def reset_calls(self):
        self.calls.clear()
        self.bytes.clear()

    def _count(self, kind, nbytes, wire=1.0):
        """One call of ``kind`` whose ``nbytes`` payload moves ``wire`` of
        itself through this rank (``_ring``)."""
        self.calls[kind] += 1
        self.bytes[kind] += nbytes * wire

    def _ring(self, group=None, reduce=False):
        """The ring model's share of a payload one rank sends: ``(g-1)/g``,
        twice that for an all-reduce."""
        g = self.size if group is None else group
        return (2.0 if reduce else 1.0) * (g - 1) / g

    def chare_ids(self, num_chunks, device):
        return torch.tensor([self.rank], device=device)

    def own(self, x):
        return x[self.rank:self.rank + 1]

    def preduce(self, x, combine):
        out = x[0].contiguous()
        self._count("all_reduce", _nbytes(out), self._ring(reduce=True))
        dist.all_reduce(out, op=_OPS[combine])
        return out

    def reduce_scatter(self, blocks, combine):
        mine = blocks[0].contiguous()  # [C, K(, B)]: block k for chare k
        if combine == "add":
            out = mine.new_empty(mine.shape[1:])
            self._count("reduce_scatter", _nbytes(mine), self._ring())
            dist.reduce_scatter_tensor(out.view(-1), mine.view(-1),
                                       op=dist.ReduceOp.SUM)
            return out[None]
        got = torch.empty_like(mine)
        self._count("all_to_all", _nbytes(mine), self._ring())
        dist.all_to_all_single(got, mine)
        return got.amin(dim=0)[None]

    def all_to_all(self, x):
        mine = x[0].contiguous()
        got = torch.empty_like(mine)
        self._count("all_to_all", _nbytes(mine), self._ring())
        dist.all_to_all_single(got, mine)
        return got[None]

    def ppermute_ring(self, x):
        send = x.contiguous()
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.size),
               dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size)]
        self._count("ring_hop", _nbytes(send))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv

    def grid_reduce(self, x, R, C, axis, combine):
        groups = grid_groups(R, C)[axis]
        members = next(g for g in groups if self.rank in g)
        slot = torch.zeros(1, dtype=torch.long, device=x.device)
        if len(members) == 1:
            return x, slot
        out = x[0].contiguous()
        self._count("group_reduce", _nbytes(out),
                    self._ring(len(members), reduce=True))
        dist.all_reduce(out, op=_OPS[combine],
                        group=self.groups.get(tuple(members)))
        return out[None], slot

    def vote(self, flags):
        out = flags.to(torch.int32, copy=True)
        self._count("vote", _nbytes(out), self._ring(reduce=True))
        dist.all_reduce(out, op=dist.ReduceOp.MAX)
        return out != 0

    def any_changed(self, delta):
        return bool(self.vote(delta.any().reshape(1))[0])

    def gather_rows(self, x):
        mine = x.contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        self._count("all_gather", _nbytes(mine) * self.size, self._ring())
        dist.all_gather(parts, mine)
        return torch.cat(parts, dim=0)

    def broadcast(self, obj):
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, device=self.device)
        self._count("broadcast", len(pickle.dumps(box[0])))
        return box[0]

    def sum_counts(self, vec):
        t = torch.tensor([int(v) for v in vec], dtype=torch.int64,
                         device=self.device)
        self._count("sum_counts", _nbytes(t), self._ring(reduce=True))
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return [int(v) for v in t.tolist()]


def _nbytes(t):
    return t.numel() * t.element_size()


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _check_cards(num_pes, device):
    if device.type == "cuda" and num_pes > torch.cuda.device_count():
        raise ValueError(
            f"requested {num_pes} PEs but only {torch.cuda.device_count()} "
            "CUDA devices: a CUDA mesh runs one rank per card")


def make_pe_mesh(num_pes: int, device=None) -> PeMesh:
    """The 1-D mesh of ``num_pes`` chares over the default process group,
    which this process has joined (``spawn``, ``pe_group``).

    ``device`` is CUDA unless the caller names the CPU: NCCL on the card
    (one rank per card, this rank's current device), gloo on the CPU.  It
    raises when ``num_pes`` exceeds the cards or differs from the world
    size, or when the group's backend is not the device's; it never falls
    back.  Every rank creates every subgroup a ``grid(R, C)`` of
    ``num_pes`` rectangles can ask for, once and in one order."""
    from repro_torch.core.engine import resolve_device

    device = resolve_device(device)
    _check_cards(num_pes, device)
    if not dist.is_initialized():
        raise RuntimeError("make_pe_mesh needs a process group: start the "
                           "ranks with spawn(...) or join one with "
                           "pe_group(...)")
    backend = dist.get_backend()
    if backend != _backend(device):
        raise ValueError(f"a {device.type} mesh runs {_backend(device)}, "
                         f"and this process group is {backend}")
    world = dist.get_world_size()
    if num_pes != world:
        raise ValueError(f"requested {num_pes} PEs in a process group of "
                         f"{world} ranks: a mesh spans the whole group")
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    groups = {}
    for R in range(1, world + 1):
        if world % R:
            continue
        for axis_groups in grid_groups(R, world // R):
            for g in axis_groups:
                key = tuple(g)
                if 1 < len(g) < world and key not in groups:
                    groups[key] = dist.new_group(list(g))
    return PeMesh(size=world, rank=dist.get_rank(), device=device,
                  backend=backend, groups=groups)


@contextlib.contextmanager
def pe_group(rank: int, world_size: int, store_dir: str, device="cuda"):
    """Join the default process group as ``rank`` of ``world_size`` through
    a ``file://`` store in ``store_dir`` (NCCL for a CUDA device, after
    ``torch.cuda.set_device(rank)``; gloo for the CPU), and leave it on
    exit.  Init and collectives time out after ``TIMEOUT``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group(
        _backend(device), init_method="file://" + os.path.join(store_dir,
                                                               "store"),
        rank=rank, world_size=world_size, timeout=TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, fn, world_size, device, store_dir, args):
    """One spawned rank: join the group, build the mesh, run ``fn(mesh,
    *args)``; rank 0 pickles the result, a failing rank its exception,
    before it leaves the group (leaving fails the ranks still connecting,
    and the cause must be on file first)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # ranks share the host's cores
    filed = False
    try:
        with pe_group(rank, world_size, store_dir, device):
            try:
                out = fn(make_pe_mesh(world_size, device), *args)
            except BaseException as exc:
                _file_error(store_dir, rank, exc)
                filed = True
                raise
        if rank == 0:
            with open(os.path.join(store_dir, "result.pkl"), "wb") as f:
                pickle.dump(out, f)
    except BaseException as exc:
        if not filed:
            _file_error(store_dir, rank, exc)
        raise


def _file_error(store_dir, rank, exc):
    """Pickle ``exc`` and its traceback as ``error.<rank>.pkl``, and link
    it as ``first_error.pkl`` unless a rank failed before (the link is
    atomic: the first failure, the cause of the others, keeps it)."""
    tb = traceback.format_exc()
    try:
        blob = pickle.dumps((rank, exc, tb))
    except Exception:  # an exception that does not pickle
        blob = pickle.dumps((rank, RuntimeError(f"rank {rank}: {exc!r}"),
                             tb))
    path = os.path.join(store_dir, f"error.{rank}.pkl")
    with open(path, "wb") as f:
        f.write(blob)
    try:
        os.link(path, os.path.join(store_dir, "first_error.pkl"))
    except FileExistsError:
        pass


def _rank_error(store_dir):
    """The first failing rank's exception, with its traceback as a note,
    or None."""
    path = os.path.join(store_dir, "first_error.pkl")
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        rank, exc, tb = pickle.load(f)
    exc.add_note(f"raised in spawned rank {rank}:\n{tb}")
    return exc


def spawn(fn, num_pes: int, *args, device=None, join_timeout: float = 300.0):
    """Run ``fn(mesh, *args)`` on ``num_pes`` ranks, one chare each, and
    return rank 0's result.

    The ranks are fresh processes (``torch.multiprocessing``, spawn start),
    so ``fn`` and ``args`` must pickle and ``fn`` must be importable.  They
    meet through a ``file://`` store in a new temporary directory; init and
    collectives time out after ``TIMEOUT``.  A rank's exception is re-raised
    here (its traceback attached as a note), and the other ranks are
    stopped; ranks still running after ``join_timeout`` seconds are killed
    and ``TimeoutError`` is raised.  ``device`` is CUDA unless the caller
    names the CPU: one rank per card under NCCL, or gloo on the CPU."""
    import torch.multiprocessing as mp

    from repro_torch.core.engine import resolve_device

    device = resolve_device(device)
    _check_cards(num_pes, device)
    with tempfile.TemporaryDirectory(prefix="pe_mesh_") as store_dir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, num_pes, str(device.type), store_dir, args),
            nprocs=num_pes, join=False, start_method="spawn")
        deadline = time.monotonic() + join_timeout
        try:
            while not ctx.join(timeout=max(deadline - time.monotonic(), 0)):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{num_pes} ranks still running after "
                        f"{join_timeout} s")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            exc = _rank_error(store_dir)
            if exc is None:
                raise
            raise exc from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        with open(os.path.join(store_dir, "result.pkl"), "rb") as f:
            return pickle.load(f)
