"""Op-level analyzer: FLOPs, bytes and launches of one eager call.

The port's counterpart of ``repro/launch/hloanalysis.py``.  The reference
compiles a step and parses XLA's optimized HLO, multiplying each while
body by its trip count; the port runs eagerly, so ``analyze(fn, *args)``
runs the call itself under one ``TorchDispatchMode`` and reads every aten
op it dispatches -- the forward, autograd's backward and a checkpoint's
recompute alike.  The eager program runs its loops, so no trip count is
needed, and on the ``meta`` device (tensors with shapes and no storage)
a full-size step costs only its Python.  On CUDA tensors the same ops
run for real: the counts must not depend on the device.

What is counted, per op that launches work:
    flops   dots and convolutions only, 2*prod(out)*K (the reference's
            convention, MFU accounting), by the formulas that
            ``torch.utils.flop_counter`` registers for ``mm``, ``bmm``,
            ``addmm``, ``baddbmm`` and the convolutions; elementwise work
            is ignored.  ``flops_by_dtype`` splits them by the product's
            dtype (the card runs bf16 and f32 products at different peaks).
    bytes   the op's tensor operands plus its outputs: nothing is fused,
            so each op reads and writes its tensors through HBM.  A write
            into ``self`` (``copy_``, ``fill_``, ``zero_``) does not read
            it; a gather (``index``, ``index_select``, ``embedding``,
            ``gather``) reads only the rows it returns (twice their bytes
            plus the indices), and an indexed write (``index_put_``,
            ``index_add_``, ``scatter*_``) touches only its rows (its
            floating-point operands twice, its integer ones once), as the
            reference counts ``gather`` and ``scatter``.
    ops     launches by aten op name.  Views, metadata-only ops and
            allocations (``empty*``) launch nothing and count 0 bytes.
    peak_live_bytes
            the most bytes of storage alive at once during the call,
            the arguments' included (each storage is counted from the op
            that creates it until it is freed).

Collectives: ``analyze(fn, *args, mesh=m)`` reads the ``LmMesh``'s
counters (``repro_torch.launch.mesh``) around the call -- on a trace
mesh the calls rank 0 would issue, on a process group the ones it did
(their c10d ops run outside the dispatch mode, so the aten ops are the
same either way).  ``collective_bytes`` is the wire bytes of the
reference ``hloanalysis``'s ring formula, ``per_collective`` and
``collective_calls`` split them by kind, ``collective_count`` counts the
calls, ``per_axes`` splits the bytes by the axes a call spans (``"data"``,
``"pod+data"``) and ``per_link`` by the link ``launch.mesh.link_bw``
prices them on (``"nvlink"``, ``"ib"``).  Without a mesh they are 0, as
the reference's are on one device.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.checkpoint.store import _leaves
from repro_torch.launch.mesh import link_name

aten = torch.ops.aten

_DOTS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
         aten._convolution, aten.convolution_backward)
_ALLOCATIONS = (aten.empty, aten.empty_strided, aten.empty_like,
                aten.new_empty, aten.new_empty_strided)
_METADATA = (aten.detach, aten.alias, aten._unsafe_view, aten.lift_fresh,
             aten.set_, aten._reshape_alias, aten.resize_)
_WRITE_ONLY = (aten.copy_, aten.fill_, aten.zero_)
_GATHERS = (aten.index, aten.index_select, aten.embedding, aten.gather)
_INDEXED_WRITES = (aten.index_put_, aten._index_put_impl_, aten.index_add_,
                   aten.scatter_, aten.scatter_add_, aten.scatter_reduce_)

DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32",
               torch.float16: "f16", torch.float64: "f64"}


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(default_factory=dict)
    collective_count: int = 0
    flops_by_dtype: dict = dataclasses.field(default_factory=Counter)
    ops: dict = dataclasses.field(default_factory=Counter)
    peak_live_bytes: int = 0
    collective_calls: dict = dataclasses.field(default_factory=dict)
    per_axes: dict = dataclasses.field(default_factory=dict)
    per_link: dict = dataclasses.field(default_factory=dict)

    @property
    def launches(self) -> int:
        return sum(self.ops.values())

    def to_dict(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "per_collective": dict(self.per_collective),
            "collective_count": self.collective_count,
            "collective_calls": dict(self.collective_calls),
            "per_axes": dict(self.per_axes),
            "per_link": dict(self.per_link),
            "flops_by_dtype": dict(self.flops_by_dtype),
            "launches": self.launches,
            "ops": dict(self.ops),
            "peak_live_bytes": self.peak_live_bytes,
        }


class _Live:
    """Bytes of the storages alive at once: a storage enters when first
    seen and leaves when torch frees it (a weakref finalizer on the
    storage, which torch keeps alive as long as any tensor holds it)."""

    def __init__(self):
        self.keys = {}
        self.now = self.peak = 0
        self.lock = threading.Lock()

    def add(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.keys:
            return False
        n = st.nbytes()
        with self.lock:
            self.keys[key] = weakref.finalize(st, self._free, key, n)
            self.now += n
            self.peak = max(self.peak, self.now)
        return True

    def _free(self, key, n):
        with self.lock:
            if self.keys.pop(key, None) is not None:
                self.now -= n

    def close(self):
        for fin in list(self.keys.values()):
            fin.detach()
        self.keys.clear()


class _Mode(TorchDispatchMode):
    def __init__(self, res: Analysis, live: _Live):
        super().__init__()
        self.res, self.live = res, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _METADATA:
            return out
        outs = _tensors(out)
        for t in outs:
            self.live.add(t)
        if packet in _ALLOCATIONS:
            return out
        ins = _tensors((args, kwargs))
        res = self.res
        res.ops[packet.__name__] += 1
        if packet in _WRITE_ONLY:
            nbytes = sum(map(_nbytes, ins))
        elif packet in _GATHERS:
            nbytes = 2 * sum(map(_nbytes, outs)) + \
                sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        elif packet in _INDEXED_WRITES:
            nbytes = sum(2 * _nbytes(t) if t.is_floating_point() else
                         _nbytes(t) for t in ins[1:])
        else:
            nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        res.bytes_accessed += nbytes
        if packet in _DOTS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            dtype = outs[0].dtype if outs else ins[0].dtype
            res.flops += flops
            res.flops_by_dtype[DTYPE_NAMES.get(dtype, str(dtype))] += flops
        return out


def tree_leaves(tree):
    """``(path, tensor)`` for every tensor of a tree of dicts, lists,
    tuples and dataclasses (``TrainState``), in the checkpoint's order."""
    return [(p, t) for p, t in _leaves(tree) if isinstance(t, torch.Tensor)]


def storages(tree) -> dict:
    """``{storage key: bytes}`` of the distinct storages a tree holds."""
    out = {}
    for _, t in tree_leaves(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _collectives(res, mesh, before):
    """The mesh's counts since ``before`` into ``res``."""
    calls, nbytes, axis_bytes = (c - b for c, b in zip(
        (mesh.calls, mesh.bytes, mesh.axis_bytes), before))
    res.collective_calls = dict(calls)
    res.per_collective = dict(nbytes)
    res.collective_count = sum(calls.values())
    res.collective_bytes = float(sum(nbytes.values()))
    per_axes, per_link = Counter(), Counter()
    for (_, names), b in axis_bytes.items():
        per_axes["+".join(names)] += b
        per_link[link_name(mesh, names)] += b
    res.per_axes, res.per_link = dict(per_axes), dict(per_link)


def analyze(fn, *args, mesh=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the analyzer -> ``(result,
    Analysis)``.  The arguments' storages count as live from the start;
    ``mesh``: the ``LmMesh`` whose collectives the call issues."""
    res, live = Analysis(), _Live()
    for _, t in tree_leaves((args, kwargs)):
        live.add(t)
    before = None if mesh is None else tuple(
        Counter(c) for c in (mesh.calls, mesh.bytes, mesh.axis_bytes))
    try:
        with _Mode(res, live):
            result = fn(*args, **kwargs)
        res.peak_live_bytes = live.peak
    finally:
        live.close()
    if mesh is not None:
        _collectives(res, mesh, before)
    return result, res

