"""Checkpoint store: atomic, async-capable tensor-tree checkpoints -- plus the
disk layout cache the streamed execution mode reads shards from.

The port of ``repro/checkpoint/store.py``, in the same file formats, so an
entry written by either package is read by the other.

Tensor trees (nested dicts, lists, tuples and dataclasses of tensors; state
dicts, train states), one directory per step:
    <dir>/step_00000100/
        arrays.npz        every leaf, keyed by its '/'-joined path (dict
                          key, list index or dataclass field; dict keys in
                          sorted order)
        meta.json         {"step": 100, "keys": [<sorted leaf keys>]}
    <dir>/step_00000100.tmp_*   (staging; atomically renamed on completion)
npz cannot hold bfloat16 or the fp8 types: such a leaf is stored as its
same-width unsigned view, with its dtype's name under ``__dtype__/<key>``;
the port decodes it through ``torch.bfloat16`` / ``torch.float8_*`` and
needs no ``ml_dtypes``.  Leaves are saved whole (device -> host);
``restore_checkpoint`` places them on one device (``device=``, the
reference's ``shardings=`` on one device).  Writers stage into a tmp
directory and ``os.replace`` it into place, so readers only ever see
complete checkpoints; a crashed writer's staging is ignored and removed by
the next save's GC, which keeps the ``keep`` most recent steps.
``restore_checkpoint`` checks the requested structure against
``meta.json`` up front: one error names every missing leaf.
``AsyncCheckpointer`` snapshots to host memory at ``save`` and writes in a
background thread; ``wait()`` joins it and re-raises what it died on.

Layout cache: one directory per content fingerprint (graph bytes +
partitioner + chare count + layout name), one plain ``.npy`` per array so
``open_layout_cache`` can hand back memory-mapped views without
materializing gigabytes of host memory, and a ``meta.json``, staged and
renamed into place the same way.  The fingerprint is the reference's
SHA-256 over the same bytes.  Stale entries (the graph or the partitioner
changed) miss on fingerprint and are rebuilt, never silently reused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Tensor-tree checkpoints
# ---------------------------------------------------------------------------

_WIDTH_TO_UINT = {1: np.uint8, 2: np.uint16, 4: np.uint32}
_WIDTH_TO_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
# torch dtypes numpy cannot hold, stored as same-width uint views
_VIEWED = {torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2}


def _encode(leaf):
    """One leaf as (numpy array, dtype name or None): bf16 and fp8 as their
    same-width uint view plus the true dtype's name (the names
    ``ml_dtypes`` gives them, which the reference decodes)."""
    if isinstance(leaf, torch.Tensor):
        # a copy: a later in-place update of the tensor must not reach an
        # asynchronous write
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype in _VIEWED:
            width = t.element_size()
            arr = t.view(_WIDTH_TO_INT[width]).numpy() \
                .view(_WIDTH_TO_UINT[width])
            return arr, str(t.dtype).removeprefix("torch.")
        return t.numpy(), None
    return np.array(leaf), None


def _decode(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    arr = np.array(arr)  # a C-ordered copy that keeps a 0-d leaf 0-d
    if dtype_name is None:
        return torch.from_numpy(arr)
    signed = arr.view({1: np.uint8, 2: np.int16, 4: np.int32}[arr.itemsize])
    return torch.from_numpy(signed).view(getattr(torch, dtype_name))


def _is_dataclass(tree) -> bool:
    return dataclasses.is_dataclass(tree) and not isinstance(tree, type)


def _leaves(tree, path=()):
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    list and tuple items by index, a dataclass's fields by name in their
    order (``TrainState``: ``step``, ``params``, ``opt_state``), ``None``
    an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif _is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), path + (f.name,))
    else:
        yield path, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _rebuild(tree, new, path=()):
    """``tree``'s structure with each leaf replaced by ``new[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, new, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, new, path + (i,))
                          for i, v in enumerate(tree))
    if _is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), new, path + (f.name,))
            for f in dataclasses.fields(tree)})
    return new[path]


def _flatten(tree):
    """``{key: numpy array}`` for every leaf (device -> host), plus a
    ``__dtype__/<key>`` entry per bf16/fp8 leaf."""
    out = {}
    for path, leaf in _leaves(tree):
        key = _key(path)
        arr, dtype_name = _encode(leaf)
        out[key] = arr
        if dtype_name is not None:
            out["__dtype__/" + key] = np.asarray(dtype_name)
    return out


def _write(directory: str, step: int, flat: dict) -> str:
    """Stage ``flat`` in a tmp directory and rename it into place."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp_", dir=directory)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": int(step), "keys": sorted(flat)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    """Blocking save. Returns the final checkpoint path."""
    final = _write(directory, step, _flatten(tree))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    for name in os.listdir(directory):  # crashed writers
        if ".tmp_" in name:
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def _list_steps(directory: str):
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and ".tmp_" not in name and \
                os.path.exists(os.path.join(directory, name, "meta.json")):
            out.append(int(name[len("step_"):]))
    return out


def latest_step(directory: str) -> int | None:
    steps = _list_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like, step: int | None = None,
                       device=None):
    """Restore into the structure of ``tree_like``, whose tensor leaves
    (``meta`` tensors included) give shapes and dtypes.  Returns ``(tree,
    step)``.  Each leaf lands on ``device``; with ``device=None``, on its
    ``tree_like`` leaf's device, and a ``meta`` leaf on CUDA
    (``repro_torch.core.engine.resolve_device``).
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k] for k in z.files}

    keyed = [(p, _key(p), leaf) for p, leaf in _leaves(tree_like)]
    # validate the requested structure against meta.json's key list before
    # touching any leaf: one error naming everything that's absent
    with open(os.path.join(path, "meta.json")) as f:
        stored = set(json.load(f).get("keys", flat))
    missing = sorted(k for _, k, _ in keyed if k not in stored)
    if missing:
        raise KeyError(f"checkpoint {path} missing {len(missing)} leaves: "
                       f"{missing}")

    out = {}
    for p, key, leaf in keyed:
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        dt_key = "__dtype__/" + key
        t = _decode(flat[key], str(flat[dt_key]) if dt_key in flat else None)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {tuple(leaf.shape)}")
        where = device
        if where is None:
            # imported here: repro_torch.core imports this module
            from repro_torch.core.engine import resolve_device

            where = resolve_device(None) if leaf.device.type == "meta" \
                else leaf.device
        out[p] = t.to(leaf.dtype).to(where)
    return _rebuild(tree_like, out), step


class AsyncCheckpointer:
    """Snapshot-now, write-later checkpointing (overlaps I/O with work).

    ``save`` copies every leaf to host memory before it returns; a
    background thread writes it.  A failure in the writer is captured and
    re-raised from the *next* ``wait()`` or ``save()`` -- a dead daemon
    thread must not turn a lost checkpoint into a silent success.
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree):
        self.wait()
        flat = _flatten(tree)  # synchronous device->host snapshot

        def _write_and_gc():
            try:
                _write(self.directory, step, flat)
                _gc(self.directory, self.keep)
            except BaseException as e:
                self._error = e

        self._thread = threading.Thread(target=_write_and_gc, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


# ---------------------------------------------------------------------------
# Disk layout cache (streamed execution + PE/strategy sweeps)
# ---------------------------------------------------------------------------

# Bump whenever the layout build changes meaning (sort key, packing, band
# conventions) so old cache entries miss instead of poisoning new runs; the
# reference's value, so both packages share entries.
LAYOUT_CACHE_VERSION = 1


def layout_fingerprint(graph, partitioner: str, num_chunks: int,
                       which: str) -> str:
    """Content hash of one edge-layout build: the graph bytes
    (indptr/dst/weight), the partitioner spec string, the chare count, the
    layout name and ``LAYOUT_CACHE_VERSION``.  Any change to any input
    gives another fingerprint."""
    h = hashlib.sha256()
    h.update(f"v{LAYOUT_CACHE_VERSION}|{partitioner}|{int(num_chunks)}|"
             f"{which}|{graph.num_vertices}|{int(graph.directed)}".encode())
    h.update(np.ascontiguousarray(graph.indptr).tobytes())
    h.update(np.ascontiguousarray(graph.dst).tobytes())
    if graph.weight is not None:
        h.update(np.ascontiguousarray(graph.weight).tobytes())
    return h.hexdigest()


def _layout_entry(directory: str, fingerprint: str) -> str:
    return os.path.join(directory, f"layout_{fingerprint[:16]}")


def save_layout_cache(directory: str, fingerprint: str,
                      arrays: dict[str, np.ndarray]) -> str:
    """Atomically persist one layout build; returns the entry path.  One
    plain ``.npy`` per array (zip members cannot be memory-mapped), staged
    in a tmp directory and ``os.replace``d into place."""
    os.makedirs(directory, exist_ok=True)
    final = _layout_entry(directory, fingerprint)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(final) + ".tmp_",
                           dir=directory)
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, f"{name}.npy"),
                    np.ascontiguousarray(arr))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"fingerprint": fingerprint,
                       "keys": sorted(arrays)}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def open_layout_cache(directory: str, fingerprint: str):
    """``{name: memory-mapped array}`` for an exact fingerprint hit; ``None``
    on a miss.  An entry whose stored fingerprint differs from the requested
    one (a truncated-prefix collision, a tampered or torn entry) raises
    ``ValueError`` rather than returning wrong shards."""
    path = _layout_entry(directory, fingerprint)
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("fingerprint") != fingerprint:
        raise ValueError(f"layout cache entry {path} is stale: stored "
                         f"fingerprint {meta.get('fingerprint')!r} != "
                         f"requested {fingerprint!r}")
    return {k: np.load(os.path.join(path, f"{k}.npy"), mmap_mode="r")
            for k in meta["keys"]}
