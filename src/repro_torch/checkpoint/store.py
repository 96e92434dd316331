"""The disk layout cache the streamed execution mode reads shards from.

The port's copy of the layout-cache half of ``repro/checkpoint/store.py``,
in the same file format: one directory per content fingerprint (graph bytes
+ partitioner + chare count + layout name), one plain ``.npy`` per array so
``open_layout_cache`` can hand back memory-mapped views without
materializing gigabytes of host memory, and a ``meta.json``.  Writers stage
into a tmp directory and ``os.replace`` it into place, so readers only ever
see complete entries.  The fingerprint is the reference's SHA-256 over the
same bytes: an entry written by either package is a hit for the other.
Stale entries (the graph or the partitioner changed) miss on fingerprint and
are rebuilt, never silently reused.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

import numpy as np

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
