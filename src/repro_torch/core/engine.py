"""Actor-superstep engine: every chare of a partition on one device.

The twin of the resident ``Engine`` of ``repro/core/engine.py``.  Per
superstep each chare (i) scans its local edges and aggregates outgoing data
(phase 1: one push -- a fused launch or a gather and a scatter launch --
over every chare's ``[Emax]`` row at once), (ii) exchanges messages (phase
2: a reduction over the chare axis, or for ``basic`` a swap of the chare
axes and one scatter launch), (iii) applies the received payloads to its
vertex state, with quiescence detection between supersteps.

Fixed-iteration programs (PageRank) run a plain loop; convergence programs
(label propagation, SSSP, BFS) loop until no vertex changed, with frontier
masking -- vertices whose state did not change last superstep send the
combiner identity.  The loop is Python with one host sync per superstep (the
quiescence test).

``push_fn="auto"`` prices the layout's band table
(``blocks.choose_push``) exactly as the reference does, records the
decision in ``Engine.dispatch`` and installs the matching hook: the fused
push for a ``fused`` choice, the staged pair (``make_push_fn(fused=False)``)
for a ``staged`` one.  On the card either launches the CUDA kernels; on the
CPU it runs their plain version.  ``push_fn=None`` runs the staged pipeline
without a hook (the staged gather and scatter kernels on the card, plain
torch on the CPU), with its segment combine through ``segment_fn`` when one
is given.  ``basic`` reads the pairwise layout and has no push loop to hook.

A ``grid(R,C)`` partition runs the ``grid2d`` two-phase reduce whatever
1-D strategy is asked for: its R*C rectangles are the chare axis, each
with its row chunk's state (replicated across the row's C rectangles),
and phase 2 is a column combine and a row redistribution, lowered as one
full-axis reduce or as column-group and row-group reduces
(``collectives``).  Each lowering counts the bytes its reduces would put
on a mesh's wire, per rectangle per superstep, in
``Engine.dispatch["collectives"]``.

``run_batch`` runs B queries of one program as a ``[C, K, B]`` plane: one
push per superstep serves every column (the strategies and kernels take the
trailing axis), with per-query convergence.  Its host side stays on the
device: the seed and teleport planes are built there, the result is
un-permuted there (one ``index_select`` through a device copy of
``global_to_local``) and comes back in one copy into pinned host memory, as
``run``'s single state does.

Three adaptive modes ride on the loop, in ``run`` and ``run_batch`` alike:

  * ``replan=`` (a partitioner name or a ``ReplanPolicy``) runs the loop in
    segments of ``every`` supersteps; at a segment boundary a trigger may
    re-place the graph (``PartitionedGraph.repartition``), move the state
    across through the composed relabel (``PartitionPlan.padded_map_from``,
    one on-device ``index_copy``; 1-D <-> 2-D through ``row_plan_of``) and
    rebind the engine to the new layout.  Chained segments give the
    reference's superstep sequence and counts exactly.
  * ``sync="overlap"`` relaxes the barrier for min-monoid convergence
    programs: phase 2 of superstep t and phase 1 of t+1 share no data
    dependency (a pending partial is carried), updates land one superstep
    stale, and termination takes two quiet applies in a row.  On one card
    both phases run on one stream in the reference's order; there is no
    collective to hide behind.
  * ``gate="frontier"`` skips the phase-1 work of every chare row whose
    live frontier blocks miss its band's source blocks: the row mask
    (``row_active``) is computed on the device each superstep and the push
    kernels read nothing of a gated row -- the reference's per-shard skip at
    row granularity.  Skipped rows accumulate on the device and are read
    once per run into ``Engine.dispatch["gate"]``.

``residency="stream"`` (on a ``grid(R,C)`` partition) runs out of core:
the edge planes stay on the host, or memory-mapped on disk from the layout
cache, and reach the card one double-buffered window at a time
(``_StreamPrefetcher``: a worker thread fills pinned staging slots, a side
copy stream takes them to the device, CUDA events order the copies against
the window folds).  Each superstep folds every window into the running
phase-1 partial through the push kernels' ``init=`` seed, then runs phase 2
and the apply; the host loop reads the convergence flag and the frontier
blocks back in one small copy and gates whole windows on them
(``gate="frontier"``: a slot the frontier cannot reach is never read).  Min
programs are bit-exact against the resident run with equal superstep
counts; add programs differ in float association only.  The accounting
lands in ``Engine.dispatch["stream"]``.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch.core import partitioners as part_mod
from repro_torch.core import strategies as strat
from repro_torch.core.graph import PartitionedGraph
from repro_torch.kernels import blocks


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another; asking for
    CUDA where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine runs on CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return device


def _relabel_gather(init_rows, old_rows, src, tgt):
    """The composed-relabel state move as one on-device op: ``tgt`` slots
    (unique: a relabel is a bijection on live vertices) receive the ``src``
    slots of the old plane; every other slot keeps the caller-built init
    fill."""
    return init_rows.index_copy(0, tgt, old_rows.index_select(0, src))


@dataclasses.dataclass
class ReplanPolicy:
    """When and how the engine re-partitions mid-run.

    The superstep loop runs in segments of ``every`` supersteps; at each
    segment boundary the engine may switch the placement to
    ``partitioner``.  ``mode="skew"`` (the default) triggers when the
    per-chare frontier-edge imbalance (``partition_stats(pg,
    frontier=...)``) exceeds ``threshold``; ``mode="always"`` replans at
    every boundary.  ``max_replans`` bounds the re-placements of one run.
    """

    partitioner: str
    every: int = 4
    threshold: float = 1.5
    mode: str = "skew"
    max_replans: int = 4

    def __post_init__(self):
        if self.mode not in ("skew", "always"):
            raise ValueError(f"unknown replan mode {self.mode!r}")
        if self.every < 1:
            raise ValueError("replan checkpoint interval must be >= 1")


@dataclasses.dataclass
class StreamConfig:
    """Sizing and placement knobs for ``residency="stream"``.

    Exactly one of ``windows`` / ``budget_bytes`` sizes the edge windows:
    ``windows`` asks for that many sweeps per superstep, ``budget_bytes``
    caps the DEVICE-resident edge working set (two staging windows -- the
    double buffer) and takes the widest window that fits.  ``cache_dir``
    points shard reads at the on-disk layout cache
    (``checkpoint.save_layout_cache``): the edge planes are memory-mapped
    and never fully materialized in host memory either.
    ``prefetch=False`` serializes fetch and compute (the no-overlap
    baseline the overlap efficiency is defined against).
    """

    windows: int | None = None
    budget_bytes: int | None = None
    cache_dir: str | None = None
    prefetch: bool = True

    def __post_init__(self):
        if self.windows is not None and self.budget_bytes is not None:
            raise ValueError("pass windows OR budget_bytes, not both")
        if self.windows is not None and self.windows < 1:
            raise ValueError("windows must be >= 1")


class _StreamPrefetcher:
    """Double-buffered host->device pipeline for edge windows.

    Two pinned host staging slots (``ShardSource.make_staging``), two
    device slots of the same flat layout, and one worker thread.  While the
    card folds window k, the worker copies window k+1 out of the (possibly
    memory-mapped) ``ShardSource`` into a host slot with numpy slice copies,
    which release the GIL.  ``take()`` hands the filled slot to a side copy
    stream: one ``copy_(non_blocking=True)`` of the whole slot, after which
    the copy records ``copied[slot]`` and the compute stream waits on it
    before the fold that reads the slot.  The fold's caller records
    ``consumed[slot]`` after it (``folded``), and the next copy into that
    device slot waits on it; before the worker overwrites a host slot it
    synchronizes on that slot's ``copied`` event.  So the worker runs at
    most two windows ahead and nothing on the host waits on the device but
    the worker.

    Accounting, as the reference defines it: ``copy_s`` is data-movement
    work on the host (the staging read and the copy's enqueue); ``stall_s``
    is the share of it the compute pipeline was exposed to.  A consumer
    wait counts as a stall only if the device had nothing left to run: the
    device-busy probe (an event recorded after the last dispatched work,
    ``mark``, read with ``query()``) is sampled at both ends of the wait
    (busy at both: hidden; at one: half; at neither: exposed).  The
    worker's waits on ``copied`` are backpressure, not copy work, and are
    left out.  ``pipelined=False`` reads inside ``take()`` once the device
    is idle and copies on the compute stream, charging the read in full
    (``stall_s == copy_s``): the serialized baseline with the same code.
    On the card each copy is also timed with CUDA events (``h2d_s``,
    ``h2d_bytes``: the H2D link's own rate).  On the CPU the same class
    runs without streams or pinning: the folds read the host slots.
    """

    def __init__(self, source, device, pipelined=True):
        self.source = source
        self.device = device
        self.pipelined = pipelined
        self.cuda = device.type == "cuda"
        self._host = [source.make_staging(pin_memory=self.cuda)
                      for _ in range(2)]
        if self.cuda:
            self._dev = [torch.empty_like(h["buffer"], device=device)
                         for h in self._host]
            self._views = [source.staged_views(b) for b in self._dev]
            self._copy = torch.cuda.Stream(device) if pipelined else None
            self._copied = [torch.cuda.Event(), torch.cuda.Event()]
            self._consumed = [torch.cuda.Event(), torch.cuda.Event()]
            self._probe = torch.cuda.Event()
            self._timing = []  # (start, end) events of each H2D copy
        else:
            self._views = [source.staged_views(h["buffer"])
                           for h in self._host]
        self._marked = False  # has the probe been recorded yet
        self._seq = 0
        self._pending = collections.deque()
        self._ex = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                    if pipelined else None)
        self.copy_s = 0.0
        self.stall_s = 0.0
        self.bytes_read = 0
        self.fetches = 0
        self.h2d_s = 0.0
        self.h2d_bytes = 0

    def mark(self):
        """Record the device-busy probe after the work just dispatched."""
        if self.cuda:
            self._probe.record()
        self._marked = True

    def folded(self, slot):
        """The fold that reads device slot ``slot`` is dispatched: the next
        copy into the slot waits for it."""
        if self.cuda:
            self._consumed[slot].record()
        self.mark()

    def _device_busy(self):
        return self.cuda and self._marked and not self._probe.query()

    def _read(self, k, slot, active):
        bp = 0.0
        if self.cuda:
            # backpressure, not copy work: the copy that read this host
            # slot's previous window must be done before it is overwritten
            t0 = time.perf_counter()
            self._copied[slot].synchronize()
            bp = time.perf_counter() - t0
        t0 = time.perf_counter()
        nbytes = self.source.read_window(k, self._host[slot], active)
        return slot, nbytes, time.perf_counter() - t0, bp

    def submit(self, k, active):
        """Queue window ``k`` (rectangles ``active``) into the next slot."""
        slot = self._seq % 2
        self._seq += 1
        if self._ex is not None:
            self._pending.append(self._ex.submit(self._read, k, slot,
                                                 active))
        else:
            self._pending.append((k, slot, active))

    def _upload(self, slot):
        """Enqueue the H2D copy of a filled host slot; the compute stream
        waits on it."""
        compute = torch.cuda.current_stream(self.device)
        stream = self._copy if self._copy is not None else compute
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(stream):
            stream.wait_event(self._consumed[slot])
            start.record(stream)
            self._dev[slot].copy_(self._host[slot]["buffer"],
                                  non_blocking=True)
            end.record(stream)
            self._copied[slot].record(stream)
        compute.wait_event(self._copied[slot])
        self._timing.append((start, end))
        self.h2d_bytes += self._dev[slot].numel() * 4

    def take(self):
        """-> (the next window's planes on the device, its slot)."""
        item = self._pending.popleft()
        if self._ex is not None:
            busy0 = self._device_busy()
            t0 = time.perf_counter()
            slot, nbytes, dt_read, bp = item.result()
            wait = max(0.0, time.perf_counter() - t0 - bp)
            busy1 = self._device_busy()
            # the wait stalls the pipeline only as far as the device ran
            # dry during it
            self.stall_s += wait * (0.0 if busy0 and busy1
                                    else 0.5 if busy0 or busy1 else 1.0)
        else:
            if self._device_busy():
                self._probe.synchronize()  # serialized: nothing overlaps
            slot, nbytes, dt_read, _ = self._read(*item)
            self.stall_s += dt_read
        t1 = time.perf_counter()
        if self.cuda:
            self._upload(slot)
        put = time.perf_counter() - t1
        self.copy_s += dt_read + put
        if self._ex is None or not self._device_busy():
            self.stall_s += put
        self.bytes_read += nbytes
        self.fetches += 1
        return self._views[slot], slot

    def close(self):
        if self._ex is not None:
            self._ex.shutdown(wait=True)
        if self.cuda:
            (self._copy or torch.cuda.current_stream(self.device)) \
                .synchronize()
            self.h2d_s = sum(s.elapsed_time(e) for s, e in self._timing) / 1e3


@dataclasses.dataclass
class Engine:
    """Runs vertex programs on a partitioned graph with a chosen strategy.

    ``push_fn`` accepts ``"auto"`` (default: the reference's staged-vs-fused
    choice from the measured band occupancy, recorded in ``self.dispatch``),
    ``None`` (explicit staged pipeline), or a callable hook
    (``ops.make_push_fn``, used as given).  ``segment_fn``
    (``ops.make_segment_fn``) takes the local segment combine wherever no
    push hook does, ``basic``'s receive side included.

    The strategy follows the partition's dimensionality: a ``grid(R,C)``
    partition always runs ``grid2d`` (the 1-D layouts do not exist on it),
    and the constructor's 1-D ``strategy`` is what a replan back to a 1-D
    placement rebinds to; asking for ``grid2d`` on a 1-D partition is an
    error.  ``collectives`` picks grid2d's phase-2 lowering: ``"auto"``
    (``"grouped"``), ``"grouped"`` or ``"full"``.  ``residency="stream"``
    (a grid partition only) keeps the edge planes off the device and
    streams them in windows sized by ``stream`` (a ``StreamConfig``).
    """

    pg: PartitionedGraph
    strategy: str = "sortdest"
    device: object = None
    push_fn: object = "auto"
    segment_fn: object = None
    residency: str = "resident"
    collectives: str = "auto"
    stream: StreamConfig | None = None

    def __post_init__(self):
        if self.residency not in ("resident", "stream"):
            raise ValueError(f"unknown residency {self.residency!r}; "
                             "choose 'resident' or 'stream'")
        if self.residency == "stream" and not self.pg.is_grid:
            raise ValueError(
                "residency='stream' needs a grid(R,C) partition -- the "
                "window schedule walks edge rectangles (use grid(1,1) for "
                "a single PE)")
        if self.stream is not None and self.residency != "stream":
            raise ValueError("stream config given but residency is "
                             f"{self.residency!r}")
        if self.collectives not in ("auto", "grouped", "full"):
            raise ValueError(f"unknown collectives mode {self.collectives!r}")
        if self.strategy not in strat.PHASES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(strat.PHASES)}")
        if self.strategy == "grid2d" and not self.pg.is_grid:
            raise ValueError("strategy 'grid2d' needs a grid(R,C) partition "
                             f"(got partitioner {self.pg.partitioner!r})")
        if not (self.push_fn in ("auto", None) or callable(self.push_fn)):
            raise ValueError(
                f"push_fn must be 'auto', None, or a callable hook "
                f"(ops.make_push_fn), got {self.push_fn!r}")
        if not (self.segment_fn is None or callable(self.segment_fn)):
            raise ValueError(f"segment_fn must be None or a callable hook "
                             f"(ops.make_segment_fn), got "
                             f"{self.segment_fn!r}")
        self.device = resolve_device(self.device)
        # the 1-D strategy a replan back to a 1-D placement rebinds to
        self._strategy_request = (self.strategy if self.strategy != "grid2d"
                                  else "sortdest")
        self._push_request = self.push_fn
        self._gate_slots, self._gate_skipped = 0, 0
        self._bind(self.pg)

    def _bind(self, pg: PartitionedGraph):
        """Point the engine at a partition: alias its device-upload cache,
        resolve the strategy and the adaptive dispatch."""
        self.pg = pg
        self.strategy = "grid2d" if pg.is_grid else self._strategy_request
        self._source = None
        layout = strat.STRATEGY_LAYOUT[self.strategy]
        if self.residency == "stream":
            # out of core: only the vertex planes and the row->col map go to
            # the device; the edge planes stay on the host (or on disk,
            # memory-mapped) and come up one window at a time.  The source
            # is built first, so a layout cache hit feeds the band table the
            # dispatch prices.  Each window's band table is uploaded and
            # learns its own tile plan here, once: a recycled staging slot
            # never carries a plan of another window
            cfg = self.stream or StreamConfig()
            self._source = pg.shard_source(windows=cfg.windows,
                                           budget_bytes=cfg.budget_bytes,
                                           cache_dir=cfg.cache_dir)
            self.arrays = {"gr_row_to_col": pg.device_row_to_col(self.device)}
            self._win_bands = self._source.window_bands(self.device)
            if self.device.type == "cuda":
                from repro_torch.kernels import push_fused

                for band in self._win_bands:
                    push_fused.tile_plan(band)
        else:
            # layouts are uploaded once per (partition, device) and shared:
            # engines of a strategy sweep alias the same tensors, and a new
            # partition's upload learns its tile plans there (device_arrays)
            self.arrays = (pg.device_pairwise(self.device)
                           if layout == "pairwise"
                           else pg.device_arrays(layout, self.device))
        self.aux = pg.device_aux(self.device)
        self._C, self._K = pg.num_chunks, pg.chunk_size
        # frontier-gate geometry: the state's BLOCK_V source blocks per chare
        self._gate_nsb = max(-(-self._K // blocks.BLOCK_V), 1)
        p1, p2 = strat.PHASES[self.strategy]
        self._wire = None
        self._grid_meta = None
        if pg.is_grid:
            rows, cols = pg.grid_shape
            meta = self._grid_meta = (rows, cols, pg.col_chunk_size)
            self._collectives = ("grouped" if self.collectives == "auto"
                                 else self.collectives)
            self._wire = {"bytes": 0.0}
            p1 = functools.partial(p1, grid_meta=meta)
            p2 = functools.partial(p2, grid_meta=meta,
                                   collectives=self._collectives,
                                   wire=self._wire)
        self._phases = (p1, p2)
        self.dispatch = self._resolve_dispatch()
        self.dispatch["residency"] = self.residency
        if pg.is_grid:
            self._record_wire(0)
        if self._source is not None:
            sb, cfg = self._source, self.stream or StreamConfig()
            self.dispatch["stream"] = {
                "windows": sb.num_windows,
                "blocks_per_window": sb.blocks_per_window,
                "window_bytes": sb.window_bytes,
                # the device-resident edge working set: two staging windows
                "resident_edge_bytes": 2 * sb.window_bytes,
                "total_edge_bytes": sb.total_edge_bytes,
                "edge_fraction_resident":
                    2 * sb.window_bytes / sb.total_edge_bytes,
                "budget_bytes": cfg.budget_bytes,
                "origin": sb.origin,
            }

    def _rebind(self, pg: PartitionedGraph):
        """Replan rebind: switch to a re-partitioned layout of the same
        graph.  The new partition's device cache starts empty, so every
        layout tensor, band table and tile plan is uploaded and learned
        afresh here (nothing of the old placement can leak), the dispatch is
        resolved again, and the engine keeps no reference to the old
        placement's tensors."""
        if pg.num_chunks != self._C:
            raise ValueError("replan must preserve the chare count "
                             f"({pg.num_chunks} != {self._C})")
        self._bind(pg)

    @property
    def gate_blocks(self) -> torch.Tensor:
        """``[C, nsb]`` bool: the source blocks each chare's edges of the
        bound layout can gather from (``PartitionedGraph.device_gate_blocks``;
        all ones on the pairwise layout, which then gates on any frontier at
        all)."""
        return self.pg.device_gate_blocks(
            strat.STRATEGY_LAYOUT[self.strategy], self.device)

    def _resolve_dispatch(self) -> dict:
        """Resolve ``push_fn='auto'`` against the bound layout's bands.

        Returns the recorded decision; sets ``self.push_fn`` to the callable
        the strategies will actually receive: the fused hook for a
        ``fused`` choice, the staged pair for a ``staged`` one.  ``kernel``
        records whether they run as CUDA kernels or as their plain version.
        """
        kernel = "cuda" if self.device.type == "cuda" else "plain"
        if self._push_request != "auto":
            self.push_fn = self._push_request
            choice = "explicit" if callable(self._push_request) else "staged"
            return {"choice": choice, "mode": "explicit", "kernel": kernel}
        layout = strat.STRATEGY_LAYOUT[self.strategy]
        if layout == "pairwise":
            self.push_fn = None
            return {"choice": "staged", "mode": "auto", "kernel": kernel,
                    "reason": "basic strategy has no push loop to fuse"}
        if layout == "grid":
            # rectangle phase-1 push: gather side is the row-chunk state,
            # scatter side the column-padded destination space
            band = self.pg.gr_band
            scatter = self.pg.grid_shape[1] * self.pg.col_chunk_size
        else:
            band = self.pg.sd_band if layout == "sd" else self.pg.band
            scatter = self._C * self._K
        emax = self.pg.edge_valid.shape[1]
        choice, occ = blocks.choose_push(band, emax, self._K, scatter)
        from repro_torch.kernels import ops

        self.push_fn = ops.make_push_fn(fused=choice == "fused")
        return {"choice": choice, "mode": "auto", "layout": layout,
                "threshold": blocks.BAND_OCC_FUSED_MAX, "kernel": kernel,
                **occ}

    def _record_wire(self, supersteps):
        """``dispatch["collectives"]`` of a grid engine: the lowering and
        the wire bytes its reduces counted per rectangle over the last run
        (``bytes``) and per superstep (``bytes_per_superstep``)."""
        total = self._wire["bytes"]
        self.dispatch["collectives"] = {
            "lowering": self._collectives, "bytes": total,
            "supersteps": supersteps,
            "bytes_per_superstep": total / supersteps if supersteps else 0.0}

    # -- one superstep's halves ----------------------------------------------

    def _row_active(self, frontier):
        """The frontier gate on the device: ``[C]`` int32, 1 where a chare
        row's live frontier (any query column of a plane) reaches a source
        block its edges can gather from.  The frontier is padded to
        ``nsb * BLOCK_V``, reduced per block, intersected with
        ``gate_blocks`` and reduced per row."""
        f = frontier.any(dim=-1) if frontier.dim() == 3 else frontier
        nsb = self._gate_nsb
        width = nsb * blocks.BLOCK_V
        if width != self._K:
            f = torch.cat([f, f.new_zeros((self._C, width - self._K))], 1)
        fb = f.reshape(self._C, nsb, blocks.BLOCK_V).any(dim=2)
        return (fb & self.gate_blocks).any(dim=1).to(torch.int32)

    def _push(self, program, vals, frontier=None, gate=False):
        """Phase 1 of every chare row, gated on ``frontier`` when ``gate``:
        a gated row's partial is the identity and its kernels read nothing.
        Counts the run's launch slots (one per chare row) and, on the
        device, the gated rows."""
        row_active = None
        if gate:
            row_active = self._row_active(frontier)
            self._gate_skipped = self._gate_skipped + (self._C
                                                       - row_active.sum())
        self._gate_slots += self._C
        return self._phases[0](vals, self.arrays, program.combiner, self._C,
                               self._K, segment_fn=self.segment_fn,
                               edge_value=program.edge_value,
                               push_fn=self.push_fn,
                               edge_semiring=program.edge_semiring,
                               row_active=row_active)

    def _combine(self, partial, program):
        """Phase 2: the combine of the phase-1 partials across chares."""
        return self._phases[1](partial, self.arrays, program.combiner,
                               self._C, self._K, segment_fn=self.segment_fn)

    def _propagate(self, vals, program, frontier=None, gate=False):
        """One superstep's message exchange: phase 1 then phase 2."""
        return self._combine(self._push(program, vals, frontier, gate),
                             program)

    # -- mode checks and per-run accounting ----------------------------------

    def _check_residency(self, residency, replan, sync) -> bool:
        """Refuse a run the bound residency cannot serve; -> whether the run
        streams.  A streamed engine holds no resident edge planes, and a
        resident one never streams; replan and overlap are resident-path
        features (the streamed schedule has no segment boundary to relabel
        at, and already pipelines its copies behind compute)."""
        residency = self.residency if residency is None else residency
        if residency not in ("resident", "stream"):
            raise ValueError(f"unknown residency {residency!r}; "
                             "choose 'resident' or 'stream'")
        if residency == "stream" and self.residency != "stream":
            raise ValueError(
                "this engine is bound resident; build it with "
                "Engine(..., residency='stream') so the edge planes "
                "are never uploaded in the first place")
        if residency == "resident" and self.residency == "stream":
            raise ValueError(
                "this engine is bound with residency='stream' and holds no "
                "resident edge planes; build a resident Engine for "
                "residency='resident' runs")
        if residency == "stream":
            if replan is not None:
                raise ValueError(
                    "replan is a resident-path feature: the streamed "
                    "schedule has no segment checkpoints to relabel at; "
                    "run replan=... on an Engine(residency='resident') of "
                    "the same graph, or drop it for the streamed schedule")
            if sync != "barrier":
                raise ValueError(
                    "residency='stream' already pipelines H2D copies "
                    "behind compute; run sync='overlap' on a resident "
                    "Engine, or keep the default sync='barrier' here")
        return residency == "stream"

    @staticmethod
    def _validate_async(program, sync, gate) -> tuple[str, bool]:
        """Normalize/validate the barrier-relaxation knobs against the
        program's algebra: overlap delivers stale reads, which only
        label-correcting min-monoid convergence programs absorb; gating
        needs a frontier, which only convergence programs maintain."""
        if sync not in ("barrier", "overlap"):
            raise ValueError(f"unknown sync mode {sync!r}; "
                             "choose 'barrier' or 'overlap'")
        if sync == "overlap" and (program.fixed_iters is not None
                                  or program.combiner.name != "min"):
            raise ValueError(
                f"sync='overlap' needs a min-monoid convergence program "
                f"(stale reads stay convergent only for label-correcting "
                f"updates); {program.name!r} is not one")
        if gate in (None, False, 0):
            gate = False
        elif gate in (True, "frontier"):
            if program.fixed_iters is not None:
                raise ValueError(
                    f"gate='frontier' needs a convergence program (the gate "
                    f"reads the frontier); {program.name!r} has fixed iters")
            gate = True
        else:
            raise ValueError(f"unknown gate mode {gate!r}; "
                             "choose None or 'frontier'")
        return sync, gate

    def _run_start(self, gate):
        """Zero the run's wire bytes and gate counts (the skipped rows as a
        device scalar when gating, so no superstep waits on the host)."""
        if self._wire is not None:
            self._wire["bytes"] = 0.0
        self._gate_slots = 0
        self._gate_skipped = (torch.zeros((), dtype=torch.int64,
                                          device=self.device) if gate else 0)

    def _run_end(self, supersteps, sync, gate):
        """Publish the run's superstep count, wire bytes (grids) and launch
        accounting: ``dispatch["gate"]`` holds the phase-1 launch slots (one
        per chare row per push, the overlap's seed push of each segment
        included), how many the gate skipped (one read of the device count)
        and the fraction (0.0 when gating is off)."""
        self.dispatch["supersteps"] = supersteps
        if self._wire is not None:
            self._record_wire(supersteps)
        slots, skipped = self._gate_slots, int(self._gate_skipped)
        self.dispatch["gate"] = {
            "sync": sync, "enabled": gate, "launch_slots": slots,
            "skipped_launches": skipped, "launched": slots - skipped,
            "skipped_fraction": skipped / slots if slots else 0.0,
        }

    @staticmethod
    def _program(program, params):
        """A registered name (``params`` forwarded to its factory) or a
        ``VertexProgram`` instance, as a ``VertexProgram``."""
        from repro_torch.core import programs as prog_mod

        if isinstance(program, str):
            return prog_mod.make_program(program, **params)
        if params:
            raise TypeError("params only apply to registered program names")
        return program

    @staticmethod
    def _limit(program) -> int:
        return (program.fixed_iters if program.fixed_iters is not None
                else program.max_iters)

    # -- the superstep loop --------------------------------------------------

    def _loop(self, program, state, frontier, limit, sync="barrier",
              gate=False, drain=False):
        """Up to ``limit`` supersteps of one state ``[C, K]`` from
        ``frontier`` (bool ``[C, K]``; ``None`` for a fixed-iteration run
        that needs none); -> ``(state, frontier, supersteps)``.

        Fixed-iteration programs run the plain counted loop (their frontier,
        when given, is the last superstep's changes).  Convergence programs
        loop while the last apply changed anything, quiesced vertices
        sending the identity; under ``sync='overlap'`` the incoming frontier
        seeds the pipeline's first push, each superstep combines the
        previous superstep's partial while pushing the next, and the loop
        ends after two quiet applies in a row.  ``drain`` (the segmented
        path) folds the partial still in flight and keeps its changes in the
        frontier, so a replan at the boundary never meets a partial.
        """
        aux = self.aux
        if program.fixed_iters is not None:
            for _ in range(limit):
                incoming = self._propagate(program.update(state, aux),
                                           program)
                new = program.apply(state, incoming, aux)
                if frontier is not None:
                    frontier = new != state
                state = new
            return state, frontier, limit
        sent = torch.full((), program.combiner.identity, dtype=state.dtype,
                          device=self.device)

        def masked(state, frontier):
            # frontier masking: quiesced vertices send the identity
            return torch.where(frontier, program.update(state, aux), sent)

        it = 0
        if sync == "overlap":
            pending = self._push(program, masked(state, frontier), frontier,
                                 gate)
            frontier = torch.zeros_like(frontier)  # the seed is pushed once
            quiet = 0
            while quiet < 2 and it < limit:
                incoming = self._combine(pending, program)
                pending = self._push(program, masked(state, frontier),
                                     frontier, gate)
                new = program.apply(state, incoming, aux)
                frontier = new != state
                quiet = 0 if bool(frontier.any()) else quiet + 1
                state = new
                it += 1
            if drain:
                drained = program.apply(state, self._combine(pending, program),
                                        aux)
                frontier = frontier | (drained != state)
                state = drained
            return state, frontier, it
        changed = True
        while changed and it < limit:
            new = program.apply(
                state, self._propagate(masked(state, frontier), program,
                                       frontier, gate), aux)
            frontier = new != state
            changed = bool(frontier.any())
            state = new
            it += 1
        return state, frontier, it

    def run(self, program, replan=None, sync="barrier", gate=None,
            residency=None, **params) -> tuple:
        """Run a vertex program to completion; returns (state, iterations).

        ``program`` is a registered name (params forwarded to its factory)
        or a ``VertexProgram`` instance.  The state comes back as a numpy
        array in original vertex order.  Programs with their own
        ``sources``, ``init_batch`` and ``finalize`` (personalized PageRank,
        betweenness) run on the batched plane, with the same modes, and
        return their finalized result with the global superstep count.

        ``replan`` (a partitioner name or a ``ReplanPolicy``) runs the loop
        in segments and may switch the placement at their boundaries; the
        engine stays bound to the last placement.  ``sync='overlap'``
        relaxes the barrier for min-monoid convergence programs, and
        ``gate='frontier'`` skips the phase-1 work of chare rows the
        frontier cannot reach (accounting in ``self.dispatch['gate']``);
        both compose with ``replan``.

        On an ``Engine(residency='stream')`` the run takes the out-of-core
        window schedule (``residency`` may name it, and must not name the
        other): composes with ``gate='frontier'`` (a gated window slot is
        never fetched), not with ``replan`` or ``sync='overlap'``.  Metrics
        land in ``self.dispatch['stream']``.
        """
        from repro_torch.core import programs as prog_mod

        program = self._program(program, params)
        streamed = self._check_residency(residency, replan, sync)
        sync, gate = self._validate_async(program, sync, gate)
        if (program.sources is not None and program.init_batch is not None
                and program.finalize is not None):
            # inherently multi-source programs (betweenness pivots) run on
            # the batched plane and post-process the per-query rows on the
            # device; the iteration count is the global superstep count
            sets = prog_mod.seed_sets(program.sources)
            plane, q_it = self._batch(program, sets, replan=replan,
                                      sync=sync, gate=gate)
            out = program.finalize(self.pg.graph, sets, plane)
            return self._to_host(out), int(q_it.max())

        if streamed:
            return self._run_streamed(program, gate)
        state = torch.from_numpy(program.init(self.pg)).to(self.device)
        self._run_start(gate)
        if replan is not None:
            state, iters = self._run_replanned(program, replan, state, sync,
                                               gate)
        else:
            frontier = (None if program.fixed_iters is not None
                        else torch.ones_like(state, dtype=torch.bool))
            state, _, iters = self._loop(program, state, frontier,
                                         self._limit(program), sync, gate)
        self._run_end(iters, sync, gate)
        return self._to_host(self._unpermute(state)), iters

    # -- mid-run replanning --------------------------------------------------

    def _resolve_replan_policy(self, policy) -> ReplanPolicy:
        """Validate a replan request at run entry, not supersteps later when
        the trigger first fires: the target must name a known policy, and a
        grid target must keep the chare count."""
        if isinstance(policy, str):
            policy = ReplanPolicy(partitioner=policy)
        part_mod.get_partitioner(policy.partitioner)
        shape = part_mod.grid_shape(policy.partitioner)
        if shape is not None and shape[0] * shape[1] != self._C:
            raise ValueError(
                f"replan target {policy.partitioner!r} needs "
                f"{shape[0] * shape[1]} chares, engine has {self._C}")
        return policy

    def _should_replan(self, policy, frontier) -> bool:
        """The segment boundary's trigger; the skew mode reads the frontier
        (collapsed over query columns on a plane) back to the host."""
        if policy.mode == "always":
            return True
        f = frontier.any(dim=-1) if frontier.dim() == 3 else frontier
        stats = part_mod.partition_stats(self.pg, frontier=f.cpu().numpy())
        return stats["frontier_edge_imbalance"] > policy.threshold

    def _replan_to(self, policy):
        """The new partition a triggered boundary switches to, or None for
        a no-op switch (the same placement)."""
        new_plan = part_mod.make_plan(self.pg.graph, self._C,
                                      policy.partitioner)
        if new_plan.same_as(self.pg.plan):
            return None
        return self.pg.repartition(policy.partitioner, plan=new_plan)

    def _move_state(self, init_state, state, frontier, new_pg):
        """Carry state across a replan: plan B's ``g2l`` on top of plan A's
        ``l2g`` (``PartitionPlan.padded_map_from``) moves the live slots in
        one on-device ``index_copy``; padding takes the program's init fill
        (``init_state``, built for the new partition), so min-monoid
        programs stay bit-exact, and new padding enters quiesced.  A
        trailing batch axis rides along.

        1-D <-> 2-D switches compose the same algebra on the ROW plans
        (``row_plan_of``): a grid's state is its row plan replicated per
        column, so the move reads the old column-0 replica, scatters through
        the composed row relabel and replicates into the new shape (for
        1-D <-> 1-D the replica count is 1 on both sides).
        """
        move = part_mod.row_plan_of(new_pg.plan).padded_map_from(
            part_mod.row_plan_of(self.pg.plan))
        live = move >= 0
        src = torch.from_numpy(np.nonzero(live)[0]).to(self.device)
        tgt = torch.from_numpy(move[live]).to(self.device)
        old_cols = self.pg.grid_shape[1] if self.pg.is_grid else 1
        new_cols = new_pg.grid_shape[1] if new_pg.is_grid else 1
        old_rows = self.pg.num_chunks // old_cols
        new_rows = new_pg.num_chunks // new_cols
        k_old, k_new = self.pg.chunk_size, new_pg.chunk_size

        def rows_of(a, n_rows, n_cols, k):
            """Column-0 replica of a [P, K, ...] plane, flat in row space."""
            tail = tuple(a.shape[2:])
            a = a.reshape((n_rows, n_cols, k) + tail)[:, 0]
            return a.reshape((n_rows * k,) + tail)

        def replicate(a):
            """Row-space plane -> the new partition's replicated [P, K, ...]."""
            tail = tuple(a.shape[1:])
            a = a.reshape((new_rows, 1, k_new) + tail).expand(
                (new_rows, new_cols, k_new) + tail)
            return a.reshape((new_pg.num_chunks, k_new) + tail)

        new_state = _relabel_gather(
            rows_of(init_state, new_rows, new_cols, k_new),
            rows_of(state, old_rows, old_cols, k_old), src, tgt)
        f_rows = rows_of(frontier, old_rows, old_cols, k_old)
        new_f = _relabel_gather(
            f_rows.new_zeros((new_rows * k_new,) + tuple(f_rows.shape[1:])),
            f_rows, src, tgt)
        return replicate(new_state), replicate(new_f)

    def _run_replanned(self, program, policy, state, sync, gate):
        """The segmented superstep loop of ``run``: segments of
        ``policy.every`` supersteps (each draining its in-flight partial
        under overlap), a trigger at each boundary, and on a switch the
        repartition, the state move and the rebind.  -> (state on the final
        placement, supersteps)."""
        policy = self._resolve_replan_policy(policy)
        fixed = program.fixed_iters is not None
        limit = self._limit(program)
        frontier = torch.ones_like(state, dtype=torch.bool)
        done = replans = 0
        while done < limit:
            state, frontier, it = self._loop(
                program, state, frontier, min(policy.every, limit - done),
                sync, gate, drain=True)
            done += it
            if not fixed and not bool(frontier.any()):
                break  # quiesced: the last superstep changed nothing
            if done >= limit or replans >= policy.max_replans:
                continue
            if not self._should_replan(policy, frontier):
                continue
            new_pg = self._replan_to(policy)
            if new_pg is None:
                continue  # no-op switch: keep the resident layout
            init = torch.from_numpy(program.init(new_pg)).to(self.device)
            state, frontier = self._move_state(init, state, frontier, new_pg)
            self._rebind(new_pg)
            replans += 1
        return state, done

    # -- streamed execution (residency='stream') -----------------------------

    def _stream_prep(self, program, state, frontier, aux):
        """The superstep's values to push: ``update``, frontier-masked for
        convergence programs (quiesced vertices send the identity)."""
        vals = program.update(state, aux)
        if program.fixed_iters is not None:
            return vals
        sent = torch.full((), program.combiner.identity, dtype=vals.dtype,
                          device=self.device)
        return torch.where(frontier, vals, sent)

    def _stream_sweep(self, pf, program, sched, active, vals, partial, gate):
        """Walk one superstep's fetch schedule through the prefetcher,
        folding each window into the running partial
        (``grid2d_phase1_window`` with the window's own band table; under
        the gate the window's row mask keeps the unfetched rectangles at
        their partial)."""
        if len(sched):
            pf.submit(int(sched[0]), active[:, sched[0]])
            for i, k in enumerate(sched):
                if i + 1 < len(sched):
                    nxt = int(sched[i + 1])
                    pf.submit(nxt, active[:, nxt])
                wd, slot = pf.take()
                arrs = dict(wd, gr_band=self._win_bands[int(k)])
                partial = strat.grid2d_phase1_window(
                    vals, arrs, partial, program.combiner, self._C, self._K,
                    segment_fn=self.segment_fn,
                    edge_value=program.edge_value, push_fn=self.push_fn,
                    edge_semiring=program.edge_semiring,
                    grid_meta=self._grid_meta,
                    row_active=wd["row_active"] if gate else None)
                pf.folded(slot)
        return partial

    def _stream_summary(self, delta):
        """What the host loop steers by, in ONE small device->host copy:
        the convergence flags (``[1]``, or per query ``[B]``) and the
        frontier collapsed to BLOCK_V source blocks (``[C, nsb(, B)]``
        bool), which the host gate intersects with each window's band
        source blocks."""
        nsb = self._gate_nsb
        tail = tuple(delta.shape[2:])
        width = nsb * blocks.BLOCK_V
        f = delta
        if width != self._K:
            f = torch.cat([f, f.new_zeros((self._C, width - self._K) + tail)],
                          1)
        fb = f.reshape((self._C, nsb, blocks.BLOCK_V) + tail).any(dim=2)
        changed = (delta.reshape((-1,) + tail).any(dim=0) if tail
                   else delta.any()).reshape(-1)
        host = self._to_host(torch.cat([changed.to(torch.int32),
                                        fb.reshape(-1).to(torch.int32)]))
        nq = changed.numel()
        return host[:nq] != 0, host[nq:].reshape(fb.shape) != 0

    def _stream_record(self, pf, it, slots_total, slots_skipped, gate,
                       **extra):
        """Publish one streamed run's prefetcher accounting into
        ``dispatch['stream']`` (the reference's fields, and the copies' own
        device time and bytes on the card) and its window-slot counts as
        the gate record."""
        overlap = (1.0 - pf.stall_s / pf.copy_s) if pf.copy_s > 0 else 1.0
        self.dispatch["stream"].update({
            "supersteps": it,
            "fetches": pf.fetches,
            "fetched_bytes": pf.bytes_read,
            "copy_s": pf.copy_s,
            "stall_s": pf.stall_s,
            "overlap_efficiency": max(0.0, min(1.0, overlap)),
            "edge_bandwidth_bytes_per_s":
                pf.bytes_read / pf.copy_s if pf.copy_s > 0 else 0.0,
            "fetch_slots": slots_total,
            "fetch_skipped": slots_skipped,
            "fetch_skip_fraction":
                slots_skipped / slots_total if slots_total else 0.0,
            "pipelined": bool(pf.pipelined),
            "h2d_s": pf.h2d_s,
            "h2d_bytes": pf.h2d_bytes,
            **extra,
        })
        # window-granular slot accounting doubles as the gate record
        self._gate_slots, self._gate_skipped = slots_total, slots_skipped
        self._run_end(it, "barrier", gate)

    def _stream_schedule(self, gate_masks, fb_host):
        """-> (the [C, nw] active slots, the windows to fetch in order, the
        skipped slot count)."""
        nw = self._source.num_windows
        if gate_masks is None:
            active = np.ones((self._C, nw), dtype=bool)
        else:
            active = self._source.active_windows(gate_masks, fb_host)
        sched = np.flatnonzero(active.any(axis=0))
        return active, sched, self._C * nw - int(active.sum())

    def _run_streamed(self, program, gate):
        """``run`` out of core: the streamed loop from the program's initial
        state; -> (state in original vertex order, supersteps)."""
        state = torch.from_numpy(program.init(self.pg)).to(self.device)
        state, it, _ = self._stream_loop(program, state, self.aux, gate)
        return self._to_host(self._unpermute(state)), it

    def _run_streamed_batch(self, program, state, qp, gate):
        """``run_batch`` out of core: the streamed loop over a ``[C, K, B]``
        query plane; -> (state, q_it [B] int64)."""
        aux = {k: v[..., None] for k, v in self.aux.items()}
        if qp is not None:
            aux["qplane"] = qp
        state, _, q_it = self._stream_loop(program, state, aux, gate)
        return state, torch.from_numpy(q_it)

    def _stream_loop(self, program, state, aux, gate):
        """The out-of-core superstep loop: per superstep, walk the edge
        windows through the double-buffered prefetcher, folding each into
        the running phase-1 partial, then phase 2 and the apply.  The host
        loop keeps the resident loops' semantics -- the all-ones initial
        frontier, frontier masking, and on a ``[C, K, B]`` plane per-query
        convergence (``q_it[b]`` counts the supersteps entered while column
        b was still changing; the loop runs while any column is) -- so min
        programs are bit-exact against ``residency='resident'`` with equal
        superstep counts.  One fetched window serves every column of its
        fold, so a plane's edge bytes per query fall B-fold.

        Under the gate a (rectangle, window) slot whose band source blocks
        miss the live frontier -- on a plane, of every live column (the
        union gate) -- is never READ, and a window with no active rectangle
        drops out of the fetch schedule.  -> (state, supersteps, q_it [B]
        int64 numpy, ``[1]`` for a single state)."""
        cfg = self.stream or StreamConfig()
        _, cols, kc = self._grid_meta
        nsb = self._gate_nsb
        tail = tuple(state.shape[2:])  # the plane's trailing [B]
        frontier = torch.ones_like(state, dtype=torch.bool)
        fixed = program.fixed_iters is not None
        limit = self._limit(program)
        gate_masks = self._source.gate_masks(nsb) if gate else None
        fb_host = np.ones((self._C, nsb) + tail, dtype=bool)
        live = np.ones(tail[0] if tail else 1, dtype=bool)
        q_it = np.zeros(live.shape, dtype=np.int64)
        self._run_start(False)
        pf = _StreamPrefetcher(self._source, self.device, cfg.prefetch)
        it = 0
        slots_total = slots_skipped = 0
        try:
            while live.any() and it < limit:
                vals = self._stream_prep(program, state, frontier, aux)
                pf.mark()
                # quiesced columns are all-zero in fb_host already; the mask
                # keeps the union over LIVE columns explicit
                active, sched, skipped = self._stream_schedule(
                    gate_masks, fb_host & live if tail else fb_host)
                slots_total += active.size
                slots_skipped += skipped
                partial = torch.full((self._C, cols * kc) + tail,
                                     program.combiner.identity,
                                     dtype=vals.dtype, device=self.device)
                partial = self._stream_sweep(pf, program, sched, active,
                                             vals, partial, gate)
                new = program.apply(state, self._combine(partial, program),
                                    aux)
                pf.mark()
                q_it += live
                it += 1
                if not fixed:
                    frontier = new != state
                    live, fb_host = self._stream_summary(frontier)
                state = new
        finally:
            pf.close()
        extra = {}
        if tail:
            extra = {"batch": tail[0],
                     "fetched_bytes_per_query": pf.bytes_read / tail[0]}
        self._stream_record(pf, it, slots_total, slots_skipped, gate,
                            **extra)
        return state, it, q_it

    # -- batched multi-query execution (DESIGN.md section 11) ----------------

    @staticmethod
    def _bucket(n: int) -> int:
        """B-bucket: round the query count up to the next power of two, the
        plane widths steady-state traffic runs at."""
        return 1 << max(n - 1, 0).bit_length()

    def run_batch(self, program, sources=None, batch=None, replan=None,
                  sync="barrier", gate=None, residency=None, **params
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Run B queries of one program in a single batched sweep.

        ``sources`` is a sequence of queries -- each an original vertex id
        or an iterable of ids (a seed set); defaults to the program's own
        ``sources`` (betweenness pivots).  ``batch`` fixes the plane width B
        (>= the query count); by default the count is rounded up to the
        next power of two (``_bucket``).  Padding columns re-run query 0 and
        are dropped on the way out.  The reference also keys its compile
        cache by the bucket (``_batch_key``); the port compiles nothing per
        program, so it has no such cache.  ``replan``, ``sync`` and
        ``gate`` work as in ``run``: the replan trigger sees the frontier
        collapsed over queries, and under overlap each query stays live
        until two quiet applies of its column in a row.  On a streamed
        engine the plane runs the window schedule: each window's upload is
        folded into all B columns, so the edge bytes fetched per query fall
        B-fold (``dispatch['stream']['fetched_bytes_per_query']``), with
        per-query convergence on the host.

        Returns ``(plane, iters)``: ``plane[i]`` is query i's converged
        per-vertex state in original vertex order ([n, V], after the
        program's ``finalize_batch``), ``iters[i]`` the supersteps query i
        needed -- identical to its own ``run`` under ``sync='barrier'``;
        the query's own double-check count under ``sync='overlap'``.
        """
        from repro_torch.core import programs as prog_mod

        program = self._program(program, params)
        self._check_residency(residency, replan, sync)
        if program.init_batch is None:
            raise ValueError(
                f"program {program.name!r} has no batched init "
                f"(VertexProgram.init_batch); run it with Engine.run")
        sync, gate = self._validate_async(program, sync, gate)
        if sources is None:
            sources = program.sources
        if sources is not None and not isinstance(sources, (int, np.integer)):
            sources = tuple(sources)
            if not sources:
                raise ValueError("run_batch needs at least one query "
                                 "(sources is empty)")
        sets = prog_mod.seed_sets(sources)
        plane, q_it = self._batch(program, sets, batch, replan, sync, gate)
        return self._to_host(plane), q_it

    def _batch(self, program, sets, batch=None, replan=None, sync="barrier",
               gate=False):
        """The batched run on the device: (plane [n, V] in original vertex
        order after ``finalize_batch``, per-query supersteps as int64
        numpy)."""
        n = len(sets)
        B = self._bucket(n) if batch is None else int(batch)
        if B < n:
            raise ValueError(f"batch={B} is smaller than {n} queries")
        padded = sets + (sets[0],) * (B - n)
        state, qp = self._batch_init(program, padded)
        if self.residency == "stream":
            state, q_it = self._run_streamed_batch(program, state, qp, gate)
        elif replan is None:
            state, q_it = self._batch_loop(program, state, qp, sync, gate)
        else:
            state, q_it = self._run_batch_replanned(program, padded, state,
                                                    qp, replan, sync, gate)
        plane = self._unpermute(state)[:n]
        if program.finalize_batch is not None:
            plane = program.finalize_batch(self.pg.graph, sets, plane)
        return plane, q_it[:n].cpu().numpy().astype(np.int64)

    def _batch_init(self, program, sets):
        """The seed plane ``[C, K, B]`` and, for programs with one, the
        read-only query plane, both built on the engine's device."""
        state = program.init_batch(self.pg, sets, self.device)
        qp = (None if program.query_plane is None
              else program.query_plane(self.pg, sets, self.device))
        return state, qp

    def _batch_loop(self, program, state, qp=None, sync="barrier",
                    gate=False):
        """One whole batched run without replanning: ``_batch_segment`` from
        an all-ones frontier up to the program's limit, with the run's
        accounting.  Returns the final plane and ``q_it`` ``[B]``."""
        self._run_start(gate)
        state, _, q_it, iters = self._batch_segment(
            program, state, torch.ones_like(state, dtype=torch.bool), qp,
            self._limit(program), sync, gate)
        self._run_end(iters, sync, gate)
        return state, q_it

    def _batch_segment(self, program, state, frontier, qp, limit,
                       sync="barrier", gate=False):
        """Up to ``limit`` supersteps over a ``[C, K, B]`` query plane, with
        PER-QUERY convergence masking and iteration counting; -> ``(state,
        frontier, q_it [B] int64, supersteps)``.

        One push per superstep serves all B columns.  Under the barrier a
        query whose column stopped changing sends the combiner identity from
        then on, and ``q_it`` counts -- per query -- exactly the supersteps
        a sequential run of it would have executed: ``active[b]`` never
        turns back on, and the loop runs while any query is active.  Under
        ``sync='overlap'`` a query stays live until two consecutive applies
        leave its column unchanged, ``q_it`` counts its own supersteps, and
        the in-flight partial is drained at the end.  One host sync per
        superstep.  Fixed-iteration programs run the plain counted loop:
        every column takes exactly ``limit`` supersteps, and the frontier
        comes back as it went in.
        """
        # per-vertex aux as [C, K, 1], so update/apply broadcast over B;
        # the query plane is already [C, K, B]
        aux = {k: v[..., None] for k, v in self.aux.items()}
        if qp is not None:
            aux["qplane"] = qp
        B = state.shape[-1]
        if program.fixed_iters is not None:
            for _ in range(limit):
                incoming = self._propagate(program.update(state, aux),
                                           program)
                state = program.apply(state, incoming, aux)
            return (state, frontier,
                    torch.full((B,), limit, dtype=torch.int64), limit)
        sent = torch.full((), program.combiner.identity, dtype=state.dtype,
                          device=self.device)

        def masked(state, frontier):
            return torch.where(frontier, program.update(state, aux), sent)

        def per_query(delta):
            return delta.reshape(-1, B).any(dim=0)

        q_it = torch.zeros(B, dtype=torch.int64, device=self.device)
        it = 0
        if sync == "overlap":
            pending = self._push(program, masked(state, frontier), frontier,
                                 gate)
            frontier = torch.zeros_like(frontier)
            q_quiet = torch.zeros(B, dtype=torch.int64, device=self.device)
            while it < limit and bool((q_quiet < 2).any()):
                live = q_quiet < 2
                incoming = self._combine(pending, program)
                pending = self._push(program, masked(state, frontier),
                                     frontier, gate)
                new = program.apply(state, incoming, aux)
                frontier = new != state
                q_quiet = torch.where(per_query(frontier), 0, q_quiet + 1)
                q_it += live
                state = new
                it += 1
            drained = program.apply(state, self._combine(pending, program),
                                    aux)
            return drained, frontier | (drained != state), q_it, it
        active = per_query(frontier)
        while it < limit and bool(active.any()):
            new = program.apply(
                state, self._propagate(masked(state, frontier), program,
                                       frontier, gate), aux)
            frontier = new != state
            q_it += active
            active = per_query(frontier)
            state = new
            it += 1
        return state, frontier, q_it, it

    def _run_batch_replanned(self, program, padded_sets, state, qp, policy,
                             sync, gate):
        """Batched twin of ``_run_replanned``: the trigger sees the frontier
        collapsed over queries (a vertex is live if any query still touches
        it), the state move carries the whole ``[C, K, B]`` plane, the
        global superstep count grows by the longest query's count of each
        segment, and the read-only query plane is rebuilt for the new
        placement.  -> (plane on the final placement, q_it [B])."""
        policy = self._resolve_replan_policy(policy)
        fixed = program.fixed_iters is not None
        limit = self._limit(program)
        self._run_start(gate)
        frontier = torch.ones_like(state, dtype=torch.bool)
        q_iters = torch.zeros(state.shape[-1], dtype=torch.int64)
        done = replans = 0
        while done < limit:
            state, frontier, q_it, _ = self._batch_segment(
                program, state, frontier, qp,
                min(policy.every, limit - done), sync, gate)
            q_it = q_it.cpu()
            q_iters += q_it
            # the longest-still-active query is active for every executed
            # superstep, so its count is the segment's global step count
            done += int(q_it.max())
            if not fixed and not bool(frontier.any()):
                break  # all queries quiesced
            if done >= limit or replans >= policy.max_replans:
                continue
            if not self._should_replan(policy, frontier):
                continue
            new_pg = self._replan_to(policy)
            if new_pg is None:
                continue
            init = program.init_batch(new_pg, padded_sets, self.device)
            state, frontier = self._move_state(init, state, frontier, new_pg)
            self._rebind(new_pg)
            if program.query_plane is not None:
                # a pure function of the placement: rebuilt, not relabeled
                qp = program.query_plane(new_pg, padded_sets, self.device)
            replans += 1
        self._run_end(done, sync, gate)
        return state, q_iters

    def _unpermute(self, state):
        """Padded-id state -> original vertex order, on the device (callers
        always see original ids): ``[C, K]`` -> ``[V]``, ``[C, K, B]`` ->
        ``[B, V]`` (a transposed view).  On a grid ``global_to_local``
        names each vertex's column-0 replica."""
        g2l = self.pg.device_relabel(self.device)["global_to_local"]
        if state.dim() == 2:
            return state.reshape(-1).index_select(0, g2l)
        flat = state.reshape(self._C * self._K, state.shape[-1])
        return flat.index_select(0, g2l).t()

    @staticmethod
    def _to_host(t) -> np.ndarray:
        """A device result as numpy: one copy into pinned host memory on
        CUDA (the copy runs at the link's rate and the block returns to
        torch's pinned cache when the array dies), a contiguous view on
        the CPU."""
        if t.device.type == "cpu":
            return t.contiguous().numpy()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t)
        return out.numpy()

    # -- thin per-algorithm wrappers ----------------------------------------

    def pagerank(self, alpha: float = 0.85, iters: int = 20):
        """Push PageRank: a <- (1-alpha) + sum_in alpha * a_prev / d."""
        return self.run("pagerank", alpha=alpha, iters=iters)[0]

    def labelprop(self, max_iters: int = 10_000):
        """Min-label propagation to convergence. Returns (labels, iterations)."""
        return self.run("labelprop", max_iters=max_iters)

    def sssp(self, source: int = 0, max_iters: int = 10_000):
        """Single-source shortest paths (min-plus over edge weights)."""
        return self.run("sssp", source=source, max_iters=max_iters)

    def bfs(self, source: int = 0, max_iters: int = 10_000):
        """BFS reachability depth (min over hop counts)."""
        return self.run("bfs", source=source, max_iters=max_iters)

    def pagerank_weighted(self, alpha: float = 0.85, iters: int = 20):
        """Weight-normalized push PageRank."""
        return self.run("pagerank_weighted", alpha=alpha, iters=iters)[0]

    def betweenness(self, pivots=(0, 1, 2, 3), max_iters: int = 10_000):
        """Approximate betweenness: batched multi-pivot BFS + Brandes."""
        return self.run("betweenness", pivots=tuple(pivots),
                        max_iters=max_iters)
