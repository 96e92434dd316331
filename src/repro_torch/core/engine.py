"""Actor-superstep engine: every chare of a partition on one device.

The twin of the resident, barrier-synchronized ``Engine.run`` of
``repro/core/engine.py``.  Per superstep each chare (i) scans its local
edges and aggregates outgoing data (phase 1: one push -- a fused launch or
a gather and a scatter launch -- over every chare's ``[Emax]`` row at
once), (ii) exchanges messages (phase 2: a reduction over the chare axis,
or for ``basic`` a swap of the chare axes and one scatter launch), (iii)
applies the received payloads to its
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
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import strategies as strat
from repro_torch.core.graph import PartitionedGraph
from repro_torch.kernels import blocks

_LATER = {
    "replan": "mid-run replanning is not ported yet (ROADMAP queue 1, "
              "item 5)",
    "overlap": "sync='overlap' is not ported yet (ROADMAP queue 1, item 8)",
    "gate": "frontier gating is not ported yet (ROADMAP queue 1, item 8)",
    "stream": "residency='stream' is not ported yet (ROADMAP queue 1, "
              "item 9)",
}


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another; asking for
    CUDA where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine runs on CUDA by default and no CUDA device "
                           "is available; pass device='cpu' to run on the "
                           "CPU")
    return device


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
    partition always runs ``grid2d`` (the 1-D layouts do not exist on it);
    asking for ``grid2d`` on a 1-D partition is an error.  ``collectives``
    picks grid2d's phase-2 lowering: ``"auto"`` (``"grouped"``),
    ``"grouped"`` or ``"full"``.
    """

    pg: PartitionedGraph
    strategy: str = "sortdest"
    device: object = None
    push_fn: object = "auto"
    segment_fn: object = None
    residency: str = "resident"
    collectives: str = "auto"

    def __post_init__(self):
        if self.residency == "stream":
            raise NotImplementedError(_LATER["stream"])
        if self.residency != "resident":
            raise ValueError(f"unknown residency {self.residency!r}")
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
        self._push_request = self.push_fn
        self._bind(self.pg)

    def _bind(self, pg: PartitionedGraph):
        """Point the engine at a partition: alias its device-upload cache,
        resolve the strategy and the adaptive dispatch."""
        self.pg = pg
        if pg.is_grid:
            self.strategy = "grid2d"
        # layouts are uploaded once per (partition, device) and shared:
        # engines of a strategy sweep alias the same tensors
        layout = strat.STRATEGY_LAYOUT[self.strategy]
        self.arrays = (pg.device_pairwise(self.device) if layout == "pairwise"
                       else pg.device_arrays(layout, self.device))
        self.aux = pg.device_aux(self.device)
        self._C, self._K = pg.num_chunks, pg.chunk_size
        p1, p2 = strat.PHASES[self.strategy]
        self._wire = None
        if pg.is_grid:
            rows, cols = pg.grid_shape
            meta = (rows, cols, pg.col_chunk_size)
            self._collectives = ("grouped" if self.collectives == "auto"
                                 else self.collectives)
            self._wire = {"bytes": 0.0}
            p1 = functools.partial(p1, grid_meta=meta)
            p2 = functools.partial(p2, grid_meta=meta,
                                   collectives=self._collectives,
                                   wire=self._wire)
        self._phases = (p1, p2)
        self.dispatch = self._resolve_dispatch()
        if pg.is_grid:
            self._record_wire(0)

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

    def _propagate(self, vals, program):
        """One superstep's message exchange: phase 1 (every chare's local
        push) then phase 2 (the combine across the chare axis)."""
        p1, p2 = self._phases
        comb = program.combiner
        partial = p1(vals, self.arrays, comb, self._C, self._K,
                     segment_fn=self.segment_fn,
                     edge_value=program.edge_value, push_fn=self.push_fn,
                     edge_semiring=program.edge_semiring)
        return p2(partial, self.arrays, comb, self._C, self._K,
                  segment_fn=self.segment_fn)

    @staticmethod
    def _check_modes(replan, sync, gate, residency):
        """Refuse the engine modes this port does not have yet."""
        if replan is not None:
            raise NotImplementedError(_LATER["replan"])
        if sync == "overlap":
            raise NotImplementedError(_LATER["overlap"])
        if sync != "barrier":
            raise ValueError(f"unknown sync mode {sync!r}")
        if gate not in (None, False, 0):
            raise NotImplementedError(_LATER["gate"])
        if residency == "stream":
            raise NotImplementedError(_LATER["stream"])
        if residency not in (None, "resident"):
            raise ValueError(f"unknown residency {residency!r}")

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

    def run(self, program, replan=None, sync="barrier", gate=None,
            residency=None, **params) -> tuple:
        """Run a vertex program to completion; returns (state, iterations).

        ``program`` is a registered name (params forwarded to its factory)
        or a ``VertexProgram`` instance.  The state comes back as a numpy
        array in original vertex order.  Programs with their own
        ``sources``, ``init_batch`` and ``finalize`` (personalized PageRank,
        betweenness) run on the batched plane and return their finalized
        result with the global superstep count.  ``replan``,
        ``sync='overlap'``, ``gate`` and ``residency='stream'`` are not
        ported yet and raise ``NotImplementedError``.
        """
        from repro_torch.core import programs as prog_mod

        self._check_modes(replan, sync, gate, residency)
        program = self._program(program, params)
        if (program.sources is not None and program.init_batch is not None
                and program.finalize is not None):
            # inherently multi-source programs (betweenness pivots) run on
            # the batched plane and post-process the per-query rows on the
            # device; the iteration count is the global superstep count
            sets = prog_mod.seed_sets(program.sources)
            plane, q_it = self._batch(program, sets)
            out = program.finalize(self.pg.graph, sets, plane)
            return self._to_host(out), int(q_it.max())

        aux = self.aux
        state = torch.from_numpy(program.init(self.pg)).to(self.device)
        if self._wire is not None:
            self._wire["bytes"] = 0.0
        if program.fixed_iters is not None:
            for _ in range(program.fixed_iters):
                incoming = self._propagate(program.update(state, aux),
                                           program)
                state = program.apply(state, incoming, aux)
            iters = program.fixed_iters
        else:
            sent = torch.full((), program.combiner.identity,
                              dtype=state.dtype, device=self.device)
            frontier = torch.ones_like(state, dtype=torch.bool)
            changed, iters = True, 0
            while changed and iters < program.max_iters:
                # frontier masking: quiesced vertices send the identity
                vals = torch.where(frontier, program.update(state, aux), sent)
                new = program.apply(state, self._propagate(vals, program),
                                    aux)
                frontier = new != state
                changed = bool(frontier.any())
                state = new
                iters += 1
        self.dispatch["supersteps"] = iters
        if self._wire is not None:
            self._record_wire(iters)
        return self._to_host(self._unpermute(state)), iters

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
        program, so it has no such cache.  ``replan``,
        ``sync='overlap'``, ``gate`` and ``residency='stream'`` are not
        ported yet and raise ``NotImplementedError``.

        Returns ``(plane, iters)``: ``plane[i]`` is query i's converged
        per-vertex state in original vertex order ([n, V], after the
        program's ``finalize_batch``), ``iters[i]`` the supersteps query i
        needed -- identical to its own ``run``.
        """
        from repro_torch.core import programs as prog_mod

        self._check_modes(replan, sync, gate, residency)
        program = self._program(program, params)
        if program.init_batch is None:
            raise ValueError(
                f"program {program.name!r} has no batched init "
                f"(VertexProgram.init_batch); run it with Engine.run")
        if sources is None:
            sources = program.sources
        if sources is not None and not isinstance(sources, (int, np.integer)):
            sources = tuple(sources)
            if not sources:
                raise ValueError("run_batch needs at least one query "
                                 "(sources is empty)")
        sets = prog_mod.seed_sets(sources)
        plane, q_it = self._batch(program, sets, batch)
        return self._to_host(plane), q_it

    def _batch(self, program, sets, batch=None):
        """The batched run on the device: (plane [n, V] in original vertex
        order after ``finalize_batch``, per-query supersteps as int64
        numpy)."""
        n = len(sets)
        B = self._bucket(n) if batch is None else int(batch)
        if B < n:
            raise ValueError(f"batch={B} is smaller than {n} queries")
        padded = sets + (sets[0],) * (B - n)
        state, qp = self._batch_init(program, padded)
        state, q_it = self._batch_loop(program, state, qp)
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

    def _batch_loop(self, program, state, qp=None):
        """The superstep loop over a ``[C, K, B]`` query plane, with
        PER-QUERY convergence masking and iteration counting.

        One push per superstep serves all B columns.  A query whose column
        stopped changing sends the combiner identity from then on (its
        frontier column is all-false), and ``q_it`` counts -- per query --
        exactly the supersteps a sequential run of that query would have
        executed: ``active[b]`` never turns back on, and the loop runs while
        any query is active, so supersteps past a query's own convergence
        are no-ops for it.  One host sync per superstep, as in ``run``.
        Fixed-iteration programs run the plain counted loop: every column
        takes exactly ``fixed_iters`` supersteps.  Returns the final plane
        and ``q_it`` ``[B]``.
        """
        # per-vertex aux as [C, K, 1], so update/apply broadcast over B;
        # the query plane is already [C, K, B]
        aux = {k: v[..., None] for k, v in self.aux.items()}
        if qp is not None:
            aux["qplane"] = qp
        B = state.shape[-1]
        if self._wire is not None:
            self._wire["bytes"] = 0.0
        if program.fixed_iters is not None:
            for _ in range(program.fixed_iters):
                incoming = self._propagate(program.update(state, aux),
                                           program)
                state = program.apply(state, incoming, aux)
            iters = program.fixed_iters
            q_it = torch.full((B,), iters, dtype=torch.int64)
        else:
            sent = torch.full((), program.combiner.identity,
                              dtype=state.dtype, device=self.device)
            frontier = torch.ones_like(state, dtype=torch.bool)
            active = torch.ones(B, dtype=torch.bool, device=self.device)
            q_it = torch.zeros(B, dtype=torch.int64, device=self.device)
            iters = 0
            while iters < program.max_iters and bool(active.any()):
                vals = torch.where(frontier, program.update(state, aux), sent)
                new = program.apply(state, self._propagate(vals, program),
                                    aux)
                frontier = new != state
                q_it += active
                active = frontier.reshape(-1, B).any(dim=0)
                state = new
                iters += 1
        self.dispatch["supersteps"] = iters
        if self._wire is not None:
            self._record_wire(iters)
        return state, q_it

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
