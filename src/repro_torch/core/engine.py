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
"""

from __future__ import annotations

import dataclasses

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
    "batch": "the batched query plane (run_batch, personalized PageRank, "
             "betweenness) is not ported yet (ROADMAP queue 1, item 7)",
    "grid2d": "grid(R,C) partitions and the grid2d strategy are not ported "
              "yet (ROADMAP queue 1, item 6)",
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
    """

    pg: PartitionedGraph
    strategy: str = "sortdest"
    device: object = None
    push_fn: object = "auto"
    segment_fn: object = None
    residency: str = "resident"

    def __post_init__(self):
        if self.residency == "stream":
            raise NotImplementedError(_LATER["stream"])
        if self.residency != "resident":
            raise ValueError(f"unknown residency {self.residency!r}")
        if self.strategy == "grid2d":
            raise NotImplementedError(_LATER["grid2d"])
        if self.strategy not in strat.PHASES:
            raise ValueError(f"unknown strategy {self.strategy!r}; "
                             f"choose from {sorted(strat.PHASES)}")
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
        """Point the engine at a partition: alias its device-upload cache and
        resolve the adaptive dispatch."""
        self.pg = pg
        # layouts are uploaded once per (partition, device) and shared:
        # engines of a strategy sweep alias the same tensors
        layout = strat.STRATEGY_LAYOUT[self.strategy]
        self.arrays = (pg.device_pairwise(self.device) if layout == "pairwise"
                       else pg.device_arrays(layout, self.device))
        self.aux = pg.device_aux(self.device)
        self._C, self._K = pg.num_chunks, pg.chunk_size
        self.dispatch = self._resolve_dispatch()

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
        band = self.pg.sd_band if layout == "sd" else self.pg.band
        emax = self.pg.edge_valid.shape[1]
        choice, occ = blocks.choose_push(band, emax, self._K,
                                         self._C * self._K)
        from repro_torch.kernels import ops

        self.push_fn = ops.make_push_fn(fused=choice == "fused")
        return {"choice": choice, "mode": "auto", "layout": layout,
                "threshold": blocks.BAND_OCC_FUSED_MAX, "kernel": kernel,
                **occ}

    def _propagate(self, vals, program):
        """One superstep's message exchange: phase 1 (every chare's local
        push) then phase 2 (the combine across the chare axis)."""
        p1, p2 = strat.PHASES[self.strategy]
        comb = program.combiner
        partial = p1(vals, self.arrays, comb, self._C, self._K,
                     segment_fn=self.segment_fn,
                     edge_value=program.edge_value, push_fn=self.push_fn,
                     edge_semiring=program.edge_semiring)
        return p2(partial, self.arrays, comb, self._C, self._K,
                  segment_fn=self.segment_fn)

    def run(self, program, replan=None, sync="barrier", gate=None,
            residency=None, **params) -> tuple:
        """Run a vertex program to completion; returns (state, iterations).

        ``program`` is a registered name (params forwarded to its factory)
        or a ``VertexProgram`` instance.  The state comes back as a numpy
        array in original vertex order.  ``replan``, ``sync='overlap'``,
        ``gate`` and ``residency='stream'`` are not ported yet and raise
        ``NotImplementedError``.
        """
        from repro_torch.core import programs as prog_mod

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
        if isinstance(program, str):
            if program in ("personalized_pagerank", "betweenness"):
                raise NotImplementedError(_LATER["batch"])
            program = prog_mod.make_program(program, **params)
        elif params:
            raise TypeError("params only apply to registered program names")

        aux = self.aux
        state = torch.from_numpy(program.init(self.pg)).to(self.device)
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
        # un-permute: padded-id state -> original vertex order (callers
        # always see original ids)
        state = state.reshape(-1).cpu().numpy()[self.pg.global_to_local]
        return state, iters

    def run_batch(self, program, sources=None, **kwargs):
        raise NotImplementedError(_LATER["batch"])

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
