"""COST harness -- Configuration that Outperforms a Single Thread.

The twin of ``repro/core/cost.py``: time the serial baseline, time every
parallel variant at each chare count, report per-cell runtimes and the COST
(smallest chare count at which a variant matches the serial baseline; inf if
never).  Timings exclude graph ingestion/partitioning, as in the paper, and
wait for the device (``torch.cuda.synchronize``) before reading the clock.

``wire_model`` is the reference's analytic per-superstep wire-byte model,
its ``grid2d`` entry included, and ``grid_collective_bytes`` prices the two
lowerings of grid2d's phase 2 as the reference does (pure arithmetic, the
same numbers); the engine counts the same bytes as its reduces run
(``Engine.dispatch["collectives"]``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core import programs as prog_mod
from repro_torch.core.engine import Engine, resolve_device
from repro_torch.core.graph import Graph, partition


def _time(fn: Callable, device: torch.device, repeats: int = 3) -> float:
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class CostReport:
    algorithm: str
    serial_s: float
    # {(partitioner, strategy, pes): seconds}
    parallel_s: dict
    cost: dict  # {(partitioner, strategy): int | inf}
    # {(partitioner, strategy, pes): Engine.dispatch}
    dispatch: dict = dataclasses.field(default_factory=dict)

    def rows(self):
        """-> (strategy, partitioner, pes, seconds) rows, serial first."""
        yield ("serial", "-", 1, self.serial_s)
        for (part, strategy, pes), t in sorted(self.parallel_s.items()):
            yield (strategy, part, pes, t)


def run_cost(graph: Graph, algorithm: str = "pagerank",
             strategies=("reduction", "sortdest", "basic", "pairs"),
             pe_counts=(1, 2, 4, 8), repeats: int = 3,
             partitioners=("contiguous",), device=None,
             **algo_params) -> CostReport:
    """COST sweep for any registered vertex program, per partitioner policy.

    ``graph`` should already be in the shape the program expects (the caller
    symmetrizes / attaches weights; ``ProgramSpec.prepare_graph`` helps).
    Each (partitioner, chare count) cell is partitioned ONCE and shared
    across every strategy.  All chares live on ``device`` (CUDA unless
    another is named), so every chare count in ``pe_counts`` runs.

    A ``grid(R,C)`` partitioner runs only at its own chare count R*C and
    only the ``grid2d`` strategy (every 1-D name would resolve to it); a
    grid whose R*C is not in ``pe_counts`` is skipped, so an unmeasured
    cell never surfaces as a verdict.
    """
    from repro_torch.core.partitioners import grid_shape

    device = resolve_device(device)
    spec = prog_mod.get_spec(algorithm)
    params = {**spec.defaults, **algo_params}
    serial = _time(lambda: spec.serial(graph, **params),
                   torch.device("cpu"), repeats)

    parallel, dispatch = {}, {}
    cells = {}  # partitioner -> strategies swept, for the verdict below
    for partitioner in partitioners:
        shape = grid_shape(partitioner)
        cell_pes = (pe_counts if shape is None
                    else [p for p in pe_counts if p == shape[0] * shape[1]])
        cell_strategies = strategies if shape is None else ("grid2d",)
        if not cell_pes:
            continue
        cells[partitioner] = cell_strategies
        for pes in cell_pes:
            pg = partition(graph, pes, partitioner=partitioner)
            for strategy in cell_strategies:
                eng = Engine(pg, strategy=strategy, device=device)
                dispatch[(partitioner, strategy, pes)] = eng.dispatch
                run = lambda: eng.run(algorithm, **params)
                run()  # warm outside the timed region (paper times compute)
                parallel[(partitioner, strategy, pes)] = _time(run, device,
                                                               repeats)

    cost = {}
    for partitioner, cell_strategies in cells.items():
        for strategy in cell_strategies:
            beats = [p for p in pe_counts
                     if parallel.get((partitioner, strategy, p), np.inf)
                     <= serial]
            cost[(partitioner, strategy)] = min(beats) if beats else float("inf")
    return CostReport(algorithm, serial, parallel, cost, dispatch)


def wire_model(graph: Graph, num_pes: int, value_bytes: int = 4,
               partitioner: str = "contiguous", batch: int = 1) -> dict:
    """Bytes on the wire per chare per superstep, by variant, for a mesh with
    one chare per device (analytic; the single-device port moves none):

    reduction: ring all-reduce of a dense |V'| buffer      ~2*V'*b
    sortdest:  reduce-scatter of locally-combined buffer   ~V'*b
    basic:     all_to_all of (dst,val) pairs, no combining ~2*Emax*2*b
    pairs:     (P-1) ring hops of one chunk block          ~V'*b

    V' is the *padded* vertex count P*K and Emax the heaviest chare's edge
    count; ``batch`` scales every value payload by B while the shared pair
    index of ``basic`` stays fixed.

    A ``grid(R,C)`` partitioner yields the 2-D two-phase-reduce entry
    instead.  Phase 1 is wire-free (each rectangle's edges are its own);
    phase 2 ring-reduces the per-rectangle partials down each grid column
    and redistributes each row chunk from its column owners:

        grid2d: 2*min(Kc, Dmax)*b*(R-1)/R  +  Kr*b*(C-1)/C

    where Kc/Kr are the padded column/row chunk heights and Dmax the
    heaviest rectangle's edge count (a rectangle cannot touch more distinct
    destinations than it has edges).
    """
    from repro_torch.core.partitioners import GridPlan, make_plan

    plan = make_plan(graph, num_pes, partitioner)
    B = max(int(batch), 1)
    if isinstance(plan, GridPlan):
        R, C = plan.rows, plan.cols
        d_max = int(plan.rect_counts.max()) if graph.num_edges else 0
        combine = 2 * min(plan.col_chunk_size, d_max) * value_bytes * B \
            * (R - 1) / max(R, 1)
        redistribute = plan.chunk_size * value_bytes * B * (C - 1) / max(C, 1)
        return {"grid2d": combine + redistribute}
    Pn = num_pes
    Vp = Pn * plan.chunk_size  # padded vertices (== V for perfect balance)
    e_max = int(plan.edges_per_chunk(graph).max()) if graph.num_edges else 0
    return {
        "reduction": 2 * Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "sortdest": Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "pairs": Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "basic": 2 * e_max * value_bytes * (1 + B),
    }


def grid_collective_bytes(graph, num_pes: int, partitioner: str,
                          value_bytes: int = 4, batch: int = 1) -> dict:
    """Phase-2 collective bytes per rectangle per superstep for BOTH grid2d
    lowerings, as a ring all-reduce moves them (2*bytes*(g-1)/g per member
    for a group of g):

        full:    one full-axis reduce of the [C*Kc] column-space buffer
                 over all P = R*C rectangles   -> 2*C*Kc*b*(P-1)/P
        grouped: a column-group reduce of the rectangle's own [Kc] slice
                 (groups of R) plus a row-group reduce of the [Kr] row-chunk
                 state (groups of C)
                 -> 2*Kc*b*(R-1)/R + 2*Kr*b*(C-1)/C

    The grouped/full ratio at grid(2,4) is 4/7.  ``batch`` scales every
    payload by B, as in ``wire_model``.  ``strategies.grid2d_phase2`` counts
    the same bytes as it runs.
    """
    from repro_torch.core.partitioners import GridPlan, make_plan

    plan = make_plan(graph, num_pes, partitioner)
    if not isinstance(plan, GridPlan):
        raise ValueError(f"{partitioner!r} is not a grid partitioner")
    R, C = plan.rows, plan.cols
    P = R * C
    b = value_bytes * max(int(batch), 1)
    Kc, Kr = plan.col_chunk_size, plan.chunk_size
    full = 2 * C * Kc * b * (P - 1) / max(P, 1)
    grouped = (2 * Kc * b * (R - 1) / max(R, 1)
               + 2 * Kr * b * (C - 1) / max(C, 1))
    return {"full": full, "grouped": grouped,
            "ratio": grouped / full if full else 1.0}
