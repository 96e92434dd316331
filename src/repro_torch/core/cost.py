"""COST harness -- Configuration that Outperforms a Single Thread.

The twin of ``repro/core/cost.py``: time the serial baseline, time every
parallel variant at each chare count, report per-cell runtimes and the COST
(smallest chare count at which a variant matches the serial baseline; inf if
never).  Timings exclude graph ingestion/partitioning, as in the paper, and
wait for the device (``torch.cuda.synchronize``) before reading the clock.

``wire_model`` is the reference's analytic per-superstep wire-byte model
for 1-D placements (pure arithmetic, the same numbers).
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
    """
    device = resolve_device(device)
    spec = prog_mod.get_spec(algorithm)
    params = {**spec.defaults, **algo_params}
    serial = _time(lambda: spec.serial(graph, **params),
                   torch.device("cpu"), repeats)

    parallel, dispatch = {}, {}
    for partitioner in partitioners:
        for pes in pe_counts:
            pg = partition(graph, pes, partitioner=partitioner)
            for strategy in strategies:
                eng = Engine(pg, strategy=strategy, device=device)
                dispatch[(partitioner, strategy, pes)] = eng.dispatch
                run = lambda: eng.run(algorithm, **params)
                run()  # warm outside the timed region (paper times compute)
                parallel[(partitioner, strategy, pes)] = _time(run, device,
                                                               repeats)

    cost = {}
    for partitioner in partitioners:
        for strategy in strategies:
            beats = [p for p in pe_counts
                     if parallel[(partitioner, strategy, p)] <= serial]
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
    """
    from repro_torch.core.partitioners import make_plan

    plan = make_plan(graph, num_pes, partitioner)
    B = max(int(batch), 1)
    Pn = num_pes
    Vp = Pn * plan.chunk_size  # padded vertices (== V for perfect balance)
    e_max = int(plan.edges_per_chunk(graph).max()) if graph.num_edges else 0
    return {
        "reduction": 2 * Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "sortdest": Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "pairs": Vp * value_bytes * B * (Pn - 1) / max(Pn, 1),
        "basic": 2 * e_max * value_bytes * (1 + B),
    }
