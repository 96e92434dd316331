"""The one traffic generator: reads a mix's parameters, draws from the seed.

A mix file (``bench/traffic/<name>.json``) is data only:

* ``"loop": "closed"`` -- one client that starts its next program run when
  the last one returned.  ``programs`` lists the runs in the order they
  alternate: each a ``program`` name, its ``params``, and ``"source":
  "out_edge_vertex"`` for a program that starts from one vertex (drawn
  uniformly among the vertices with out-edges).
* ``"loop": "open"`` -- independent users whose queries are due on a fixed
  schedule, whether or not the system keeps up.  ``rate_per_s`` queries a
  second over the window, each with ``deadline_ms``; ``mix`` gives each
  program its ``weight``, ``params`` and ``source`` rule.  The window holds
  exactly round(rate x seconds) queries, their gaps the exponential law's
  quantiles (``arrivals``: ``shuffled_exponential``), and exactly the mix's
  shares of each program, both in a seeded order, so every seed offers the
  same work.

The seed is the benchmark's ``--seed``; every stream here is derived from
it and from nothing else.
"""

from __future__ import annotations

import dataclasses

import numpy as np

CLOSED_STREAM, OPEN_STREAM = 1, 2


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def _source(rule, starts: np.ndarray, rng: np.random.Generator):
    if rule is None:
        return None
    if rule != "out_edge_vertex":
        raise ValueError(f"unknown source rule {rule!r}")
    return int(starts[rng.integers(len(starts))])


def closed_runs(mix: dict, seed: int, starts: np.ndarray):
    """Endless (program, params, source) runs of a closed loop."""
    if mix["loop"] != "closed":
        raise ValueError("closed_runs needs a closed-loop mix")
    rng = rng_for(seed, CLOSED_STREAM)
    progs = mix["programs"]
    k = 0
    while True:
        p = progs[k % len(progs)]
        yield (p["program"], dict(p.get("params", {})),
               _source(p.get("source"), starts, rng))
        k += 1


@dataclasses.dataclass(frozen=True)
class Arrival:
    due_s: float  # seconds after the window opens
    program: str
    params: dict
    source: int | None
    deadline_s: float


def _due_times(rule: str, n: int, seconds: float,
               rng: np.random.Generator) -> np.ndarray:
    """``n`` due times in [0, seconds).  ``shuffled_exponential``: the n
    quantiles of the exponential law as the gaps, in a seeded order, scaled
    to the window -- Poisson-like arrivals whose gaps are the same set for
    every seed (independent draws let one seed's bursts set the tail)."""
    if rule != "shuffled_exponential":
        raise ValueError(f"unknown arrival rule {rule!r}")
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    rng.shuffle(gaps)
    t = np.cumsum(gaps)
    return (t - gaps[0]) * seconds / (t[-1] - gaps[0] + gaps.mean())


def open_schedule(mix: dict, seed: int, seconds: float,
                  starts: np.ndarray) -> list[Arrival]:
    """Every query due in a window of ``seconds``, sorted by due time."""
    if mix["loop"] != "open":
        raise ValueError("open_schedule needs an open-loop mix")
    rng = rng_for(seed, OPEN_STREAM)
    n = int(round(mix["rate_per_s"] * seconds))
    weights = np.array([m["weight"] for m in mix["mix"]], dtype=np.int64)
    # exactly the mix's shares: whole rounds of the weights, the remainder
    # from the front of the list, then a seeded shuffle
    counts = (n // weights.sum()) * weights
    rest = n - int(counts.sum())
    for i in range(len(weights)):
        take = min(rest, int(weights[i]))
        counts[i] += take
        rest -= take
    kinds = np.repeat(np.arange(len(weights)), counts)
    rng.shuffle(kinds)
    due = _due_times(mix["arrivals"], n, seconds, rng)
    deadline = mix["deadline_ms"] / 1e3
    out = []
    for t, k in zip(due, kinds):
        m = mix["mix"][int(k)]
        out.append(Arrival(float(t), m["program"], dict(m.get("params", {})),
                           _source(m.get("source"), starts, rng), deadline))
    return out
