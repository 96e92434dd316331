"""Plain torch oracles for the push kernels: the twins of
``repro/kernels/ref.py``'s ``push_ref`` and gather/scatter references,
and its numpy ``async_min_fixpoint_ref`` and ``betweenness_ref``.

Edge arrays are 1-D ``[E]``; ``vals`` / the gathered data may carry a
trailing batch axis (``[V, B]`` / ``[E, B]``).  Indices are widened to int64
for ``index_select`` / ``index_add_`` / ``scatter_reduce``.
"""

from __future__ import annotations

import numpy as np
import torch

SENTINEL = 2147483647  # int32 max: the min monoid's "unreached"


def _expand(mask, data):
    """Broadcast a per-edge [E] mask against [E] or batched [E, B] data."""
    return mask.reshape(mask.shape + (1,) * (data.dim() - mask.dim()))


def gather_sum_ref(src, valid, vals):
    c = vals.to(torch.float32).index_select(0, src.long())
    return torch.where(_expand(valid != 0, c), c, torch.zeros((), dtype=c.dtype,
                                                              device=c.device))


def scatter_sum_ref(dst, c, num_segments):
    out = torch.zeros((num_segments,) + tuple(c.shape[1:]), dtype=c.dtype,
                      device=c.device)
    return out.index_add_(0, dst.long(), c)


def gather_min_ref(src, valid, vals):
    c = vals.index_select(0, src.long())
    return torch.where(_expand(valid != 0, c), c,
                       torch.full((), SENTINEL, dtype=c.dtype, device=c.device))


def scatter_min_ref(dst, c, num_segments):
    """Segment min; empty segments hold the dtype's maximum (+inf for
    floats), as ``jax.ops.segment_min`` leaves them."""
    big = (float("inf") if c.dtype.is_floating_point
           else torch.iinfo(c.dtype).max)
    out = torch.full((num_segments,) + tuple(c.shape[1:]), big,
                     dtype=c.dtype, device=c.device)
    idx = _expand(dst.long(), c).expand_as(c)
    return out.scatter_reduce_(0, idx, c, reduce="amin", include_self=True)


def push_ref(vals, src, dst, valid, num_segments, combine="add", weight=None):
    """Full hot loop: out[s] = combine_{e: dst[e]==s, valid[e]} ev(vals[src[e]])
    where the optional per-edge ``weight`` applies the semiring transform
    (``* w`` for add, sentinel-saturating ``+ w`` for min).  Float min maps
    sentinel-range results back to +inf, matching ``ops.push``."""
    if combine == "add":
        c = gather_sum_ref(src, valid, vals)
        if weight is not None:
            c = c * _expand(weight.to(c.dtype), c)
        return scatter_sum_ref(dst, c, num_segments).to(vals.dtype)
    c = gather_min_ref(src, valid, vals)
    floating = c.dtype.is_floating_point
    if weight is not None:
        w = _expand(weight.to(c.dtype), c)
        if floating:
            c = c + w
        else:
            c = c + torch.minimum(w, SENTINEL - c)  # int32-safe saturation
    out = scatter_min_ref(dst, c, num_segments)
    if floating:
        out = torch.where(out >= SENTINEL, torch.full_like(out, float("inf")),
                          out)
    return out


def async_min_fixpoint_ref(src, dst, init, weight=None, max_stale=1,
                           ages=None, seed=0, max_sweeps=10_000):
    """Serial stale-read superstep simulator for min-monoid label
    correcting, in numpy: the reference the engine's ``sync="overlap"`` is
    held to.

    Sweep t relaxes every edge ``e`` reading ``history[t - age(t, e)]`` --
    the source's state as of ``age`` sweeps ago, ``age <= max_stale`` drawn
    per (sweep, edge) from ``seed`` unless an explicit ``[sweeps, E]``
    ``ages`` schedule is given (age 0 is synchronous Jacobi; ``max_stale=1``
    models the engine's double-buffered overlap).  The new state is
    ``min(state, min_e relax(e))``, monotone non-increasing, so stale reads
    only re-deliver values the fixpoint already absorbed.

    Termination is the generalized double check: stop after ``max_stale +
    1`` consecutive quiescent sweeps (every read reaches at most
    ``max_stale`` sweeps back, so by then every in-flight read equals the
    current state).

    Returns ``(state, sweeps)``: the fixpoint and the sweeps executed,
    the quiescent tail included.
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    state = np.asarray(init).copy()
    E = len(src)
    w = None if weight is None else np.asarray(weight)
    rng = np.random.default_rng(seed)
    history = [state.copy()]  # history[t] = state entering sweep t
    quiet = 0
    sweeps = 0
    while quiet <= max_stale and sweeps < max_sweeps:
        if ages is not None:
            age = np.asarray(ages[min(sweeps, len(ages) - 1)])
        else:
            age = rng.integers(0, max_stale + 1, size=E)
        age = np.minimum(age, sweeps)  # no history before sweep 0
        read = np.stack(history[-(max_stale + 1):], axis=0)  # [<=S+1, V]
        vals = read[len(read) - 1 - age, src]  # stale source labels
        relax = vals if w is None else vals + w
        new = state.copy()
        np.minimum.at(new, dst, relax)
        sweeps += 1
        quiet = quiet + 1 if np.array_equal(new, state) else 0
        state = new
        history.append(state.copy())
        if len(history) > max_stale + 1:
            history.pop(0)
    return state, sweeps


def betweenness_ref(graph, pivots):
    """Serial Brandes accumulation over the pivot set (numpy, no engine).

    Unweighted directed betweenness approximated by running Brandes' forward
    (sigma path counts by BFS level) and backward (delta dependency) sweeps
    from each pivot, then scaling by V / len(pivots) to estimate the
    all-sources sum.  Returns (scores float64 [V], supersteps) where
    supersteps counts the BFS frontier expansions the engine would run
    (the max eccentricity over pivots, +1 for the quiescence detection
    step, matching ``bfs_serial``'s convention per pivot).
    """
    src = np.asarray(graph.src)
    dst = np.asarray(graph.dst)
    n = graph.num_vertices
    scores = np.zeros(n, np.float64)
    iters = 0
    for s in pivots:
        d = np.full(n, -1, np.int64)
        sigma = np.zeros(n, np.float64)
        d[s] = 0
        sigma[s] = 1.0
        level = 0
        frontier = d == 0
        while frontier.any():
            on = frontier[src]
            hit = on & (d[dst] == -1)
            nxt = np.zeros(n, bool)
            nxt[dst[hit]] = True
            d[dst[hit]] = level + 1
            dag = on & (d[dst] == level + 1)
            np.add.at(sigma, dst[dag], sigma[src[dag]])
            frontier = nxt
            level += 1
        iters = max(iters, level)
        delta = np.zeros(n, np.float64)
        for lvl in range(level, 0, -1):
            dag = (d[src] == lvl - 1) & (d[dst] == lvl)
            contrib = np.zeros(n, np.float64)
            with np.errstate(invalid="ignore", divide="ignore"):
                ratio = np.where(sigma[dst] > 0, sigma[src] / sigma[dst], 0.0)
            np.add.at(contrib, src[dag], (ratio * (1.0 + delta[dst]))[dag])
            delta = delta + contrib
        delta[s] = 0.0
        scores += delta
    scores *= n / max(len(pivots), 1)
    return scores, iters
