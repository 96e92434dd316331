"""Whether the timed path's answers are right: each against the reference.

``judge`` takes the answers a window kept (the sampled runs or queries,
their values as the program returned them, and the supersteps it
reported) and the inputs the benchmark made, runs the plain reference
(``bench/reference``) for each on the same device, and returns each
compared number beside its limit from the workload file:

* ``rank_rel_err``: PageRank and weighted PageRank, the largest
  |got - ref| / ref over every vertex of every sampled run; the reference
  in float64 (ref >= 1 - alpha everywhere).
* ``ppr_rel_err``: personalized PageRank rows, the largest |got - ref| over
  the row divided by the row's largest ref, worst row.
* ``dist_mismatch``: bfs hop counts and sssp float32 distances, the
  vertices that differ from the reference at all, summed.
* ``steps_off``: answers whose superstep count is not the reference's
  (``iters`` for the fixed programs; the relaxation's own count, last
  quiet superstep included, for the min programs).  Traced runs, whose
  values are not kept, are held to this one.
* ``missing``: sampled answers that never came.

``control=True`` puts the reference itself, in bfloat16, in the program's
place (the control): the same sampled answers, judged the same way.
"""

from __future__ import annotations

import dataclasses

import torch

from bench.reference import programs as ref

ADD_PROGRAMS = {"pagerank": False, "pagerank_weighted": True}


class Judge:
    """The reference graph on ``device`` and each reference answer once."""

    def __init__(self, csr, device):
        self.g = ref.upload(csr.indptr, csr.dst, csr.weight, device)
        self._cache: dict = {}

    def reference(self, program: str, params: dict, source, dtype=None):
        key = (program, tuple(sorted(params.items())), source, str(dtype))
        if key not in self._cache:
            self._cache[key] = self._compute(program, params, source, dtype)
        return self._cache[key]

    def _compute(self, program, params, source, dtype):
        g = self.g
        if program in ADD_PROGRAMS:
            return ref.pagerank(g, params.get("alpha", 0.85),
                                params.get("iters", 20),
                                ADD_PROGRAMS[program],
                                dtype or torch.float64)
        if program == "personalized_pagerank":
            return ref.personalized_pagerank(g, source,
                                             params.get("alpha", 0.85),
                                             params.get("iters", 20),
                                             dtype or torch.float64)
        if program == "bfs":
            return ref.bfs(g, source)
        if program == "sssp":
            return ref.sssp(g, source, dtype=dtype or torch.float32)
        raise ValueError(f"no reference for program {program!r}")


def as_control(j: Judge, a):
    """The answer the control gives in the program's place: the reference
    in bfloat16 (bfs has no lower precision and stays exact)."""
    if a.value is None:
        return a
    low = j.reference(a.program, a.params, a.source, torch.bfloat16)
    if isinstance(low, ref.Traversal):
        return dataclasses.replace(a, value=low.value,
                                   supersteps=low.supersteps)
    return dataclasses.replace(a, value=low,
                               supersteps=a.params.get("iters", 20))


def _numbers(j: Judge, a) -> dict:
    """One answer's compared numbers."""
    truth = j.reference(a.program, a.params, a.source)
    traversal = truth if isinstance(truth, ref.Traversal) else None
    want_steps = (traversal.supersteps if traversal
                  else a.params.get("iters", 20))
    if a.supersteps is None:
        return {"missing": 1}
    out = {"steps_off": int(a.supersteps != want_steps)}
    if a.value is None:  # a traced run: its count alone
        return out
    got = torch.as_tensor(a.value).to(j.g.src.device)
    if traversal is not None:
        got = got.to(traversal.value.dtype)
        out["dist_mismatch"] = int((got != traversal.value).sum())
        return out
    got, t = got.to(torch.float64), truth.to(torch.float64)
    if a.program == "personalized_pagerank":
        out["ppr_rel_err"] = float((got - t).abs().max() / t.abs().max())
    else:
        out["rank_rel_err"] = float(((got - t).abs() / t).max())
    return out


SUMMED = {"dist_mismatch", "steps_off", "missing"}


def judge(csr, answers: list, limits: dict, device, control: bool = False):
    """-> (numbers {name: value}, failed answers, traversals by answer
    index for the traced min runs)."""
    j = Judge(csr, device)
    numbers: dict = {}
    failed = 0
    traversals = {}
    for i, a in enumerate(answers):
        got = _numbers(j, as_control(j, a) if control else a)
        for k, v in got.items():
            v = float("inf") if v != v else v  # a NaN answer fails
            got[k] = v
            numbers[k] = (numbers.get(k, 0) + v if k in SUMMED
                          else max(numbers.get(k, 0.0), v))
        if any(v > limits.get(k, 0) for k, v in got.items()):
            failed += 1
        truth = j.reference(a.program, a.params, a.source)
        if a.traced and isinstance(truth, ref.Traversal):
            traversals[i] = truth
    for k in limits:
        numbers.setdefault(k, 0 if k in SUMMED else None)
    return numbers, failed, traversals
