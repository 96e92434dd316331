"""The traffic generator and the loops' bookkeeping: seeded, exact counts,
the same work for every seed."""

import numpy as np
import pytest

from bench import harness, loops
from bench.traffic import generator

STARTS = np.arange(10, 1000, 7)


@pytest.mark.parametrize("name", ["bfs_ppr_p80", "bfs_ppr_over"])
def test_open_schedule_offers_the_rate_and_the_mix_exactly(name):
    mix = harness.load(harness.BENCH, "traffic", name)
    a = generator.open_schedule(mix, 2**31 + 5, 20.0, STARTS)
    b = generator.open_schedule(mix, 2**31 + 5, 20.0, STARTS)
    c = generator.open_schedule(mix, 6, 20.0, STARTS)
    assert a == b and a != c
    assert len(a) == len(c) == round(mix["rate_per_s"] * 20.0)
    due = [x.due_s for x in a]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 20.0
    for m in mix["mix"]:
        share = m["weight"] / sum(x["weight"] for x in mix["mix"])
        for sched in (a, c):
            n = sum(x.program == m["program"] for x in sched)
            assert abs(n - share * len(sched)) < 1
    assert all(x.source in STARTS for x in a)
    assert {x.deadline_s for x in a} == {mix["deadline_ms"] / 1e3}


def test_arrivals_are_the_same_gaps_in_another_order():
    mix = {"loop": "open", "rate_per_s": 50.0, "deadline_ms": 100.0,
           "arrivals": "shuffled_exponential",
           "mix": [{"program": "bfs", "weight": 1}]}
    due = [np.array([x.due_s for x in generator.open_schedule(
        mix, seed, 10.0, STARTS)]) for seed in (3, 4)]
    for d in due:
        assert len(d) == 500 and d.min() == 0.0 and d.max() < 10.0
        gaps = np.diff(d)
        assert np.all(gaps >= 0)
        # exponential gaps: their spread is about their mean
        assert 0.7 < gaps.std() / gaps.mean() < 1.3
    assert not np.array_equal(due[0], due[1])
    # the same quantile gaps (but the one before the window's first query),
    # each seed's scaled to its window
    g0, g1 = (np.sort(np.diff(d)) for d in due)
    assert np.median(np.abs(g0 / g1 - 1)) < 0.02


def test_closed_runs_alternate_with_seeded_sources():
    mix = {"loop": "closed",
           "programs": [{"program": "sssp", "source": "out_edge_vertex"},
                        {"program": "bfs", "source": "out_edge_vertex"}]}
    take = [r for _, r in zip(range(6), generator.closed_runs(mix, 9,
                                                              STARTS))]
    again = [r for _, r in zip(range(6), generator.closed_runs(mix, 9,
                                                               STARTS))]
    assert take == again
    assert [r[0] for r in take] == ["sssp", "bfs"] * 3
    assert all(r[2] in STARTS for r in take)


def test_reservoir_keeps_k_of_a_stream_by_the_seed():
    def kept(seed, n):
        pool = loops.Reservoir(3, np.random.default_rng(seed))
        items = [None] * 3
        for i in range(n):
            slot = pool.offer()
            if slot is not None:
                items[slot] = i
        return items

    assert kept(1, 2) == [0, 1, None]
    assert kept(1, 500) == kept(1, 500)
    assert len(set(kept(1, 500))) == 3 and max(kept(1, 500)) < 500


def test_nearest_rank_percentile():
    v = list(range(1, 101))
    assert loops.percentile(v, 95) == 95
    assert loops.percentile(v, 50) == 50
    assert loops.percentile([3.0], 95) == 3.0
    assert loops.percentile([1.0, float("inf")], 95) == float("inf")
