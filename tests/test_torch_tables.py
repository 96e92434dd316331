"""The port's paper tables (``run_table``, the dataflow stand-in,
``grid_table``) and their rows in ``repro_torch.benchmarks.run``, against
the reference's ``benchmarks/tables.py``, ``benchmarks/graphx_analogue.py``
and ``benchmarks/run.py``, on the CPU at small scales.
"""

import numpy as np
import pytest

from benchmarks import graphx_analogue as rflow
from benchmarks import tables as rtables
from conftest import graph, program_graph
from repro.core import get_spec as rget_spec
from repro.core import registered_names as rregistered_names
from repro_torch.benchmarks import graphx_analogue as tflow
from repro_torch.benchmarks import run as brun
from repro_torch.benchmarks import tables
from repro_torch.core import graph_from_reference, registered_names
from repro_torch.launch import serve

from test_torch_serve import FixedStepTime

PROGRAMS = tuple(registered_names())


def to_port(g):
    return graph_from_reference(g.num_vertices, g.indptr, g.dst,
                                weight=g.weight, directed=g.directed)


@pytest.mark.parametrize("gname", ("rmat6", "rmat10", "ring13"))
def test_pagerank_dataflow_equals_reference(gname):
    g = graph(gname)
    got = tflow.pagerank_dataflow(to_port(g), 0.85, 20, device="cpu")
    want = rflow.pagerank_dataflow(g, 0.85, 20)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gname", ("rmat6", "rmat10", "two_cliques10",
                                   "isolated_vertices"))
def test_labelprop_dataflow_equals_reference(gname):
    g = program_graph("labelprop", gname)
    got, iters = tflow.labelprop_dataflow(to_port(g), device="cpu")
    want, want_iters = rflow.labelprop_dataflow(g)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert iters == want_iters


def test_dataflow_stand_ins_match_the_registry():
    assert set(tables.DATAFLOW) == set(rtables.DATAFLOW)
    g = to_port(program_graph("labelprop", "rmat6"))
    labels, _ = tables.DATAFLOW["labelprop"](g, {"max_iters": 10_000}, "cpu")
    ranks = tables.DATAFLOW["pagerank"](g, {"alpha": 0.85, "iters": 20},
                                        "cpu")
    assert labels.shape == ranks.shape == (g.num_vertices,)
    assert tflow.bench(lambda: None, repeats=2, device="cpu") >= 0.0


class _StubEngine:
    """The reference engine's stand-in for its row structure: the serial
    result, so its ``run_table`` yields its rows without compiling."""

    def __init__(self, pg, strategy):
        self.pg = pg

    def run(self, algorithm, **params):
        return rget_spec(algorithm).run_serial(self.pg.graph), 1


@pytest.mark.parametrize("algo", PROGRAMS)
def test_run_table_rows_equal_reference(algo, monkeypatch):
    """The port's rows are the reference's (graph, impl, pes) rows in the
    same order, over both partitioners of its full run, every one
    correct."""
    monkeypatch.setattr(rtables, "Engine", _StubEngine)
    monkeypatch.setattr(rtables, "bench", lambda fn, repeats=3: 0.0)
    kw = dict(scale_log2=6, repeats=1,
              partitioners=("contiguous", "edge_balanced"))
    got = tables.run_table(algo, device="cpu", **kw)
    want = rtables.run_table(algo, **kw)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    assert all(r[4] for r in got)
    assert all(r[3] >= 0.0 for r in got)


def test_run_table_names_its_graphs():
    rows = tables.run_table("bfs", scale_log2=6, repeats=1, device="cpu",
                            graphs=("twitter_rv",))
    assert {r[0] for r in rows} == {"twitter_rv"}
    assert [r[1] for r in rows] == ["serial", "reduction", "sortdest",
                                    "basic", "pairs"]


def test_grid_table_equals_reference():
    got = tables.grid_table(scale_log2=8)
    want = rtables.grid_table(scale_log2=8)
    assert [r[:3] for r in got] == [r[:3] for r in want]
    for (*_, ours), (*_, theirs) in zip(got, want):
        assert ours.keys() == theirs.keys()
        for key in ("wire", "wire_basic_1d", "wire_best_1d"):
            assert ours[key] == theirs[key], key
        assert ours["stats"].keys() == theirs["stats"].keys()
        for key, value in theirs["stats"].items():
            if isinstance(value, np.ndarray):
                np.testing.assert_array_equal(ours["stats"][key], value)
            else:
                assert ours["stats"][key] == value, key


def _reference_names(scale, partitioners, monkeypatch):
    """The row names the reference's ``benchmarks/run.py`` prints for its
    table, cost, fig12 and grid sections, by its own formulas over its own
    ``run_table`` rows (stub engine) and ``grid_table``."""
    monkeypatch.setattr(rtables, "Engine", _StubEngine)
    monkeypatch.setattr(rtables, "bench", lambda fn, repeats=3: 0.0)
    names = set()
    for algo in rregistered_names():
        rows = rtables.run_table(algo, scale_log2=scale,
                                 partitioners=partitioners)
        table = rget_spec(algo).table
        for g, impl, pes, _, _ in rows:
            names.add(f"{table}.{g}.{impl}@{pes}")
            names.add(f"cost.{algo}.{g}")
            if impl == "dataflow":
                names.add(f"fig12.{algo}.{g}.dataflow_vs_serial")
    for g, pname, pes, _ in rtables.grid_table(scale_log2=scale):
        names.add(f"grid.{g}.{pname}@{pes}.imbalance")
        names.add(f"grid.{g}.{pname}@{pes}.wire")
    return names


def test_benchmark_run_prints_the_tables_by_the_reference_names(
        monkeypatch, tmp_path, capsys):
    """``python -m repro_torch.benchmarks.run`` prints the reference's
    table2-table8, cost.*, fig12.* and grid.* rows (every result correct,
    or the run fails), the grid values equal to the reference's, and
    writes the algorithms and grid sections of BENCH_cost.json."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(serve, "time", FixedStepTime())
    out = brun.main(["--scale", "6", "--device", "cpu", "--json"])
    lines = capsys.readouterr().out.splitlines()
    # a grid row's name holds a comma, grid(2,4): split from the right
    rows = {n: rest for n, *rest in (line.rsplit(",", 2) for line in lines)}
    heads = ("table", "cost.", "fig12.", "grid.")
    got = {n for n in rows if n.startswith(heads)}
    assert got == _reference_names(6, ("contiguous", "edge_balanced"),
                                   monkeypatch)
    for algo, per_graph in out["algorithms"].items():
        for g, cell in per_graph.items():
            assert rows[f"cost.{algo}.{g}"][0] == str(cell["cost"])
            assert cell["cost"] in (1, "inf(1PE)")
    for g, pname, pes, m in rtables.grid_table(scale_log2=6):
        assert rows[f"grid.{g}.{pname}@{pes}.wire"][0] == f"{m['wire']:.3e}"
        assert rows[f"grid.{g}.{pname}@{pes}.imbalance"][0] == \
            f"{m['stats']['edge_imbalance']:.3f}"
    saved = __import__("json").loads((tmp_path / "BENCH_cost.json")
                                     .read_text())
    assert set(saved) >= {"algorithms", "grid", "throughput", "serving"}
    assert set(saved["algorithms"]) == set(PROGRAMS)


def test_benchmark_run_fails_on_a_wrong_result(monkeypatch, capsys):
    real = tables.run_table

    def wrong(*args, **kw):
        rows = real(*args, **kw)
        return rows[:-1] + [rows[-1][:4] + (False,)]

    monkeypatch.setattr(tables, "run_table", wrong)
    with pytest.raises(AssertionError, match="wrong output"):
        brun.main(["--scale", "5", "--device", "cpu", "--quick"])
