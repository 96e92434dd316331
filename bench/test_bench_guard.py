"""The benchmark's guards: what it may import, how it finds its files,
that BENCHMARK.json names files that exist, and that a configuration's
settings reach the program whole."""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from bench import graphgen, harness, system

BENCH = harness.BENCH
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: pathlib.Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not _top_level_imports(f) & NEVER, f


def test_references_import_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert not _top_level_imports(f) & (NEVER | {"repro_torch"}), f


def test_a_new_workload_file_is_listed_with_no_edit(tiny_root):
    before = harness.list_workloads(tiny_root)
    (tiny_root / "workloads" / "lj-new-mix.json").write_text(json.dumps(
        {"config": "soc-lj1-s22", "traffic": "pagerank_pair"}))
    assert harness.list_workloads(tiny_root) == sorted(before
                                                       + ["lj-new-mix"])
    assert harness.load(tiny_root, "workloads", "lj-new-mix")["config"] \
        == "soc-lj1-s22"


def test_benchmark_json_names_existing_files(benchmark_json):
    root = BENCH.parent
    cells = {w["name"]: w for w in benchmark_json["workloads"]}
    assert sorted(cells) == harness.list_workloads()
    for c in benchmark_json["configs"]:
        assert (root / c["file"]).is_file()
        assert json.loads((root / c["file"]).read_text())["reduced"] \
            == c["reduced"]
    for name, w in cells.items():
        wl = harness.load(BENCH, "workloads", name)
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        harness.load(BENCH, "traffic", w["traffic"])
        e2e, layer = harness.cell_metrics(benchmark_json, name)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer and all(m["moves"] in names for m in layer)
    for m in benchmark_json["per_layer"]:
        assert callable(harness.load_reader(BENCH, m["name"]))


@pytest.mark.parametrize("kind", ["partition", "engine"])
def test_a_config_key_the_program_does_not_take_fails(kind):
    csr = graphgen.rmat_csr(6, 4, 1, torch.device("cpu"))
    cfg = harness.load(BENCH, "configs", "soc-lj1-s22")
    engine = system.build_engine(csr, cfg, torch.device("cpu"))
    assert engine.strategy == cfg["engine"]["strategy"]
    cfg[kind] = dict(cfg[kind], not_a_setting=1)
    with pytest.raises(TypeError, match="not_a_setting"):
        system.build_engine(csr, cfg, torch.device("cpu"))


def test_run_refuses_without_a_card(tmp_path):
    """With no CUDA card in sight: no result line, a non-zero exit."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "lj-pagerank", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=tmp_path, env=env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
