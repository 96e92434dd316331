"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files at a size the CPU holds."""

import json
import pathlib
import shutil

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
TINY_SCALE = 9
TINY_RATE = 40.0


@pytest.fixture
def tiny_root(tmp_path):
    """The cells' files with every graph cut to 2^9 vertices and every open
    loop offered at 40 queries a second; limits, mixes and samples as
    committed."""
    root = tmp_path / "bench"
    for kind in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(BENCH / kind, root / kind)
    for p in (root / "configs").glob("*.json"):
        d = json.loads(p.read_text())
        d["graph"]["scale_log2"] = TINY_SCALE
        p.write_text(json.dumps(d))
    for p in (root / "traffic").glob("*.json"):
        d = json.loads(p.read_text())
        if d["loop"] == "open":
            d["rate_per_s"] = TINY_RATE
        p.write_text(json.dumps(d))
    return root


@pytest.fixture(scope="session")
def benchmark_json():
    return json.loads((BENCH.parent / "BENCHMARK.json").read_text())
