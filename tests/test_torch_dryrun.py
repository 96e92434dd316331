"""The dry run (``repro_torch.launch.dryrun``), its op-level analyzer
(``repro_torch.launch.opanalysis``) and the roofline table
(``repro_torch.benchmarks.roofline``) against the reference's dry-run
machinery.

``repro.launch.dryrun`` is never imported: at import it sets ``XLA_FLAGS``
to 512 host devices, which would change every later JAX test in the same
worker.  The reference's cells are built here from ``repro.models.{train,
serve,model}`` and ``repro.configs``, compiled on one CPU device and read
by ``repro.launch.hloanalysis``; its ``model_flops`` is taken from its
source without running the module.

Where the two programs compute different products the test names them
and asserts the gap exactly, from the shapes (``GAPS``; ROADMAP queue 3):

  * the CE chunk's head product: the port's checkpointed chunk recomputes
    its logits in the backward; the reference's chunk checkpoint is
    ``prevent_cse=False``, and XLA merges the recompute with the forward;
  * the reference's remat: it nests a checkpoint around each pattern
    repeat over the per-block ones (``repro/models/model.py:152``), so
    its backward recomputes the slot blocks' forward once more -- less the
    products XLA's CSE merges with the forward (the first slot block's
    input projections, where the repeats are one unrolled iteration) and
    the ones its DCE drops (the last block's output projection, whose
    result the backward never reads) -- and checkpoints the attention's
    q and kv loops (``repro/models/layers.py:159``), recomputing its
    scores and values where they are not merged away;
  * mLSTM's ``n_intra``: the reference takes the row sum of ``w * s`` as
    a product with a ones vector (``repro/models/ssm.py:203``); the port
    sums it.
"""

import ast
import functools
import json
import math
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as P

from repro import configs as RC
from repro.launch import hloanalysis
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models import train as RT
from repro.models.config import SHAPES as RSHAPES
from repro.models.config import ShapeConfig as RShape
from repro.models.sharding import param_specs as rparam_specs
from repro_torch import configs as TC
from repro_torch.benchmarks import roofline as TR
from repro_torch.benchmarks import run as brun
from repro_torch.launch import dryrun as D
from repro_torch.launch import opanalysis as OA
from repro_torch.launch import mesh as LM
from repro_torch.launch.mesh import (HBM_BW, IB_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                     make_production_mesh, make_trace_mesh)
from repro_torch.models import train as TT
from repro_torch.models.config import SHAPES, ShapeConfig

SMOKE_ARCHS = ("gemma3-1b", "kimi-k2-1t-a32b", "xlstm-350m", "hubert-xlarge")
KINDS = ("prefill", "decode", "train")
B, S = 4, 64


def _cells():
    for arch in SMOKE_ARCHS:
        for kind in KINDS:
            if not (RC.smoke_config(arch).encoder_only and kind == "decode"):
                yield arch, kind


CELLS = tuple(_cells())


# ---------------------------------------------------------------------------
# The reference, built here (never through repro.launch.dryrun)
# ---------------------------------------------------------------------------


def _reference_function(name):
    """A function of ``src/repro/launch/dryrun.py``, compiled from its
    source alone (the module's first lines set XLA_FLAGS)."""
    path = pathlib.Path(hloanalysis.__file__).parent / "dryrun.py"
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns[name]


@functools.lru_cache(maxsize=None)
def reference_flops(arch, kind):
    """Dot FLOPs of the reference's step on one CPU device (its
    ``build_cell`` without a mesh), by its HLO analyzer."""
    cfg = RC.smoke_config(arch)
    shape = RShape(kind, S, B, kind)
    specs = RC.input_specs(cfg, shape)
    if kind == "train":
        fn, args = RT.make_train_step(cfg), (RT.abstract_state(cfg), specs)
    elif kind == "prefill":
        fn, args = RSV.make_prefill_step(cfg), (RM.abstract_params(cfg),
                                                specs)
    else:
        fn, args = RSV.make_decode_step(cfg), (
            RM.abstract_params(cfg), specs["tokens"], specs["pos"],
            specs["cache"])
    text = jax.jit(fn).lower(*args).compile().as_text()
    ana = hloanalysis.analyze(text, 1)
    assert ana.unresolved_loops == 0
    return int(ana.flops)


@functools.lru_cache(maxsize=None)
def port_analysis(arch, kind, b=B, s=S):
    cfg = TC.smoke_config(arch)
    fn, args = D.build_cell(cfg, ShapeConfig(kind, s, b, kind))
    result, ana = OA.analyze(fn, *args)
    return ana, D.card_memory(args, result, ana)


# ---------------------------------------------------------------------------
# The named products where the two programs differ
# ---------------------------------------------------------------------------


def products(arch):
    """FLOPs of one product of each kind at the smoke config, B x S."""
    cfg = TC.smoke_config(arch)
    d, H, KV, hd, T = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd, \
        B * S
    di = cfg.ssm_expand * d
    dh, c = di // H, min(256, S)
    rows = S if cfg.encoder_only else S - 1  # the CE's positions
    return {
        "head": 2 * B * rows * cfg.vocab_size * d,
        "q": 2 * T * d * H * hd,           # Q, and O
        "kv": 2 * T * d * KV * hd,         # K, and V
        "attn": 2 * B * H * S * S * hd,    # scores, and values
        "mlp": 2 * T * d * cfg.d_ff,       # gate, in, out
        "router": 2 * T * d * cfg.num_experts,
        "mlstm_qkv": 2 * T * d * 3 * di,
        "mlstm_gates": 2 * T * d * 2 * H,
        "ssm_out": 2 * T * di * d,         # mLSTM's and sLSTM's out_proj
        "chunk": 2 * B * H * c * c * dh,   # an mLSTM chunk's [c,c]x[c,dh]
        "vec": 2 * B * H * c * dh,         # an mLSTM normalizer product
        "slstm_qkv": 2 * T * d * 4 * di,
    }


# reference minus port, in products of each kind (module docstring)
GAPS = {
    ("gemma3-1b", "train"): {"kv": 10, "q": 11, "mlp": 17, "attn": -4,
                             "head": -1},
    ("kimi-k2-1t-a32b", "train"): {"q": 4, "kv": 4, "router": 2, "attn": 4,
                                   "head": -1},
    ("hubert-xlarge", "train"): {"q": 8, "kv": 8, "mlp": 8, "attn": 8,
                                 "head": -1},
    ("xlstm-350m", "train"): {"mlstm_qkv": 6, "mlstm_gates": 6,
                              "slstm_qkv": 1, "ssm_out": 7, "chunk": 14,
                              "vec": 14, "head": -1},
    ("xlstm-350m", "prefill"): {"vec": 7},
}


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dot_flops_against_reference(arch, kind):
    """The port's dot FLOPs on ``meta`` against the reference's compiled
    step: equal, or apart by exactly the named products."""
    ana, _ = port_analysis(arch, kind)
    prod = products(arch)
    gap = sum(n * prod[k] for k, n in GAPS.get((arch, kind), {}).items())
    assert reference_flops(arch, kind) - int(ana.flops) == gap
    assert sum(ana.flops_by_dtype.values()) == ana.flops


@pytest.mark.parametrize("shape_name", tuple(SHAPES))
@pytest.mark.parametrize("arch", TC.list_archs())
def test_model_flops_equal_reference(arch, shape_name):
    want = _reference_function("model_flops")(RC.get_config(arch),
                                              RSHAPES[shape_name])
    assert D.model_flops(TC.get_config(arch), SHAPES[shape_name]) == want


# ---------------------------------------------------------------------------
# Production meshes: per-device argument bytes of the spec tables
# ---------------------------------------------------------------------------


class _SpecMesh:
    """What the reference's spec functions read of a mesh (its axis names
    and sizes, ``devices.shape``), for an ``AbstractMesh``."""

    def __init__(self, mesh):
        self.axis_names, self.shape = mesh.axis_names, mesh.shape
        self.devices = np.empty(tuple(mesh.axis_sizes), dtype=object)


def reference_argument_bytes(arch, shape_name, multi_pod):
    """Sum of the reference's shard shapes over its ``build_cell``'s input
    shardings, by ``NamedSharding(AbstractMesh, spec).shard_shape``."""
    cfg, shape = RC.get_config(arch), RSHAPES[shape_name]
    mesh = AbstractMesh((2, 16, 16) if multi_pod else (16, 16),
                        ("pod", "data", "model") if multi_pod
                        else ("data", "model"))
    sm = _SpecMesh(mesh)

    def shards(tree, specs):
        leaves = jax.tree.leaves(tree)
        spec_leaves = jax.tree.leaves(specs,
                                      is_leaf=lambda s: isinstance(s, P))
        assert len(leaves) == len(spec_leaves)
        return sum(math.prod(NamedSharding(mesh, sp).shard_shape(x.shape))
                   * np.dtype(x.dtype).itemsize
                   for x, sp in zip(leaves, spec_leaves))

    specs = RC.input_specs(cfg, shape)
    if shape.kind == "train":
        state = RT.abstract_state(cfg)
        return shards(state, RT.train_state_specs(state, sm, zero=cfg.zero)) \
            + shards(specs, RT.batch_specs(specs, sm))
    params = RM.abstract_params(cfg)
    total = shards(params, rparam_specs(params, sm, zero=cfg.serve_zero))
    if shape.kind == "prefill":
        return total + shards(specs, RT.batch_specs(specs, sm))
    tok = {"tokens": specs["tokens"]}
    return total + shards(tok, RT.batch_specs(tok, sm)) + 4 + shards(
        specs["cache"], RSV.cache_specs(specs["cache"], cfg, sm))


def _run_cells():
    for arch in TC.list_archs():
        for sname, shape in SHAPES.items():
            if TC.cell_status(TC.get_config(arch), shape) == "run":
                yield arch, sname


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("arch,shape_name", tuple(_run_cells()))
def test_production_argument_bytes_equal_reference(arch, shape_name,
                                                   multi_pod):
    """Every run cell on both production meshes."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    got = D.production_memory(TC.get_config(arch), SHAPES[shape_name], mesh)
    assert got["argument_bytes"] == reference_argument_bytes(
        arch, shape_name, multi_pod)
    assert got["alias_bytes"] <= got["output_bytes"]


# ---------------------------------------------------------------------------
# Every architecture traces on meta
# ---------------------------------------------------------------------------


def _other_cells():
    for arch in sorted(set(TC.list_archs()) - set(SMOKE_ARCHS)):
        for kind in KINDS:
            shape = ShapeConfig("x", 16, 1, kind)
            if TC.cell_status(TC.smoke_config(arch), shape) == "run":
                yield arch, kind


@pytest.mark.parametrize("arch,kind", tuple(_other_cells()))
def test_every_arch_traces_on_meta(arch, kind):
    """The smoke configs the flop test does not cover, at B=1, S=16: each
    kind its status allows traces with no storage, a roofline and a peak."""
    ana, memory = port_analysis(arch, kind, 1, 16)
    assert ana.flops > 0 and ana.launches > 0 and ana.bytes_accessed > 0
    assert memory["temp_bytes"] >= 0
    assert D.per_device_bytes(memory) == ana.peak_live_bytes
    rl = D.roofline(ana)
    assert rl["bottleneck"] in ("compute", "memory")
    if kind == "decode":  # the cache is updated in place
        assert memory["alias_bytes"] > 0


def test_meta_and_cpu_tensors_give_the_same_counts():
    """The analyzer's counts do not depend on the device: one real train
    step and one real decode step on the CPU against their meta traces."""
    from repro_torch.models import model as TM

    cfg = TC.smoke_config("gemma3-1b")
    gen = torch.Generator().manual_seed(0)
    state = TT.init_state(gen, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 16), generator=gen,
                         dtype=torch.int32)
    _, real = OA.analyze(TT.make_train_step(cfg), state,
                         {"tokens": toks, "labels": toks})
    meta, _ = port_analysis("gemma3-1b", "train", 1, 16)
    assert (real.flops, dict(real.ops), real.bytes_accessed) == \
        (meta.flops, dict(meta.ops), meta.bytes_accessed)
    params = TM.init_params(cfg, gen, "cpu")
    cache = TM.init_cache(cfg, 1, 16, "cpu")
    _, real = OA.analyze(TM.decode_step, params, toks[:, :1], 15, cache, cfg)
    meta, _ = port_analysis("gemma3-1b", "decode", 1, 16)
    assert (real.flops, dict(real.ops), real.bytes_accessed) == \
        (meta.flops, dict(meta.ops), meta.bytes_accessed)


# ---------------------------------------------------------------------------
# The analyzer on known chains
# ---------------------------------------------------------------------------


def test_analyzer_counts_a_known_chain():
    def chain(x, w):
        y = torch.mm(x, w)     # 2*4*16*8 FLOPs; reads 32+128, writes 64
        v = y.view(2, 32).t()  # views: nothing
        s = v.sum()            # reads 64, writes 1
        y.add_(1.0)            # reads and writes 64
        y.zero_()              # writes 64
        return s

    x, w = torch.ones(4, 8), torch.ones(8, 16)
    for dev in ("cpu", "meta"):
        _, ana = OA.analyze(chain, x.to(dev), w.to(dev))
        assert ana.flops == 2 * 4 * 16 * 8
        assert dict(ana.flops_by_dtype) == {"f32": 1024}
        assert dict(ana.ops) == {"mm": 1, "sum": 1, "add_": 1, "zero_": 1}
        assert ana.bytes_accessed == 4 * ((32 + 128 + 64) + (64 + 1)
                                          + 2 * 64 + 64)
        assert ana.peak_live_bytes == 4 * (32 + 128 + 64 + 1)


def test_analyzer_peak_follows_frees():
    def seq(x):
        a = x * 2
        b = a + 1  # x, a, b live
        del a
        c = b * 3  # x, b, c live
        del b
        return c.sum()

    for dev in ("cpu", "meta"):
        out, ana = OA.analyze(seq, torch.ones(1000, device=dev))
        assert ana.peak_live_bytes == 3 * 4000
        assert out.shape == ()
    x = torch.ones(8, dtype=torch.bfloat16, device="meta")
    _, ana = OA.analyze(lambda t: torch.bmm(t.view(1, 2, 4),
                                            t.view(1, 4, 2)), x)
    assert dict(ana.flops_by_dtype) == {"bf16": 2 * 2 * 2 * 4}


def test_roofline_prices_bf16_and_f32_apart():
    ana = OA.Analysis(flops=3e12, bytes_accessed=6.7e9)
    ana.flops_by_dtype.update({"bf16": 2e12, "f32": 1e12})
    rl = D.roofline(ana)
    assert rl["compute_s"] == 2e12 / PEAK_FLOPS_BF16 + 1e12 / PEAK_FLOPS_F32
    assert rl["memory_s"] == 6.7e9 / HBM_BW
    assert rl["collective_s"] == 0.0 and rl["bottleneck"] == "compute"
    assert "collective_tpu_s" not in rl
    # collectives are priced on the links their axes span
    ana.collective_bytes, ana.per_axes = 3e9, {"model": 1e9, "data": 2e9}
    with pytest.raises(ValueError):  # no mesh, no links to price them on
        D.roofline(ana)
    pod = D.roofline(ana, make_trace_mesh((16, 16)))
    assert pod["collective_s"] == 1e9 / IB_BW + 2e9 / IB_BW
    assert pod["bottleneck"] == "collective"
    cards = D.roofline(ana, make_trace_mesh((2, 2)))
    assert cards["collective_s"] == 1e9 / NVLINK_BW + 2e9 / NVLINK_BW
    node = D.roofline(ana, make_trace_mesh((2, 8)))
    assert node["collective_s"] == 1e9 / NVLINK_BW + 2e9 / IB_BW


def test_link_bw_by_node():
    """A group inside one node of 8 cards (rank // 8, row-major) rides
    NVLink, one across nodes InfiniBand: both axes of pod16x16 cross
    nodes, every group of four cards does not."""
    pod = make_trace_mesh((16, 16))
    assert LM.link_bw(pod, "model") == LM.link_bw(pod, "data") == IB_BW
    multi = make_trace_mesh((2, 16, 16), ("pod", "data", "model"))
    assert LM.link_bw(multi, "pod") == LM.link_bw(multi, ("pod", "data")) \
        == IB_BW
    for shape in ((2, 2), (4, 1), (1, 4)):
        for names in ("data", "model", ("data", "model")):
            assert LM.link_bw(make_trace_mesh(shape), names) == NVLINK_BW
    wide = make_trace_mesh((2, 8), rank=9)
    assert LM.group_ranks(wide, "model") == list(range(8, 16))
    assert LM.link_bw(wide, "model") == NVLINK_BW
    assert LM.link_bw(wide, "data") == IB_BW
    assert LM.link_bw(make_production_mesh(), "model") == IB_BW


def test_trace_mesh_counts_and_refuses():
    """A trace mesh's collectives give the outputs' shapes on meta and
    count the reference's wire bytes by kind and by axes; a tensor off
    meta is refused and not counted; one analyze reads the counts."""
    mesh = make_trace_mesh((2, 4), rank=5)
    assert mesh.coords == {"data": 1, "model": 1}
    x = torch.empty((4, 6), dtype=torch.bfloat16, device="meta")

    def step(x):
        y = mesh.all_gather(x, "model", 1)          # [4, 24]
        z = mesh.reduce_scatter(y, "data", 0)       # [2, 24]
        w = mesh.all_reduce(z.float(), ("data", "model"), "max")
        return mesh.shift(w, "model")

    out, ana = OA.analyze(step, x, mesh=mesh)
    assert out.shape == (2, 24) and out.device.type == "meta"
    n = 4 * 6 * 2
    assert ana.collective_calls == {"all_gather": 1, "reduce_scatter": 1,
                                    "all_reduce": 1, "ring_hop": 1}
    assert ana.per_collective == {
        "all_gather": 4 * n * 3 / 4, "reduce_scatter": 4 * n / 2,
        "all_reduce": 2 * (2 * 24 * 4) * 7 / 8, "ring_hop": 2 * 24 * 4}
    assert ana.per_axes == {"model": 4 * n * 3 / 4 + 2 * 24 * 4,
                            "data": 4 * n / 2,
                            "data+model": 2 * (2 * 24 * 4) * 7 / 8}
    assert ana.per_link == {"nvlink": ana.collective_bytes}
    assert ana.collective_count == 4
    calls = dict(mesh.calls)
    with pytest.raises(ValueError):
        mesh.all_reduce(torch.ones(3), "model")
    assert dict(mesh.calls) == calls


# ---------------------------------------------------------------------------
# Records, the CLI and the roofline table
# ---------------------------------------------------------------------------


def test_records_and_the_roofline_table(tmp_path, capsys):
    out = str(tmp_path)
    D.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--out", out])
    D.main(["--arch", "xlstm-350m", "--shape", "decode_32k", "--mesh",
            "pod16x16", "--out", out])
    D.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh",
            "pod16x16", "--out", out])
    hub = D.run_cell("hubert-xlarge", "decode_32k", "card", outdir=out,
                     verbose=False)
    assert hub["status"].startswith("skip")
    recs = TR.load_records(out)
    assert [(r["mesh"], r["arch"]) for r in recs] == \
        [("card", "xlstm-350m"), ("pod16x16", "gemma3-1b"),
         ("pod16x16", "xlstm-350m")]
    card, pod, ssm = recs
    for rec in (card, pod, ssm):
        assert set(rec) >= {"chips", "trace_s", "memory", "analysis",
                            "roofline", "model_flops_global",
                            "model_flops_per_chip", "useful_flop_ratio",
                            "fits"}
        m = rec["memory"]
        assert m["alias_bytes"] > 0  # the cache, updated in place
        assert rec["fits"] == (D.per_device_bytes(m) <= 80e9)
        assert rec["useful_flop_ratio"] == rec["model_flops_per_chip"] \
            / rec["analysis"]["flops"]
    assert D.per_device_bytes(card["memory"]) == \
        card["analysis"]["peak_live_bytes"]
    # rank 0's partitioned decode on pod16x16: its shards are the spec
    # tables' bytes, its collectives priced on InfiniBand
    mesh = make_production_mesh()
    assert pod["chips"] == 256
    assert pod["model_flops_per_chip"] == pod["model_flops_global"] / 256
    assert D.reference_argument_bytes(pod["memory"]) == D.production_memory(
        TC.get_config("gemma3-1b"), SHAPES["decode_32k"],
        mesh)["argument_bytes"]
    assert pod["memory"]["batch_bytes"] == 128 * 4  # every row, on each rank
    assert D.per_device_bytes(pod["memory"]) == \
        pod["analysis"]["peak_live_bytes"]
    assert pod["roofline"]["collective_s"] > 0
    assert pod["analysis"]["collective_count"] > 0
    assert set(pod["analysis"]["per_link"]) == {"ib"}
    # an SSM cell on a model axis: rank 0's partitioned decode (4 mLSTM
    # heads on model=16: q and k gathered), priced; its arguments less the
    # named state gap are the spec tables' bytes: the mLSTM normalizers
    # (a head on each group of 4 ranks, batch over data) and the sLSTM
    # states (by channel and batch) against the reference's rule, which
    # splits the batch dim over model
    assert ssm["chips"] == 256 and ssm["fits"]
    assert ssm["roofline"]["collective_s"] > 0
    assert ssm["analysis"]["collective_calls"]["all_gather"] > 0
    xcfg = TC.get_config("xlstm-350m")
    gap = D.state_gap(xcfg, SHAPES["decode_32k"], mesh)
    assert ssm["memory"]["state_gap_bytes"] == gap
    mixers = dict((f"slot{i:02d}", m)
                  for i, (m, _) in enumerate(xcfg.layer_pattern))
    assert {(mixers[k.split("/")[0]], k.split("/")[1]) for k in gap} == {
        ("mlstm", "n"), ("slstm", "c"), ("slstm", "n"), ("slstm", "m"),
        ("slstm", "h")}
    assert D.reference_argument_bytes(ssm["memory"]) - sum(gap.values()) \
        == D.production_memory(xcfg, SHAPES["decode_32k"],
                               mesh)["argument_bytes"]
    rows = {r[:2]: r for r in map(TR.row, recs)}
    assert rows[("pod16x16", "xlstm-350m")][5] == \
        f"{ssm['roofline']['collective_s']:.4f}"
    assert rows[("pod16x16", "gemma3-1b")][5] == \
        f"{pod['roofline']['collective_s']:.4f}"
    assert rows[("card", "xlstm-350m")][6] == card["roofline"]["bottleneck"]
    table = TR.as_markdown(recs)
    assert table.splitlines()[2].startswith("| card | xlstm-350m")
    s = TR.summarize(recs)
    assert s["cells_compiled"] == 3
    assert s["most_collective_bound"] == "gemma3-1bxdecode_32k"
    worst = min((card, pod, ssm), key=lambda r: r["useful_flop_ratio"])
    assert s["worst_useful_cell"] == f"{worst['arch']}x{worst['shape']}"
    assert {n: v for n, v, _ in brun.roofline_rows(out)} == \
        {f"roofline.{k}": v for k, v in s.items()}
    assert brun.roofline_rows(str(tmp_path / "none"))[0][:2] == \
        ("roofline.cells_compiled", 0)
    printed = capsys.readouterr().out
    assert "[card] xlstm-350m x decode_32k" in printed
    assert "[pod16x16] gemma3-1b x decode_32k" in printed
    assert json.loads(json.dumps(card)) == card
    assert json.loads(json.dumps(pod)) == pod


def test_explicit_mesh_and_bad_names():
    """``--mesh data=2,model=2`` traces rank 0 of the four-card mesh: its
    collectives ride NVLink; a bad mesh name fails before any cell."""
    rec = D.run_cell("gemma3-1b", "decode_32k", "data=2,model=2",
                     verbose=False)
    assert rec["chips"] == 4
    assert set(rec["analysis"]["per_link"]) == {"nvlink"}
    assert rec["roofline"]["collective_s"] == sum(
        b / NVLINK_BW for b in rec["analysis"]["per_axes"].values())
    for bad in ("pod4x4", "data=2,rows=2", "data"):
        with pytest.raises(ValueError):
            D.make_mesh(bad)
