"""Dry run: trace every (architecture x input shape) cell of the port and
extract its roofline on the card, alone or as one rank of a mesh.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 or 512 fake CPU devices and reads XLA's memory and HLO
analyses; the port traces each cell's step on the ``meta`` device (shapes
and dtypes, no storage: a kimi-k2 train step allocates nothing) under the
op-level analyzer (``launch/opanalysis.py``).  On a mesh it traces rank
0's partitioned step (``models.train.make_train_step(mesh=)``,
``models.serve.make_prefill_step(mesh=)`` / ``make_decode_step(mesh=)``)
on a trace mesh (``launch.mesh.make_trace_mesh``: the collectives counted,
none issued): every rank of the SPMD step issues the same calls, so rank
0's trace is the per-device program.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod16x16 --out DIR
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --mesh data=2,model=2

``--mesh`` picks where a cell is placed: ``card`` (one H100), the
reference's production meshes ``pod16x16`` and ``pod2x16x16``, or an
explicit shape (``data=2,model=2``: axis names from pod, data and model);
``--all`` without ``--mesh`` writes card and both production meshes.
Several cells trace in up to four processes.

Per cell this records:
    memory      argument / output / alias bytes of the step (decode's cache
                is updated in place: it is aliased) and temp bytes: the
                trace's peak live bytes less the arguments and the fresh
                outputs, so argument + temp + output - alias is the peak.
                On a mesh the arguments are this rank's shards and the
                whole batch, which every rank of the port's step holds;
                ``batch_bytes`` / ``batch_shard_bytes`` are that batch's
                bytes and the reference's input of it (this rank's rows
                under ``batch_specs``, decode's ``pos`` as an int32).  The
                arguments less the one plus the other must equal
                ``production_memory``'s
    analysis    the analyzer's FLOPs (by dtype), bytes, launches, peak and
                the collectives' calls and wire bytes (by kind, axes, link)
    roofline    compute / memory / collective seconds + bottleneck
    model_flops_* and useful_flop_ratio (per chip), trace_s (in place of
                compile_s), and ``fits``: the peak within the card's 80 GB

A decode cell's SSM states sit where the mixers' model-axis split keeps
them (``serve.cache_specs``), which is not where the reference's cache
rule puts them (``serve.reference_cache_specs``, the spec tables'):
``memory["state_gap_bytes"]`` names each cache leaf whose per-rank bytes
differ and by how much, and the arguments less that gap must equal
``production_memory``'s.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor

import torch

from repro_torch import configs
from repro_torch.launch import opanalysis
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32, link_bw,
                                     make_trace_mesh, mesh_chips)
from repro_torch.models import model as M
from repro_torch.models import serve as SV
from repro_torch.models import train as T
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import block_shape, param_specs

MESHES = ("card", "pod16x16", "pod2x16x16")


def make_mesh(name):
    """A trace mesh (rank 0) for ``pod16x16``, ``pod2x16x16`` or an
    explicit ``axis=size,...`` shape."""
    if name in ("pod16x16", "pod2x16x16"):
        multi = name == "pod2x16x16"
        return make_trace_mesh((2, 16, 16) if multi else (16, 16),
                               ("pod", "data", "model") if multi
                               else ("data", "model"))
    axes = [part.split("=") for part in name.split(",")]
    if not axes or any(len(a) != 2 or a[0] not in ("pod", "data", "model")
                       for a in axes):
        raise ValueError(f"--mesh {name!r}: card, pod16x16, pod2x16x16 or "
                         "axis=size,... over pod, data, model")
    return make_trace_mesh([int(n) for _, n in axes], [a for a, _ in axes])


def build_cell(cfg, shape, mesh=None):
    """-> ``(fn, args)``: the cell's step and its arguments on the ``meta``
    device.  A decode cell's ``pos`` is the Python int ``seq_len - 1`` (the
    step reads it on the host).  With ``mesh`` (an ``LmMesh``: a trace
    mesh) the step is that rank's partitioned step and the arguments its
    shards: the train state by ``train.shard_state``, parameters by
    ``serve.shard_params``, the cache by ``serve.shard_cache``, and the
    batch whole, as the mesh steps take it."""
    S = shape.seq_len
    specs = configs.input_specs(cfg, shape)
    if shape.kind == "train":
        state = T.abstract_state(cfg)
        if mesh is None:
            return T.make_train_step(cfg), (state, specs)
        return T.make_train_step(cfg, mesh=mesh), (
            T.shard_state(state, cfg, mesh), specs)
    params = M.abstract_params(cfg)
    if mesh is not None:
        params = SV.shard_params(params, cfg, mesh)
    if shape.kind == "prefill":
        return SV.make_prefill_step(cfg, mesh), (params, specs)
    tokens, cache = specs["tokens"], specs["cache"]
    if mesh is None:
        return SV.make_decode_step(cfg), (params, tokens, S - 1, cache)
    return SV.make_decode_step(cfg, mesh, S), (
        params, tokens, S - 1, SV.shard_cache(cache, cfg, mesh))


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS per the brief: 6*N_active*D train, 2*N_active*D
    inference (D = tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline(analysis: opanalysis.Analysis, mesh=None):
    """Three terms in seconds on one card (of ``mesh``), and the
    bottleneck.

    Compute is where the card's model departs from the reference's single
    bf16 peak: ``flops_by_dtype["bf16"] / PEAK_FLOPS_BF16 +
    flops_by_dtype["f32"] / PEAK_FLOPS_F32``.  The port's f32 products --
    the attention's scores and values, the SSM mixers' scans, the MoE
    router -- run on the CUDA cores with TF32 off (``cutlass_80_simt_sgemm``
    in the training profile), not on the tensor cores; a product of any
    other dtype is priced at the f32 rate.  ``collective_s`` sums each
    call's wire bytes over the link its axes span (``launch.mesh.link_bw``:
    NVLink inside a node of 8 cards, InfiniBand across nodes), from the
    analysis's ``per_axes``; without a mesh a collective cannot be priced
    and is refused.  The reference's ``collective_tpu_s`` (its f32
    collectives re-priced as bf16 on a TPU's links) has no counterpart:
    the port's collectives move the dtypes the step computes in."""
    if mesh is None and analysis.collective_bytes:
        raise ValueError("collectives are priced on a mesh's links: pass "
                         "the mesh")
    by = analysis.flops_by_dtype
    compute_s = by.get("bf16", 0) / PEAK_FLOPS_BF16 + sum(
        f for dt, f in by.items() if dt != "bf16") / PEAK_FLOPS_F32
    collective_s = sum(b / link_bw(mesh, names.split("+"))
                       for names, b in analysis.per_axes.items())
    terms = {"compute_s": compute_s,
             "memory_s": analysis.bytes_accessed / HBM_BW,
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


# ---------------------------------------------------------------------------
# Per-device bytes from the spec tables (production meshes)
# ---------------------------------------------------------------------------


def _spec_at(specs, path):
    for key in path:
        specs = getattr(specs, key) if isinstance(key, str) and \
            not isinstance(specs, dict) else specs[key]
    return specs


def _leaf_bytes(t, spec, mesh) -> int:
    return math.prod(block_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shard of every tensor of ``tree`` under the
    spec tree ``specs`` (a spec per leaf: ``None``, an axis name or a tuple
    of names per dim; missing trailing dims replicated)."""
    return sum(_leaf_bytes(t, _spec_at(specs, path), mesh)
               for path, t in opanalysis.tree_leaves(tree))


def state_gap(cfg, shape, mesh) -> dict:
    """``{cache leaf: per-rank bytes where the mixers' split keeps it less
    the spec tables'}`` for every decode-cache leaf where the two differ
    (``serve.cache_specs`` against ``serve.reference_cache_specs``); empty
    for a train or prefill cell."""
    if shape.kind != "decode":
        return {}
    cache = M.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    port = SV.cache_specs(cache, cfg, mesh)
    ref = SV.reference_cache_specs(cache, cfg, mesh)
    out = {}
    for path, t in opanalysis.tree_leaves(cache):
        gap = _leaf_bytes(t, _spec_at(port, path), mesh) \
            - _leaf_bytes(t, _spec_at(ref, path), mesh)
        if gap:
            out["/".join(map(str, path))] = gap
    return out


def production_memory(cfg, shape, mesh) -> dict:
    """Per-device argument, output and alias bytes of the cell's step as the
    reference places it on ``mesh`` (its ``build_cell``'s shardings).
    Outputs without a spec (train metrics, prefill and decode logits) are
    counted as the batch's sharding gives them; the donated train state and
    decode cache are aliased."""
    specs = configs.input_specs(cfg, shape)
    B, V = shape.global_batch, cfg.vocab_size
    logits = {"logits": torch.empty((B, 1, V), device="meta")}
    if shape.kind == "train":
        state = T.abstract_state(cfg)
        state_b = shard_bytes(state, T.train_state_specs(state, mesh,
                                                         zero=cfg.zero), mesh)
        args = state_b + shard_bytes(specs, T.batch_specs(specs, mesh), mesh)
        return {"argument_bytes": args, "output_bytes": state_b + 4 * 4,
                "alias_bytes": state_b, "temp_bytes": None}
    params = M.params_to_reference(M.abstract_params(cfg), cfg)
    params_b = shard_bytes(params, param_specs(params, mesh,
                                               zero=cfg.serve_zero), mesh)
    out_b = shard_bytes(logits, T.batch_specs(logits, mesh), mesh)
    if shape.kind == "prefill":
        return {"argument_bytes": params_b + shard_bytes(
                    specs, T.batch_specs(specs, mesh), mesh),
                "output_bytes": out_b, "alias_bytes": 0, "temp_bytes": None}
    cache = M.abstract_cache(cfg, B, shape.seq_len)
    cache_b = shard_bytes(cache, SV.reference_cache_specs(cache, cfg, mesh),
                          mesh)
    tok = {"tokens": specs["tokens"]}
    args = params_b + shard_bytes(tok, T.batch_specs(tok, mesh), mesh) \
        + 4 + cache_b  # pos: a replicated int32 scalar
    return {"argument_bytes": args, "output_bytes": out_b + cache_b,
            "alias_bytes": cache_b, "temp_bytes": None}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def card_memory(args, result, analysis) -> dict:
    """Argument, output, alias and temp bytes of one traced step."""
    arg_keys = opanalysis.storages(args)
    out_keys = opanalysis.storages(result)
    argument = sum(arg_keys.values())
    output = sum(out_keys.values())
    alias = sum(n for k, n in out_keys.items() if k in arg_keys)
    memory = {"argument_bytes": argument, "output_bytes": output,
              "alias_bytes": alias,
              "temp_bytes": analysis.peak_live_bytes - argument
              - (output - alias)}
    return memory


def reference_argument_bytes(memory) -> int:
    """A mesh record's argument bytes with the whole batch replaced by the
    reference's input of it (``batch_bytes``)."""
    return (memory["argument_bytes"] - memory["batch_bytes"]
            + memory["batch_shard_bytes"])


def per_device_bytes(memory) -> int:
    return (memory["argument_bytes"] + (memory["temp_bytes"] or 0)
            + memory["output_bytes"] - memory["alias_bytes"])


def batch_bytes(shape, args, mesh) -> dict:
    """The bytes of a mesh step's whole batch, which every rank holds
    (decode's ``pos`` is a Python int), and of the reference's input of
    it: this rank's rows under ``batch_specs``, plus decode's ``pos`` as a
    replicated int32 scalar."""
    batch, pos = ({"tokens": args[1]}, 4) if shape.kind == "decode" \
        else (args[1], 0)
    return {"batch_bytes": sum(opanalysis.storages(batch).values()),
            "batch_shard_bytes": shard_bytes(
                batch, T.batch_specs(batch, mesh), mesh) + pos}


def trace_cell(cfg, shape, mesh=None):
    """Trace one cell on ``meta`` (rank 0's step on ``mesh``) -> (record
    fields, Analysis)."""
    fn, args = build_cell(cfg, shape, mesh)
    t0 = time.perf_counter()
    result, ana = opanalysis.analyze(fn, *args, mesh=mesh)
    trace_s = time.perf_counter() - t0
    chips = 1 if mesh is None else mesh_chips(mesh)
    mf = model_flops(cfg, shape)
    memory = card_memory(args, result, ana)
    if mesh is not None:
        memory.update(batch_bytes(shape, args, mesh))
    return {
        "chips": chips,
        "trace_s": round(trace_s, 2),
        "memory": memory,
        "analysis": ana.to_dict(),
        "roofline": roofline(ana, mesh),
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flop_ratio": mf / chips / ana.flops if ana.flops else None,
    }, ana


def run_cell(arch: str, shape_name: str, mesh_name: str = "card",
             outdir: str | None = None, verbose: bool = True) -> dict:
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    status = configs.cell_status(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "status": status}
    if status != "run":
        if verbose:
            print(f"[{mesh_name}] {arch} x {shape_name}: SKIP ({status})")
        return rec
    mesh = None if mesh_name == "card" else make_mesh(mesh_name)
    rec.update(trace_cell(cfg, shape, mesh)[0])
    rec["fits"] = per_device_bytes(rec["memory"]) <= HBM_BYTES
    if mesh is not None:
        gap = state_gap(cfg, shape, mesh)
        rec["memory"]["state_gap_bytes"] = gap
        want = production_memory(cfg, shape, mesh)["argument_bytes"]
        got = reference_argument_bytes(rec["memory"]) - sum(gap.values())
        if got != want:
            raise AssertionError(
                f"{arch} x {shape_name} on {mesh_name}: the traced step's "
                "argument bytes with the batch as the reference's, less "
                f"the state gap, {got} != the spec tables' {want}")
    if verbose:
        gb = per_device_bytes(rec["memory"]) / 1e9
        rl = rec["roofline"]
        u = rec["useful_flop_ratio"]
        print(f"[{mesh_name}] {arch} x {shape_name}: mem/dev={gb:.2f}GB "
              f"trace={rec['trace_s']:.1f}s compute={rl['compute_s']:.4f}s "
              f"memory={rl['memory_s']:.4f}s "
              f"collective={rl['collective_s']:.4f}s "
              f"-> {rl['bottleneck']} useful={u and round(u, 3)}",
              flush=True)
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"{mesh_name}__{arch}__{shape_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _run_cell_reporting(cell):
    """``run_cell(*cell)`` -> None, or the error's traceback."""
    try:
        run_cell(*cell)
    except Exception:  # noqa: BLE001 -- reported by main
        return traceback.format_exc()
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id (or --all)")
    ap.add_argument("--shape", default=None,
                    help="shape cell (default: all four)")
    ap.add_argument("--all", action="store_true", help="every arch x shape")
    ap.add_argument("--mesh", default=None,
                    help="card (default for one arch), pod16x16, "
                         "pod2x16x16, axis=size,... (data=2,model=2), or "
                         "all (default with --all: card and both pods)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    mesh = args.mesh or ("all" if args.all else "card")
    meshes = MESHES if mesh == "all" else (mesh,)
    for name in meshes:
        if name != "card":
            make_mesh(name)  # a bad name fails before any cell
    cells = [(arch, shape, mesh_name, args.out) for mesh_name in meshes
             for arch in archs for shape in shapes]

    # cells trace in up to 4 processes: a full-size cell's trace is
    # single-threaded Python (meta kernels, the SSM mixers' step loops)
    workers = min(4, os.cpu_count() or 1, len(cells))
    failures = []
    t0 = time.perf_counter()
    with (ProcessPoolExecutor(workers) if workers > 1
          else contextlib.nullcontext()) as pool:
        errors = (pool.map if pool else map)(_run_cell_reporting, cells)
        for cell, err in zip(cells, errors):
            if err:
                failures.append(cell[:3])
                print(f"FAIL {cell[0]} x {cell[1]} mesh={cell[2]}:\n{err}",
                      flush=True)
                if not args.continue_on_error:
                    if pool:
                        pool.shutdown(cancel_futures=True)
                    break
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
        raise SystemExit(1)
    print(f"\nall requested cells traced OK in "
          f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
