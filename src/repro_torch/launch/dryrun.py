"""Dry run: trace every (architecture x input shape) cell of the port and
extract its roofline on the card.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 or 512 fake CPU devices and reads XLA's memory and HLO
analyses; the port traces each cell's step on the ``meta`` device (shapes
and dtypes, no storage: a kimi-k2 train step allocates nothing) under the
op-level analyzer (``launch/opanalysis.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh card --out DIR

``--mesh`` picks where a cell is placed: ``card`` (one H100, the port's
program) or the reference's production meshes ``pod16x16`` and
``pod2x16x16``; ``--all`` without ``--mesh`` writes all three.  Several
cells trace in up to four processes.

Per cell on ``card`` this records:
    memory      argument / output / alias bytes of the step (decode's cache
                is updated in place: it is aliased) and temp bytes: the
                trace's peak live bytes less the arguments and the fresh
                outputs, so argument + temp + output - alias is the peak
    analysis    the analyzer's FLOPs (by dtype), bytes, launches and peak
    roofline    compute / memory / collective seconds + bottleneck
    model_flops_* and useful_flop_ratio, trace_s (in place of compile_s),
                and ``fits``: the peak within the card's 80 GB

On a production mesh the port has no partitioned program (it runs on one
card), so a record holds only the per-device argument, output and alias
bytes of the spec tables -- each dim divided by the sizes of its mesh axes,
as the reference's ``NamedSharding`` divides it -- with ``roofline: null``.
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
                                     PEAK_FLOPS_F32, make_production_mesh,
                                     mesh_chips)
from repro_torch.models import model as M
from repro_torch.models import serve as SV
from repro_torch.models import train as T
from repro_torch.models.config import SHAPES
from repro_torch.models.sharding import param_specs

MESHES = ("card", "pod16x16", "pod2x16x16")

PRODUCTION_NOTE = ("no partitioned program in the port: per-device bytes of "
                   "the spec tables only; flops, bytes and collective wire "
                   "bytes need a partitioned step")


def build_cell(cfg, shape, mesh=None):
    """-> ``(fn, args)``: the cell's step and its arguments on the ``meta``
    device.  A decode cell's ``pos`` is the Python int ``seq_len - 1`` (the
    step reads it on the host).  ``mesh`` is unused: the port's step is one
    program on one card, whatever the mesh."""
    if shape.kind == "train":
        return T.make_train_step(cfg), (T.abstract_state(cfg),
                                        configs.input_specs(cfg, shape))
    params = M.abstract_params(cfg)
    if shape.kind == "prefill":
        return SV.make_prefill_step(cfg), (params,
                                           configs.input_specs(cfg, shape))
    B, S = shape.global_batch, shape.seq_len
    tokens = configs.input_specs(cfg, shape)["tokens"]
    return SV.make_decode_step(cfg), (params, tokens, S - 1,
                                      M.abstract_cache(cfg, B, S))


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS per the brief: 6*N_active*D train, 2*N_active*D
    inference (D = tokens processed by the step)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline(analysis: opanalysis.Analysis, chips: int = 1):
    """Three terms in seconds on one card, and the bottleneck.

    Compute is where the card's model departs from the reference's single
    bf16 peak: ``flops_by_dtype["bf16"] / PEAK_FLOPS_BF16 +
    flops_by_dtype["f32"] / PEAK_FLOPS_F32``.  The port's f32 products --
    the attention's scores and values, the SSM mixers' scans, the MoE
    router -- run on the CUDA cores with TF32 off (``cutlass_80_simt_sgemm``
    in the training profile), not on the tensor cores; a product of any
    other dtype is priced at the f32 rate.  The reference's
    ``collective_tpu_s`` (its f32 collectives re-priced as bf16 on a TPU's
    links) has no counterpart: the port runs no collective on one card
    and its model has no link bandwidth, so ``collective_s`` is 0 and a
    non-zero ``collective_bytes`` is refused."""
    if chips != 1 or analysis.collective_bytes:
        raise ValueError("the card's roofline covers one card and no "
                         "collective")
    by = analysis.flops_by_dtype
    compute_s = by.get("bf16", 0) / PEAK_FLOPS_BF16 + sum(
        f for dt, f in by.items() if dt != "bf16") / PEAK_FLOPS_F32
    terms = {"compute_s": compute_s,
             "memory_s": analysis.bytes_accessed / HBM_BW,
             "collective_s": 0.0}
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


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shard of every tensor of ``tree`` under the
    spec tree ``specs`` (a spec per leaf: ``None``, an axis name or a tuple
    of names per dim; missing trailing dims replicated)."""
    sizes = dict(mesh.shape)
    total = 0
    for path, t in opanalysis.tree_leaves(tree):
        spec = _spec_at(specs, path)
        n = 1
        for i, dim in enumerate(t.shape):
            axes = spec[i] if i < len(spec) else None
            names = (axes,) if isinstance(axes, str) else (axes or ())
            div = math.prod(sizes[a] for a in names)
            if dim % div:
                raise ValueError(f"{path}: dim {dim} over {names}")
            n *= dim // div
        total += n * t.element_size()
    return total


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
    cache_b = shard_bytes(cache, SV.cache_specs(cache, cfg, mesh), mesh)
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
    return {"argument_bytes": argument, "output_bytes": output,
            "alias_bytes": alias,
            "temp_bytes": analysis.peak_live_bytes - argument
            - (output - alias)}


def per_device_bytes(memory) -> int:
    return (memory["argument_bytes"] + (memory["temp_bytes"] or 0)
            + memory["output_bytes"] - memory["alias_bytes"])


def trace_cell(cfg, shape):
    """Trace one cell on ``meta`` -> (record fields, Analysis)."""
    fn, args = build_cell(cfg, shape)
    t0 = time.perf_counter()
    result, ana = opanalysis.analyze(fn, *args)
    trace_s = time.perf_counter() - t0
    mf = model_flops(cfg, shape)
    return {
        "chips": 1,
        "trace_s": round(trace_s, 2),
        "memory": card_memory(args, result, ana),
        "analysis": ana.to_dict(),
        "roofline": roofline(ana, 1),
        "model_flops_global": mf,
        "model_flops_per_chip": mf,
        "useful_flop_ratio": mf / ana.flops if ana.flops else None,
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
    if mesh_name == "card":
        rec.update(trace_cell(cfg, shape)[0])
        rec["fits"] = per_device_bytes(rec["memory"]) <= HBM_BYTES
    else:
        mesh = make_production_mesh(multi_pod=mesh_name == "pod2x16x16")
        rec.update({"chips": mesh_chips(mesh),
                    "memory": production_memory(cfg, shape, mesh),
                    "roofline": None, "note": PRODUCTION_NOTE})
    if verbose:
        gb = per_device_bytes(rec["memory"]) / 1e9
        rl = rec["roofline"]
        line = f"[{mesh_name}] {arch} x {shape_name}: mem/dev={gb:.2f}GB"
        if rl:
            u = rec["useful_flop_ratio"]
            line += (f" trace={rec['trace_s']:.1f}s "
                     f"compute={rl['compute_s']:.4f}s "
                     f"memory={rl['memory_s']:.4f}s -> {rl['bottleneck']} "
                     f"useful={u and round(u, 3)}")
        print(line, flush=True)
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
    ap.add_argument("--mesh", choices=MESHES + ("all",), default=None,
                    help="card (default for one arch), a production mesh, "
                         "or all (default with --all)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--continue-on-error", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    mesh = args.mesh or ("all" if args.all else "card")
    meshes = MESHES if mesh == "all" else (mesh,)
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
