#!/usr/bin/env python3
"""The LM across the cards of one machine: the sharded train step, the
expert-parallel MoE block, ring attention and ``compressed_psum`` on
W = min(cards, 4) NCCL ranks, each against one card.

    python3 scripts/torch_lm_mesh_cards.py [--steps 4]
    python3 scripts/torch_lm_mesh_cards.py --smoke   # CPU, 4 gloo ranks

First, on card 0 alone: gemma3-1b at full width and depth, B=8, S=1024,
``steps`` + 2 train steps from seed 0 (the one-card step), and the same
``steps`` at ``microbatches=2`` (the one-card step's own noise floor);
jamba-1.5-large's MoE block at full width (E=16, d=8192,
``moe_d_ff=24576``, top 2, its published capacity factor; B=8, S=512)
through ``moe_fwd_dense``, whole and on each half of the batch; gemma3-1b's
global attention block with f32 weights at S=8192 through
``attention_fwd`` (chunked attention), forward and gradient.  Then W ranks
(``repro_torch.core.mesh.spawn``), one per card:

  * gemma3-1b on (2, 2) and (W, 1) ``LmMesh``es: ``steps`` steps from
    seed 0 (``init_state(mesh=)``, ``make_train_step(mesh=)``), each
    step's loss against the one card's, the parameters after them (max
    |delta| / max |param| per leaf), each step's host-clock ms (all ranks
    lined up before it) and tokens/s, each card's peak memory, and the
    NCCL calls and bytes of one step by kind (``LmMesh.calls`` /
    ``.bytes``, the ring model); then a save on (2, 2) (gathered, rank 0
    writes), ``remesh_restore`` onto (W, 1) -- every leaf bit for bit the
    saved one -- and two more steps against the one card's;
  * the MoE block on (1, W), against the one card's dense call: routing
    ids and keep masks bit-equal, the output within 1e-2 of max |ref|
    and each row's RMS error within 1e-2 of its RMS; on (2, W/2) against
    the dense call on each data shard's rows; ms of each;
  * ``ring_attention_block`` over model=W at S=8192 against the chunked
    attention: output and every gradient within 1e-5 of its max; ms;
  * ``compressed_psum`` over the W ranks on a 64M-float tensor each: its
    error against the exact sum over the reference's ratio scale (max |x|
    / 127 * W), its wire bytes and ms against an f32 ``all_reduce``.

Prints one JSON line per part, then the card's name and power limit.
Exits non-zero with fewer than two cards (without ``--smoke``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def emit(obj):
    print(json.dumps(obj, default=str), flush=True)


def _sizes(smoke):
    """(gemma config, B, S, jamba MoE config, MoE B, MoE S, ring S,
    compress n)."""
    from repro_torch import configs

    pick = configs.smoke_config if smoke else configs.get_config
    if smoke:
        return (pick("gemma3-1b"), 4, 64, pick("jamba-1.5-large-398b"), 4,
                64, 256, 1 << 16)
    return (pick("gemma3-1b"), 8, 1024, pick("jamba-1.5-large-398b"), 8,
            512, 8192, 1 << 26)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()) / \
        max(float(b.float().abs().max()), 1e-30)


def _row_rms(got, want):
    """The worst row's RMS error over its RMS (rows: every dim but the
    last)."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    err = (g - w).pow(2).mean(-1).sqrt()
    return float((err / w.pow(2).mean(-1).sqrt().clamp(min=1e-30)).max())


def _params_cpu(params):
    from repro_torch.checkpoint.store import _key, _leaves

    return {_key(p): t.detach().to("cpu", copy=True)
            for p, t in _leaves(params)}


def _param_delta(got, want):
    """max over leaves of max |got - want| / max |want|."""
    worst = (0.0, None)
    for k, w in want.items():
        worst = max(worst, (_rel(got[k], w), k))
    return {"max_rel": worst[0], "leaf": worst[1]}


# ---------------------------------------------------------------------------
# The one card (the parent process, card 0)
# ---------------------------------------------------------------------------


def _gemma_steps(cfg, B, S, steps, dev, mesh=None, microbatches=1,
                 line_up=None):
    """``steps`` steps from seed 0 -> (state, per-step metrics, per-step
    ms, the calls and bytes of the last step)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import train as T

    opt = T.make_optimizer(peak_lr=1e-3, warmup=2, total=steps + 2)
    state = T.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                         opt, dev, mesh=mesh)
    step = T.make_train_step(cfg, opt, microbatches=microbatches, mesh=mesh)
    pipe = SyntheticLM(cfg.vocab_size, B, S, seed=0, device=dev)
    metrics, ms, calls = [], [], {}
    for s in range(steps):
        batch = pipe.batch_at(s)
        _sync(dev)
        if line_up:
            line_up()
        if mesh is not None:
            mesh.reset_calls()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        loss = m["loss"].item()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({"loss": loss, "grad_norm": float(m["grad_norm"])})
        if mesh is not None:
            calls = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
    return state, metrics, ms, calls, opt, pipe


def one_card(args, dev):
    """The one-card side of every comparison; tensors kept on the host."""
    from repro_torch.launch import mesh as LM
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import train as T

    cfg, B, S, mcfg, mB, mS, rS, _ = _sizes(args.smoke)
    out = {}
    t0 = time.perf_counter()
    state, metrics, ms, _, opt, pipe = _gemma_steps(cfg, B, S, args.steps,
                                                    dev)
    out["params"] = _params_cpu(state.params)
    step = T.make_train_step(cfg, opt)
    for s in (args.steps, args.steps + 1):  # the two after the restore
        state, m = step(state, pipe.batch_at(s))
        metrics.append({"loss": m["loss"].item(),
                        "grad_norm": float(m["grad_norm"])})
    out["params_after"] = _params_cpu(state.params)
    del state
    mb, mb_metrics, _, _, _, _ = _gemma_steps(cfg, B, S, args.steps, dev,
                                              microbatches=2)
    floor = {"loss_abs": max(abs(a["loss"] - b["loss"]) for a, b in
                             zip(mb_metrics, metrics)),
             "params": _param_delta(_params_cpu(mb.params), out["params"])}
    del mb
    _empty(dev)
    out["gemma"] = {"metrics": metrics, "step_ms": ms,
                    "tokens_per_s": B * S / (sorted(ms[1:])[
                        len(ms[1:]) // 2] / 1e3),
                    "noise_floor_microbatches_2": floor,
                    "seconds": time.perf_counter() - t0}
    emit({"one_card": "gemma3-1b", **out["gemma"]})

    # the MoE block, whole and per half of the batch
    t0 = time.perf_counter()
    p, x = _moe_inputs(mcfg, mB, mS, dev)
    with torch.no_grad(), _recording() as rec:
        want, _ = MOE.moe_fwd_dense(p, x, mcfg)
    out["moe"] = {"out": want.cpu(), "ids": rec["ids"][0].reshape(-1).cpu(),
                  "keep": rec["keep"][0].cpu()}
    with torch.no_grad():
        out["moe"]["halves"] = torch.cat(
            [MOE.moe_fwd_dense(p, x[i * mB // 2:(i + 1) * mB // 2], mcfg)[0]
             for i in range(2)]).cpu()
    out["moe"]["ms"] = _ms(lambda: MOE.moe_fwd_dense(p, x, mcfg), dev)
    del p, x, want
    _empty(dev)
    emit({"one_card": "moe_block", "ms": out["moe"]["ms"],
          "seconds": time.perf_counter() - t0})

    # the global attention block, f32, chunked
    t0 = time.perf_counter()
    p, x, cot = _ring_inputs(cfg, rS, dev)
    pos = torch.arange(rS, dtype=torch.int32, device=dev)
    mixer = "attn"
    o = L.attention_fwd(p, x, pos, cfg, mixer)[0]
    grads = torch.autograd.grad(o, [x, *p.values()], cot)
    out["ring"] = {"out": o.detach().cpu(),
                   "grads": [g.cpu() for g in grads],
                   "ms": _ms(lambda: L.attention_fwd(p, x, pos, cfg, mixer),
                             dev, grad=False)}
    del p, x, cot, o, grads
    _empty(dev)
    emit({"one_card": "attention", "ms": out["ring"]["ms"],
          "seconds": time.perf_counter() - t0})
    return out


def _empty(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _ms(fn, dev, reps=3, grad=False):
    """Median host-clock ms of ``reps`` calls after a warm one."""
    with torch.set_grad_enabled(grad):
        fn()
        times = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def _moe_inputs(cfg, B, S, dev):
    from repro_torch.models import moe as MOE

    gen = torch.Generator(device=dev).manual_seed(21)
    p = MOE.init_moe(cfg, gen, dev)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev) \
        .to(torch.bfloat16)
    return p, x


def _ring_inputs(cfg, S, dev):
    from repro_torch.models import layers as L

    gen = torch.Generator(device=dev).manual_seed(22)
    p = {k: v.float().requires_grad_()
         for k, v in L.init_attention(cfg, gen, dev).items()}
    x = torch.randn((1, S, cfg.d_model), generator=gen,
                    device=dev).requires_grad_()
    cot = torch.randn((1, S, cfg.d_model), generator=gen, device=dev)
    return p, x, cot


class _recording:
    """Record ``_route``'s top ids and ``dispatch_plan``'s keep masks."""

    def __enter__(self):
        from repro_torch.models import moe as MOE

        self.rec = {"ids": [], "keep": []}
        self.route, self.plan = MOE._route, MOE.dispatch_plan

        def route(*a):
            got = self.route(*a)
            self.rec["ids"].append(got[1])
            return got

        def plan(*a):
            got = self.plan(*a)
            self.rec["keep"].append(got[1])
            return got

        MOE._route, MOE.dispatch_plan = route, plan
        return self.rec

    def __exit__(self, *exc):
        from repro_torch.models import moe as MOE

        MOE._route, MOE.dispatch_plan = self.route, self.plan


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _rank(pe_mesh, smoke, steps, store):
    """One rank: every mesh part; rank 0 returns the results."""
    from repro_torch.launch import mesh as LM

    dev = pe_mesh.device
    W = pe_mesh.size
    line_up = lambda: (_sync(dev), pe_mesh.vote(torch.ones(1, device=dev)))
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = LM.make_lm_mesh(shape, device=dev.type)
        return meshes[shape]

    out = {"gemma": _rank_gemma(mesh_of, W, smoke, steps, store, dev,
                                line_up)}
    out["moe"] = _rank_moe(mesh_of, W, smoke, dev, line_up)
    out["ring"] = _rank_ring(mesh_of((1, W)), smoke, dev)
    out["compress"] = _rank_compress(LM.make_lm_mesh((W,), ("dp",),
                                                     dev.type), smoke, dev)
    return out


def _gather_peaks(mesh, dev):
    t = torch.tensor([_peak(dev)], dtype=torch.int64, device=dev)
    return [int(v) for v in mesh.all_gather(t, mesh.axis_names).tolist()]


def _rank_gemma(mesh_of, W, smoke, steps, store, dev, line_up):
    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.launch.elastic import remesh_restore
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    cfg, B, S = _sizes(smoke)[:3]
    out = {}
    for shape in ((2, W // 2), (W, 1)):
        mesh = mesh_of(shape)
        _empty(dev)
        _peak_reset(dev)
        state, metrics, ms, calls, opt, pipe = _gemma_steps(
            cfg, B, S, steps, dev, mesh=mesh, line_up=line_up)
        specs = T.state_specs(cfg, mesh, opt)
        params = SH.gather_tree(state.params, specs.params, mesh)
        res = {"metrics": metrics, "step_ms": ms, "last_step": calls,
               "peak_bytes_per_card": _gather_peaks(mesh, dev),
               "params": _params_cpu(params) if mesh.rank == 0 else None}
        del params
        if shape == (2, W // 2):
            t0 = time.perf_counter()
            save_checkpoint(store, steps, state, keep=1, mesh=mesh,
                            specs=specs)
            res["save_s"] = time.perf_counter() - t0
            saved = T.gather_state(state, cfg, mesh, opt)
            saved = _params_cpu(saved) if mesh.rank == 0 else None
        del state
        out[shape] = res
    # restore onto (W, 1) and two more steps
    new = mesh_of((W, 1))
    _empty(dev)
    t0 = time.perf_counter()
    state, at = remesh_restore(store, cfg, new, optimizer=opt)
    restore_s = time.perf_counter() - t0
    got = T.gather_state(state, cfg, new, opt)
    equal = None
    if new.rank == 0:
        got = _params_cpu(got)
        equal = set(got) == set(saved) and all(
            torch.equal(got[k], v) for k, v in saved.items())
    del got, saved
    step = T.make_train_step(cfg, opt, mesh=new)
    more = []
    for s in (steps, steps + 1):
        state, m = step(state, pipe.batch_at(s))
        more.append({"loss": m["loss"].item(),
                     "grad_norm": float(m["grad_norm"])})
    params = SH.gather_tree(state.params, T.state_specs(cfg, new,
                                                        opt).params, new)
    out["restore"] = {"from": (2, W // 2), "to": (W, 1), "step": at,
                      "restore_s": restore_s, "bit_equal": equal,
                      "metrics": more,
                      "params": _params_cpu(params) if new.rank == 0
                      else None}
    del state, params
    _empty(dev)
    return out


def _rank_moe(mesh_of, W, smoke, dev, line_up):
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH

    mcfg, mB, mS = _sizes(smoke)[3:6]
    out = {}
    for shape in ((1, W), (2, W // 2)):
        mesh = mesh_of(shape)
        p, x = _moe_inputs(mcfg, mB, mS, dev)
        spec = ("model", None, None)
        p = {k: v if k == "router" else SH.shard_leaf(v, spec, mesh)
             for k, v in p.items()}
        _empty(dev)
        n = mesh.axis_size("data")
        rows = x.shape[0] // n
        xl = x[mesh.axis_index("data") * rows:][:rows].contiguous()
        del x
        mesh.reset_calls()
        with torch.no_grad(), _recording() as rec:
            got, _ = MOE.moe_fwd(p, xl, mcfg, mesh)
        res = {"calls_one_call": dict(mesh.calls),
               "bytes_one_call": dict(mesh.bytes)}
        line_up()
        res["ms"] = _ms(lambda: MOE.moe_fwd(p, xl, mcfg, mesh), dev)
        full = mesh.all_gather(got, "data")
        # a slot is kept where the rank of its expert keeps it
        keep = mesh.all_gather(rec["keep"][0][None].to(torch.uint8),
                               "model").bool().any(0)
        if mesh.rank == 0:
            res.update(out=full.cpu(), ids=rec["ids"][0].reshape(-1).cpu(),
                       keep=keep.cpu())
        out[shape] = res
        del p, xl, got, full
        _empty(dev)
    return out


def _rank_ring(mesh, smoke, dev):
    from repro_torch.models import layers as L

    cfg = _sizes(smoke)[0]
    S = _sizes(smoke)[6]
    p, x, cot = _ring_inputs(cfg, S, dev)
    n = mesh.axis_size("model")
    mesh.reset_calls()
    o = L.ring_attention_block(p, x, cfg, "attn", mesh, n)
    grads = torch.autograd.grad(o, [x, *p.values()], cot)
    res = {"calls_forward_backward": dict(mesh.calls),
           "bytes_forward_backward": dict(mesh.bytes)}
    res["ms"] = _ms(lambda: L.ring_attention_block(p, x, cfg, "attn", mesh,
                                                   n), dev)
    if mesh.rank == 0:
        res.update(out=o.detach().cpu(), grads=[g.cpu() for g in grads])
    return res


def _rank_compress(mesh, smoke, dev):
    import torch.distributed as dist

    from repro_torch.optim import compressed_psum

    N = _sizes(smoke)[7]
    W = mesh.size
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(
        40 + mesh.rank), device=dev)
    got = compressed_psum(x, group=mesh.group("dp"))
    exact = x.clone()
    dist.all_reduce(exact)
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX)
    ratio = float((got - exact).abs().max()) / (float(amax) / 127 * W)
    ms = _ms(lambda: compressed_psum(x, group=mesh.group("dp")), dev)
    y = x.clone()
    ms_f32 = _ms(lambda: dist.all_reduce(y), dev)
    payload = N + 2 * ((N + 255) // 256)  # int8 values + f16 scales
    return {"n": N, "ranks": W, "err_ratio": ratio, "ms": ms,
            "all_reduce_f32_ms": ms_f32,
            "wire_bytes_per_rank": payload * (W - 1),
            "all_reduce_f32_wire_bytes_per_rank": 2 * 4 * N * (W - 1) / W}


# ---------------------------------------------------------------------------


def compare(one, got, W):
    """The mesh results against the one card's: one JSON line a part as
    each is held; a miss is kept and raised after the last."""
    report = {}
    g1 = one["gemma"]["metrics"]
    for shape in ((2, W // 2), (W, 1)):
        r = got["gemma"][shape]
        loss = [abs(a["loss"] - b["loss"]) for a, b in zip(r["metrics"], g1)]
        params = _param_delta(r["params"], one["params"])
        report[f"gemma3-1b {shape}"] = {
            "loss_abs_delta": loss, "params": params,
            "step_ms": r["step_ms"], "one_card_step_ms":
                one["gemma"]["step_ms"],
            "peak_bytes_per_card": r["peak_bytes_per_card"],
            "last_step_nccl": r["last_step"], "save_s": r.get("save_s")}
        floor = one["gemma"]["noise_floor_microbatches_2"]["params"]
        report[f"gemma3-1b {shape}"]["ok"] = \
            max(loss) <= 1e-3 * abs(g1[0]["loss"]) and \
            params["max_rel"] <= max(3 * floor["max_rel"], 1e-2)
    rs = got["gemma"]["restore"]
    loss = [abs(a["loss"] - b["loss"]) for a, b in
            zip(rs["metrics"], g1[-2:])]
    params = _param_delta(rs["params"], one["params_after"])
    report["restore"] = {k: v for k, v in rs.items() if k != "params"}
    report["restore"].update(
        loss_abs_delta=loss, params=params,
        ok=bool(rs["bit_equal"]) and max(loss) <= 1e-3 * abs(g1[0]["loss"]))
    for shape, want in (((1, W), one["moe"]["out"]),
                        ((2, W // 2), one["moe"]["halves"])):
        r = got["moe"][shape]
        err, rms = _rel(r["out"], want), _row_rms(r["out"], want)
        row = {"max_rel_err": err, "row_rms": rms, "ms": r["ms"],
               "one_card_ms": one["moe"]["ms"],
               "nccl_one_call": r["calls_one_call"],
               "nccl_bytes_one_call": r["bytes_one_call"],
               "ok": err <= 1e-2 and rms <= 1e-2}
        if shape == (1, W):
            row["ids_equal"] = torch.equal(r["ids"], one["moe"]["ids"])
            row["keep_equal"] = torch.equal(r["keep"], one["moe"]["keep"])
            row["ok"] &= row["ids_equal"] and row["keep_equal"]
        report[f"moe {shape}"] = row
    r = got["ring"]
    errs = [_rel(r["out"], one["ring"]["out"])] + [
        _rel(a, b) for a, b in zip(r["grads"], one["ring"]["grads"])]
    report["ring"] = {"max_rel_err": errs, "ms": r["ms"],
                      "one_card_ms": one["ring"]["ms"],
                      "nccl_forward_backward": r["calls_forward_backward"],
                      "bytes_forward_backward": r["bytes_forward_backward"],
                      "ok": max(errs) <= 1e-5}
    report["compress"] = dict(got["compress"],
                              ok=got["compress"]["err_ratio"] < 1.5)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="a CPU rehearsal: 4 gloo ranks, smoke configs")
    args = ap.parse_args(argv)
    from repro_torch.core import mesh as CM

    if args.smoke:
        dev, W, smi = torch.device("cpu"), 4, "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            print("torch_lm_mesh_cards: needs two or more CUDA devices",
                  file=sys.stderr)
            return 2
        dev, W = torch.device("cuda", 0), min(torch.cuda.device_count(), 4)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    one = one_card(args, dev)
    store = ROOT / "build" / "lm_mesh_cards_ckpt"  # git ignores build/
    shutil.rmtree(store, ignore_errors=True)
    t1 = time.perf_counter()
    try:
        got = CM.spawn(_rank, W, args.smoke, args.steps, str(store),
                       device=dev.type, join_timeout=2400.0)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"spawn_s": time.perf_counter() - t1})
    report = compare(one, got, W)
    for key, row in report.items():
        emit({"part": key, **row})
    emit({"ranks": W, "seconds": time.perf_counter() - t0,
          "torch": torch.__version__})
    print(smi, flush=True)
    missed = [k for k, row in report.items() if not row["ok"]]
    if missed:
        print(f"torch_lm_mesh_cards: missed {missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
