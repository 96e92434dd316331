#!/usr/bin/env python3
"""The LM across the cards of one machine: the sharded train step, the
expert-parallel MoE block, ring attention, ``compressed_psum`` and the
partitioned decode on W = min(cards, 4) NCCL ranks, each against one
card, and the collectives each step issues against its meta trace.

    python3 scripts/torch_lm_mesh_cards.py [--steps 4] [--parts train,decode]
    python3 scripts/torch_lm_mesh_cards.py --smoke   # CPU, 4 gloo ranks

``--parts train`` runs what follows up to the decode part; ``--parts
decode`` runs the decode part alone (both by default); ``--parts
witness`` runs the witness alone.

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

The decode part: on card 0, gemma3-1b and gemma2-9b at full width
(random weights, seed 0), B=8, the one-card decode of a seeded stream:
64 prompt tokens through decode steps (the cache build), then 16 steps,
each step's host-clock ms.  Then on the W ranks, ``make_decode_step(mesh=)``
on parameters placed by ``serve.shard_params`` and a cache of 1024 by
``serve.shard_cache``, over the same stream: gemma3-1b (one KV head: the
sequence splits) on (1, W) and (2, W/2), gemma2-9b (8 KV heads: the
heads split) on (1, W).  Each step's logits (gathered over the batch
axes) against the one card's at the LM bars (1e-2 of max |ref|, each
row's RMS error within 1e-2 of its RMS); each rank's ``LmMesh.calls`` /
``.bytes`` of a step against the meta trace of the same step as that
rank of a trace mesh of the same shape (``launch.mesh.make_trace_mesh``),
equal; the 16 steps' ms beside the partitioned roofline's three terms;
the step's largest collective re-issued alone (CUDA events, 5 calls) and
its achieved wire rate against ``NVLINK_BW``.  Then gemma3-1b's train
step (B=8, S=1024, state by ``init_state(mesh=)``) on (2, W/2) and
(W, 1): the calls and bytes of its second step against its meta trace,
equal, its ms and partitioned roofline.

The witness: gemma2-9b's decode of the same stream on card 0 in bf16 and
in f32 (f32 copies of the same bf16 parameters, activations and cache in
f32, the embedding scale at its bf16 rounding), and on (1, W) three
ways: as shipped, with its bf16 sum all-reduces (the row-split ``wo``
and MLP down partials) taken in f32, and in f32.  Each against the one
card's bf16 and f32 decodes; the f32 pair is held at 1e-4 of max |ref|
and of each row's RMS (the head-parallel path's arithmetic without
bf16's roundings), the rest are reported.

Prints one JSON line per part, then the card's name and power limit.
Exits non-zero with fewer than two cards (without ``--smoke``).
"""

from __future__ import annotations

import argparse
import contextlib
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


def _rank(pe_mesh, smoke, steps, store, parts):
    """One rank: every mesh part asked for; rank 0 returns the results."""
    from repro_torch.launch import mesh as LM

    dev = pe_mesh.device
    W = pe_mesh.size
    line_up = lambda: (_sync(dev), pe_mesh.vote(torch.ones(1, device=dev)))
    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = LM.make_lm_mesh(shape, device=dev.type)
        return meshes[shape]

    out = {}
    if "train" in parts:
        out["gemma"] = _rank_gemma(mesh_of, W, smoke, steps, store, dev,
                                   line_up)
        out["moe"] = _rank_moe(mesh_of, W, smoke, dev, line_up)
        out["ring"] = _rank_ring(mesh_of((1, W)), smoke, dev)
        out["compress"] = _rank_compress(LM.make_lm_mesh((W,), ("dp",),
                                                         dev.type), smoke,
                                         dev)
    if "decode" in parts:
        out["decode"] = _rank_decode(mesh_of, W, smoke, dev, line_up)
        out["train_trace"] = _rank_train_trace(mesh_of, W, smoke, dev,
                                               line_up)
    if "witness" in parts:
        out["witness"] = _rank_witness(mesh_of, W, smoke, dev)
    if "ssm" in parts:
        out["ssm"] = _rank_ssm(mesh_of, W, smoke, dev, line_up)
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
# The partitioned decode and the counts against the meta trace
# ---------------------------------------------------------------------------


def _decode_sizes(smoke, W):
    """(cases [(arch, mesh shape)], B, prompt, steps, cache length)."""
    cases = (("gemma3-1b", (1, W)), ("gemma3-1b", (2, W // 2)),
             ("gemma2-9b", (1, W)))
    if smoke:
        return cases, 4, 8, 4, 32
    return cases, 8, 64, 16, 1024


def _decode_cfg(arch, smoke):
    from repro_torch import configs

    return (configs.smoke_config if smoke else configs.get_config)(arch)


def _decode_stream(cfg, B, T, dev):
    import numpy as np

    return torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, T), dtype=np.int32), device=dev)


def one_card_decode(args, dev, W):
    """Each decode arch's one-card decode of the stream: the logits from
    the prompt's last step on (on the host) and the timed steps' ms."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    cases, B, P, steps, L = _decode_sizes(args.smoke, W)
    out = {}
    for arch in dict(cases):
        t0 = time.perf_counter()
        cfg = _decode_cfg(arch, args.smoke)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), dev)
        toks = _decode_stream(cfg, B, P + steps, dev)
        cache = M.init_cache(cfg, B, L, dev)
        step = SV.make_decode_step(cfg)
        logits, ms = [], []
        with torch.no_grad():
            for t in range(P + steps):
                _sync(dev)
                t0s = time.perf_counter()
                lg, cache = step(params, toks[:, t:t + 1], t, cache)
                lg = lg.cpu()
                if t >= P:
                    ms.append((time.perf_counter() - t0s) * 1e3)
                if t >= P - 1:
                    logits.append(lg)
        out[arch] = {"logits": torch.stack(logits), "step_ms": ms}
        emit({"one_card": f"decode {arch}", "step_ms": ms,
              "seconds": time.perf_counter() - t0})
        del params, cache
        _empty(dev)
    return out


class _Largest:
    """Record every collective a mesh issues (method, its arguments'
    shape and dtype, the wire bytes it counts) while active."""

    def __init__(self, mesh):
        self.mesh, self.seen = mesh, []

    def __enter__(self):
        m = self.mesh
        self.saved = {k: getattr(m, k) for k in
                      ("all_reduce", "all_gather", "reduce_scatter")}
        for name, fn in self.saved.items():
            def wrap(t, names, *a, _fn=fn, _name=name, **kw):
                before = sum(m.bytes.values())
                out = _fn(t, names, *a, **kw)
                self.seen.append((sum(m.bytes.values()) - before, _name,
                                  tuple(t.shape), t.dtype, names, a, kw))
                return out
            setattr(m, name, wrap)
        return self

    def __exit__(self, *exc):
        for name in self.saved:
            delattr(self.mesh, name)

    def rate(self, dev, reps=5):
        """The largest call re-issued ``reps`` times alone: its wire bytes,
        ms a call (CUDA events) and bytes/s."""
        from repro_torch.launch.mesh import NVLINK_BW

        wire, name, shape, dtype, names, a, kw = max(
            self.seen, key=lambda r: r[0])
        t = torch.zeros(shape, dtype=dtype, device=dev)
        fn = getattr(self.mesh, name)
        fn(t.clone(), names, *a, **kw)
        _sync(dev)
        if dev.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(reps):
                fn(t.clone() if name == "all_reduce" else t, names, *a, **kw)
            end.record()
            _sync(dev)
            ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(t.clone() if name == "all_reduce" else t, names, *a, **kw)
            ms = (time.perf_counter() - t0) * 1e3 / reps
        return {"kind": name, "shape": list(shape), "dtype": str(dtype),
                "axes": names, "wire_bytes": wire, "ms": ms,
                "bytes_per_s": wire / (ms / 1e3),
                "of_nvlink_bw": wire / (ms / 1e3) / NVLINK_BW}


def _trace_counts(cfg, kind, S, B, shape, rank, mesh_rank_axes):
    """The meta trace of the step of ``kind`` as rank ``rank`` of a trace
    mesh of ``shape``: its calls and wire bytes by kind and its
    partitioned roofline."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import opanalysis as OA
    from repro_torch.models.config import ShapeConfig

    tm = LM.make_trace_mesh(shape, mesh_rank_axes, rank=rank)
    fn, args = D.build_cell(cfg, ShapeConfig(kind, S, B, kind), tm)
    _, ana = OA.analyze(fn, *args, mesh=tm)
    return {"calls": dict(ana.collective_calls),
            "bytes": dict(ana.per_collective),
            "roofline": D.roofline(ana, tm)}


def _counts_equal(mesh, real, traced, dev):
    """Whether every rank's real calls and bytes equal its trace's."""
    ok = real["calls"] == traced["calls"] and real["bytes"] == traced["bytes"]
    flag = torch.tensor([0.0 if ok else 1.0], device=dev)
    mesh.all_reduce(flag, mesh.axis_names)
    mesh.reset_calls()
    return float(flag) == 0.0


def _rank_decode(mesh_of, W, smoke, dev, line_up):
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    cases, B, P, steps, L = _decode_sizes(smoke, W)
    out = {}
    for arch, shape in cases:
        mesh = mesh_of(shape)
        cfg = _decode_cfg(arch, smoke)
        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(
            0), dev)
        shards = SV.shard_params(params, cfg, mesh)
        del params
        cache = SV.shard_cache(M.init_cache(cfg, B, L, dev), cfg, mesh)
        _empty(dev)
        toks = _decode_stream(cfg, B, P + steps, dev)
        step = SV.make_decode_step(cfg, mesh, L)
        axes = mesh.for_batch(B).batch_axes()
        logits, ms, calls = [], [], None
        with torch.no_grad():
            for t in range(P + steps):
                if t >= P:
                    line_up()
                mesh.reset_calls()
                t0 = time.perf_counter()
                lg, cache = step(shards, toks[:, t:t + 1], t, cache)
                lg = lg.cpu()
                if t >= P:
                    ms.append((time.perf_counter() - t0) * 1e3)
                calls = {"calls": dict(mesh.calls),
                         "bytes": dict(mesh.bytes)}
                if t >= P - 1:
                    logits.append(mesh.all_gather(lg.to(dev), axes, 0).cpu())
            with _Largest(mesh) as largest:
                step(shards, toks[:, P:P + 1], P, cache)
            mesh.reset_calls()
            rate = largest.rate(dev)
        mesh.reset_calls()
        traced = _trace_counts(cfg, "decode", L, B, shape, mesh.rank,
                               mesh.axis_names)
        equal = _counts_equal(mesh, calls, traced, dev)
        res = {"step_ms": ms, "step_calls": calls, "trace": traced,
               "counts_equal_every_rank": equal, "largest": rate}
        if mesh.rank == 0:
            res["logits"] = torch.stack(logits)
        out[(arch, shape)] = res
        del shards, cache
        _empty(dev)
    return out


def _rank_train_trace(mesh_of, W, smoke, dev, line_up):
    """gemma3-1b's train step on (2, W/2) and (W, 1): the calls and bytes
    of its second step against its meta trace; its ms."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import train as T

    cfg, B, S = _sizes(smoke)[:3]
    out = {}
    for shape in ((2, W // 2), (W, 1)):
        mesh = mesh_of(shape)
        _empty(dev)
        state = T.init_state(torch.Generator(device=dev).manual_seed(0), cfg,
                             device=dev, mesh=mesh)
        step = T.make_train_step(cfg, mesh=mesh)
        pipe = SyntheticLM(cfg.vocab_size, B, S, seed=0, device=dev)
        ms = []
        for s in range(2):
            batch = pipe.batch_at(s)
            line_up()
            mesh.reset_calls()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            m["loss"].item()
            ms.append((time.perf_counter() - t0) * 1e3)
            calls = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
        with _Largest(mesh) as largest:
            step(state, pipe.batch_at(2))
        mesh.reset_calls()
        rate = largest.rate(dev)
        del state
        _empty(dev)
        traced = _trace_counts(cfg, "train", S, B, shape, mesh.rank,
                               mesh.axis_names)
        out[shape] = {"step_ms": ms, "step_calls": calls, "trace": traced,
                      "counts_equal_every_rank": _counts_equal(
                          mesh, calls, traced, dev),
                      "largest": rate}
    return out


def compare_decode(one, got, W, smoke):
    """The mesh decode against the one card's, and the counts; one row a
    case."""
    cases = _decode_sizes(smoke, W)[0]
    report = {}
    for arch, shape in cases:
        r = got["decode"][(arch, shape)]
        want = one[arch]["logits"]
        err, rms = _rel(r["logits"], want), _row_rms(r["logits"], want)
        rl = r["trace"]["roofline"]
        report[f"decode {arch} {shape}"] = {
            "max_rel_err": err, "row_rms": rms, "step_ms": r["step_ms"],
            "one_card_step_ms": one[arch]["step_ms"],
            "roofline_ms": {k: v * 1e3 for k, v in rl.items()
                            if k.endswith("_s")},
            "bottleneck": rl["bottleneck"], "step_calls": r["step_calls"],
            "trace": {k: v for k, v in r["trace"].items()
                      if k != "roofline"},
            "counts_equal_every_rank": r["counts_equal_every_rank"],
            "largest": r["largest"],
            "ok": err <= 1e-2 and rms <= 1e-2
            and r["counts_equal_every_rank"]}
    for shape, r in got["train_trace"].items():
        rl = r["trace"]["roofline"]
        report[f"train trace {shape}"] = {
            "step_ms": r["step_ms"], "step_calls": r["step_calls"],
            "trace": {k: v for k, v in r["trace"].items() if k != "roofline"},
            "roofline_ms": {k: v * 1e3 for k, v in rl.items()
                            if k.endswith("_s")},
            "bottleneck": rl["bottleneck"], "largest": r["largest"],
            "counts_equal_every_rank": r["counts_equal_every_rank"],
            "ok": r["counts_equal_every_rank"]}
    return report


# ---------------------------------------------------------------------------
# The SSM mixers on a model axis: xlstm-350m and jamba-1.5-large
# ---------------------------------------------------------------------------


def _ssm_sizes(smoke):
    """(decode B, xlstm's prompt, jamba's prompt, steps, cache length,
    train B, train S, the 8-layer period's timed prompt).  jamba's stream
    is shorter: the margin rule compares a row only while every routing
    decision of its stream so far clears 1e-3 on both sides, which a long
    prompt leaves few rows to do."""
    return (4, 8, 8, 4, 32, 4, 64, 8) if smoke else \
        (8, 64, 16, 16, 1024, 8, 1024, 64)


def _ssm_cfgs(smoke):
    """xlstm-350m; jamba-1.5-large cut to the first 4 layers of its period
    at its published capacity; its whole 8-layer period at a capacity
    that drops nothing (decode routes B tokens a step, the forward B x S:
    their capacities differ, so drops would)."""
    from repro_torch import configs

    pick = configs.smoke_config if smoke else configs.get_config
    jamba = pick("jamba-1.5-large-398b")
    cut = dataclasses.replace(jamba, num_layers=4,
                              layer_pattern=jamba.layer_pattern[:4])
    period = dataclasses.replace(
        jamba, num_layers=len(jamba.layer_pattern),
        capacity_factor=jamba.num_experts / jamba.top_k)
    return pick("xlstm-350m"), cut, period


def _layerwise_params(cfg, dev, mesh=None):
    """``cfg``'s parameters in the reference's layout (one repeat: a slot
    a layer), layer i drawn from a generator seeded ``100 + i`` and the
    embedding, head and final norm from seed 0; on ``mesh`` each leaf is
    cut to this rank's shard as it is drawn, so the whole model is never
    on one card (jamba's 8-layer period is about 88 GB in bf16)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import sharding as SH
    from repro_torch.models.sharding import map_leaves

    if cfg.repeats != 1 or cfg.tail_pattern:
        raise ValueError("one layer a slot: num_layers == the pattern's")
    specs = None if mesh is None else SV.param_specs_of(cfg, mesh)

    def keep(tree, prefix):
        if mesh is None:
            return tree
        return map_leaves(lambda path, t: SH.shard_leaf(
            t, SH._spec_at(specs, prefix + path), mesh), tree)

    g = torch.Generator(device=dev).manual_seed(0)
    out = {"embed": keep(L.init_embedding(cfg.vocab_size, cfg.d_model, g,
                                          dev), ("embed",)),
           "final_norm": L.init_rmsnorm(cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        out["lm_head"] = keep({"table": L._normal(
            (cfg.vocab_size, cfg.d_model), cfg.d_model ** -0.5, g, dev)},
            ("lm_head",))
    out["slots"] = {}
    for i, block in enumerate(cfg.layer_pattern):
        key = f"slot{i:02d}"
        layer = M._init_block(cfg, block, torch.Generator(
            device=dev).manual_seed(100 + i), dev)
        out["slots"][key] = keep(map_leaves(lambda _, t: t.unsqueeze(0),
                                            layer), ("slots", key))
        del layer
        _empty(dev)
    return out


@contextlib.contextmanager
def _margins(record):
    """Every routing decision's margin between a token's k-th and
    (k+1)-th gate appended to ``record`` (one [tokens] tensor a call of
    the router) while active."""
    from repro_torch.models import moe as MOE

    route = MOE._route

    def recording(xt, router, cfg):
        got = route(xt, router, cfg)
        g = torch.sort(got[2], dim=-1, descending=True).values
        record.append((g[:, cfg.top_k - 1] - g[:, cfg.top_k]).float().cpu())
        return got

    MOE._route = recording
    try:
        yield
    finally:
        MOE._route = route


def _ssm_decode(step, params, toks, cache, P, dev, routed=False,
                keep_from=None):
    """Decode steps over ``toks`` (the cache built by the prompt's ``P``
    steps): the logits from the prompt's last step on (from step
    ``keep_from`` where given; on the host), the host-clock ms of each
    step after the prompt, the cache, and (``routed``) each step's
    smallest routing margin of each row [T, B]."""
    keep_from = P - 1 if keep_from is None else keep_from
    logits, ms, margins = [], [], []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            record = []
            _sync(dev)
            t0 = time.perf_counter()
            with _margins(record) if routed else contextlib.nullcontext():
                lg, cache = step(params, toks[:, t:t + 1], t, cache)
            lg = lg.cpu()
            if t >= P:
                ms.append((time.perf_counter() - t0) * 1e3)
            if t >= keep_from:
                logits.append(lg)
            if routed:
                margins.append(torch.stack(record).amin(0))
    return (torch.stack(logits), ms, cache,
            torch.stack(margins) if routed else None)


def _clear(margins):
    """[T, B]: whether every routing decision of a row up to each step
    cleared the next gate by 1e-3 (the margin rule)."""
    return torch.cummin(margins, 0).values > 1e-3


def one_card_ssm(args, dev):
    """On card 0: xlstm-350m's decode of the stream, in bf16 and in f32
    (the witness: f32 copies of the same parameters, ``_in_f32``), and
    one train step (B x S, seed 0: its loss and ms); jamba's 4-layer
    cut's decode with each step's routing margins."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import train as T

    B, P, Pj, steps, L, Bt, St, _ = _ssm_sizes(args.smoke)
    xcfg, cut, _ = _ssm_cfgs(args.smoke)
    out = {}
    t0 = time.perf_counter()
    params = M.init_params(xcfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    toks = _decode_stream(xcfg, B, P + steps, dev)
    step = SV.make_decode_step(xcfg)
    logits, ms, _, _ = _ssm_decode(step, params, toks,
                                   M.init_cache(xcfg, B, L, dev), P, dev)
    out["xlstm_decode"] = {"logits": logits, "step_ms": ms}
    params = _f32_leaves(params)
    with _in_f32():
        out["xlstm_decode"]["f32"] = _ssm_decode(
            step, params, toks, M.init_cache(xcfg, B, L, dev), P, dev)[0]
    del params
    _empty(dev)
    state = T.init_state(torch.Generator(device=dev).manual_seed(0), xcfg,
                         device=dev)
    batch = SyntheticLM(xcfg.vocab_size, Bt, St, seed=0,
                        device=dev).batch_at(0)
    _sync(dev)
    t1 = time.perf_counter()
    state, m = T.make_train_step(xcfg)(state, batch)
    out["xlstm_train"] = {"loss": float(m["loss"]),
                          "step_ms": (time.perf_counter() - t1) * 1e3}
    del state
    _empty(dev)
    params = M.params_from_reference(_layerwise_params(cut, dev), cut, dev)
    logits, ms, _, margins = _ssm_decode(
        SV.make_decode_step(cut), params, _decode_stream(cut, B, Pj + steps,
                                                         dev),
        M.init_cache(cut, B, L, dev), Pj, dev, routed=True)
    out["jamba4_decode"] = {"logits": logits, "step_ms": ms,
                            "margins": margins}
    del params
    _empty(dev)
    emit({"one_card": "ssm", "seconds": time.perf_counter() - t0,
          "xlstm_train_loss": out["xlstm_train"]["loss"]})
    return out


def _rank_ssm_decode(mesh, cfg, params, B, P, steps, L, dev, line_up,
                     routed=False, keep_from=None):
    """The partitioned decode of the stream on ``mesh`` from this rank's
    ``params`` (the reference layout's shards): the logits (gathered over
    the batch axes; on rank 0), the steps' ms, one step's calls and
    bytes against the meta trace's on every rank, the margins."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    toks = _decode_stream(cfg, B, P + steps, dev)
    cache = SV.shard_cache(M.init_cache(cfg, B, L, dev), cfg, mesh)
    step = SV.make_decode_step(cfg, mesh, L)
    line_up()
    logits, ms, cache, margins = _ssm_decode(step, params, toks, cache, P,
                                             dev, routed, keep_from)
    mesh.reset_calls()
    with torch.no_grad():
        step(params, toks[:, P:P + 1], P, cache)
    calls = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
    mesh.reset_calls()
    traced = _trace_counts(cfg, "decode", L, B, tuple(mesh.shape.values()),
                           mesh.rank, mesh.axis_names)
    axes = mesh.for_batch(B).batch_axes()
    logits = torch.stack([mesh.all_gather(lg.to(dev), axes, 0).cpu()
                          for lg in logits])
    return {"logits": logits if mesh.rank == 0 else None, "step_ms": ms,
            "margins": margins, "step_calls": calls, "trace": traced,
            "counts_equal_every_rank": _counts_equal(mesh, calls, traced,
                                                     dev)}


def _rank_ssm(mesh_of, W, smoke, dev, line_up):
    """xlstm-350m's decode on (1, W) and (2, W/2) (on (1, W) also in f32
    and with its bf16 sums taken in f32: the witness) and its train step
    on (2, W/2); jamba's 4-layer cut's decode on (1, W) with each step's
    margins; its whole 8-layer period on (1, W): the prefill step's
    seconds, the decode's ms a step, each card's peak, and the decode's
    logits at the prompt's last step against its own partitioned
    forward's last position: the logits of every step against the
    teacher-forced forward's at that position."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import train as T

    B, P, Pj, steps, L, Bt, St, Pt = _ssm_sizes(smoke)
    xcfg, cut, period = _ssm_cfgs(smoke)
    out = {}
    for shape in ((1, W), (2, W // 2)):
        mesh = mesh_of(shape)
        params = SV.shard_params(M.init_params(
            xcfg, torch.Generator(device=dev).manual_seed(0), dev), xcfg,
            mesh)
        _empty(dev)
        res = _rank_ssm_decode(mesh, xcfg, params, B, P, steps, L, dev,
                               line_up)
        if shape == (1, W):
            toks = _decode_stream(xcfg, B, P + steps, dev)
            step = SV.make_decode_step(xcfg, mesh, L)
            cache = lambda: SV.shard_cache(M.init_cache(xcfg, B, L, dev),
                                           xcfg, mesh)
            axes = mesh.for_batch(B).batch_axes()
            gather = lambda lg: mesh.all_gather(lg.to(dev), axes, 0).cpu()
            with _f32_sums(mesh):
                sums = _ssm_decode(step, params, toks, cache(), P, dev)[0]
            params = _f32_leaves(params)
            with _in_f32():
                f32 = _ssm_decode(step, params, toks, cache(), P, dev)[0]
            res.update(bf16_f32_sums=torch.stack([gather(t) for t in sums]),
                       f32=torch.stack([gather(t) for t in f32]))
            mesh.reset_calls()
        out[("xlstm", shape)] = res
        del params
        _empty(dev)
    mesh = mesh_of((2, W // 2))
    state = T.init_state(torch.Generator(device=dev).manual_seed(0), xcfg,
                         device=dev, mesh=mesh)
    batch = SyntheticLM(xcfg.vocab_size, Bt, St, seed=0,
                        device=dev).batch_at(0)
    _peak_reset(dev)
    line_up()
    mesh.reset_calls()
    t0 = time.perf_counter()
    state, m = T.make_train_step(xcfg, mesh=mesh)(state, batch)
    loss = float(m["loss"])
    out["xlstm_train"] = {"loss": loss,
                          "step_ms": (time.perf_counter() - t0) * 1e3,
                          "calls": dict(mesh.calls),
                          "bytes": dict(mesh.bytes),
                          "peak_bytes_per_card": _gather_peaks(mesh, dev)}
    del state
    _empty(dev)

    mesh = mesh_of((1, W))
    params = _layerwise_params(cut, dev, mesh)
    out["jamba4"] = _rank_ssm_decode(mesh, cut, params, B, Pj, steps, L,
                                     dev, line_up, routed=True)
    del params
    _empty(dev)

    _peak_reset(dev)
    params = _layerwise_params(period, dev, mesh)
    prefill = SV.make_prefill_step(period, mesh)
    timed = _decode_stream(period, B, Pt, dev)
    seconds = []
    with torch.no_grad():
        for _ in range(2):  # the first call, then a warm one
            line_up()
            t0 = time.perf_counter()
            prefill(params, {"tokens": timed}).cpu()
            seconds.append(time.perf_counter() - t0)
    res = _rank_ssm_decode(mesh, period, params, B, Pj, steps, L, dev,
                           line_up, routed=True, keep_from=0)
    record = []
    toks = _decode_stream(period, B, Pj + steps, dev)
    with torch.no_grad(), _margins(record):
        whole = SV._whole_params(params, SV.param_specs_of(period, mesh),
                                 period, mesh)
        forward = M.forward(whole, {"tokens": toks}, period, mesh)[0].cpu()
        del whole
    res.update(prefill_s=seconds, prefill_tokens=Pt,
               forward=forward if mesh.rank == 0 else None,
               forward_margins=torch.stack(
                   [m.reshape(B, -1) for m in record]).amin(0),
               peak_bytes_per_card=_gather_peaks(mesh, dev),
               params_bytes_per_card=sum(
                   t.numel() * t.element_size()
                   for t in torch.utils._pytree.tree_leaves(params)))
    out["jamba8"] = res
    del params
    _empty(dev)
    return out


def _logit_row(r, have, want, **extra):
    """A decode row's record: errors at the LM bars, ms, calls, the meta
    trace's roofline; ``ok`` where both bars and the counts hold."""
    row = {"step_ms": r["step_ms"], "step_calls": r["step_calls"],
           "counts_equal_every_rank": r["counts_equal_every_rank"],
           "roofline_ms": {k: v * 1e3 for k, v in
                           r["trace"]["roofline"].items()
                           if k.endswith("_s")}, **extra}
    ok = r["counts_equal_every_rank"] and have.numel() > 0
    if have.numel():
        row.update(max_rel_err=_rel(have, want), row_rms=_row_rms(have, want))
        ok = ok and row["max_rel_err"] <= 1e-2 and row["row_rms"] <= 1e-2
    return dict(row, ok=ok)


def compare_ssm(one, got, smoke):
    """The SSM part's rows: the decodes at the LM bars (jamba's only
    where the margin rule clears a row so far on both sides), xlstm's
    train loss within 1e-3 of one card's, every rank's calls equal its
    meta trace's; the witness (xlstm on (1, W) in f32, and with f32
    sums) reported beside them."""
    W = max(k[1][1] for k in got if isinstance(k, tuple))
    Pj = _ssm_sizes(smoke)[2]
    report = {}
    one_x = one["xlstm_decode"]
    for shape in ((1, W), (2, W // 2)):
        r = got[("xlstm", shape)]
        extra = {"one_card_step_ms": one_x["step_ms"]}
        if "f32" in r:
            extra["witness"] = {
                "f32_vs_one_card_f32": [_rel(r["f32"], one_x["f32"]),
                                        _row_rms(r["f32"], one_x["f32"])],
                "f32_sums_vs_one_card": [
                    _rel(r["bf16_f32_sums"], one_x["logits"]),
                    _row_rms(r["bf16_f32_sums"], one_x["logits"])],
                "one_card_bf16_vs_f32": [_rel(one_x["logits"], one_x["f32"]),
                                         _row_rms(one_x["logits"],
                                                  one_x["f32"])]}
        report[f"ssm xlstm-350m decode {shape}"] = _logit_row(
            r, r["logits"], one_x["logits"], **extra)
    t, w = got["xlstm_train"], one["xlstm_train"]
    delta = abs(t["loss"] - w["loss"])
    report[f"ssm xlstm-350m train {(2, W // 2)}"] = dict(
        t, one_card_loss=w["loss"], one_card_step_ms=w["step_ms"],
        loss_abs_delta=delta, ok=delta <= 1e-3 * abs(w["loss"]))
    # the 4-layer cut against one card: each step's rows that clear so far
    r, o = got["jamba4"], one["jamba4_decode"]
    clear = _clear(torch.minimum(r["margins"], o["margins"]))[Pj - 1:]
    report[f"ssm jamba 4 layers decode {(1, W)}"] = _logit_row(
        r, r["logits"][clear], o["logits"][clear],
        one_card_step_ms=o["step_ms"], pairs_compared=int(clear.sum()),
        rows_clear_last_step=int(clear[-1].sum()))
    # the 8-layer period: each decode step's logits against the
    # teacher-forced forward's at that position (the forward's last
    # position over the stream's prefix), on the pairs clear in both
    r = got["jamba8"]
    clear = _clear(r["margins"]) & _clear(r["forward_margins"].T)
    forward = r["forward"].transpose(0, 1)[:, :, None]  # [T, B, 1, V]
    report[f"ssm jamba 8-layer period decode {(1, W)} vs its forward"] = \
        _logit_row(r, r["logits"][clear], forward[clear],
                   pairs_compared=int(clear.sum()),
                   rows_clear_last_step=int(clear[-1].sum()),
                   prefill_s=r["prefill_s"],
                   prefill_tokens=r["prefill_tokens"],
                   peak_gb_per_card=[b / 1e9 for b in
                                     r["peak_bytes_per_card"]],
                   params_gb_per_card=r["params_bytes_per_card"] / 1e9)
    return report


# ---------------------------------------------------------------------------
# The witness: gemma2-9b's head-parallel decode free of bf16 rounding
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _in_f32():
    """The model in f32 while active: activations, caches and the final
    norm's cast (``layers.PDT``), the embedding scale kept at its bf16
    rounding, so that on f32 copies of bf16 parameters the step computes
    the bf16 model's function without its roundings."""
    from repro_torch.models import layers as L

    pdt, scale = L.PDT, L.embed_scale
    L.embed_scale = lambda d: float(torch.tensor(d ** 0.5, dtype=pdt))
    L.PDT = torch.float32
    try:
        yield
    finally:
        L.PDT, L.embed_scale = pdt, scale


@contextlib.contextmanager
def _f32_sums(mesh):
    """Every bf16 sum all-reduce of ``mesh`` taken in f32 while active:
    each rank's partial (the row-split ``wo`` and MLP down products)
    rounded to bf16 once, the sum once, as one card's product rounds its
    f32 accumulator once."""
    issue = mesh.all_reduce

    def all_reduce(t, names, op="sum"):
        if t.dtype != torch.bfloat16 or op != "sum":
            return issue(t, names, op)
        return t.copy_(issue(t.float(), names, op))

    mesh.all_reduce = all_reduce
    try:
        yield
    finally:
        del mesh.all_reduce


def _decode_logits(step, params, toks, cache, P, steps, gather=None):
    """The logits of ``P + steps`` decode steps over ``toks`` from position
    ``P - 1`` on, on the host."""
    logits = []
    with torch.no_grad():
        for t in range(P + steps):
            lg, cache = step(params, toks[:, t:t + 1], t, cache)
            if t >= P - 1:
                logits.append((lg if gather is None else gather(lg)).cpu())
    return torch.stack(logits)


def _f32_leaves(tree):
    from repro_torch.models.sharding import map_leaves

    return map_leaves(lambda _, t: t.float(), tree)


def one_card_witness(args, dev, W):
    """gemma2-9b's one-card decode of the decode part's stream in bf16 and
    in f32 (the same bf16 parameters, ``_in_f32``)."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    _, B, P, steps, L = _decode_sizes(args.smoke, W)
    t0 = time.perf_counter()
    cfg = _decode_cfg("gemma2-9b", args.smoke)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    toks = _decode_stream(cfg, B, P + steps, dev)
    step = SV.make_decode_step(cfg)
    out = {"bf16": _decode_logits(step, params, toks,
                                  M.init_cache(cfg, B, L, dev), P, steps)}
    params = _f32_leaves(params)
    _empty(dev)
    with _in_f32():
        out["f32"] = _decode_logits(step, params, toks,
                                    M.init_cache(cfg, B, L, dev), P, steps)
    del params
    _empty(dev)
    emit({"one_card": "witness gemma2-9b", "seconds":
          time.perf_counter() - t0})
    return out


def _rank_witness(mesh_of, W, smoke, dev):
    """gemma2-9b's partitioned decode on (1, W) three ways: as shipped,
    with its bf16 partial sums taken in f32 (``_f32_sums``), and in f32
    (``_in_f32``); rank 0 returns the logits."""
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV

    _, B, P, steps, L = _decode_sizes(smoke, W)
    mesh = mesh_of((1, W))
    cfg = _decode_cfg("gemma2-9b", smoke)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    shards = SV.shard_params(params, cfg, mesh)
    del params
    _empty(dev)
    toks = _decode_stream(cfg, B, P + steps, dev)
    step = SV.make_decode_step(cfg, mesh, L)
    axes = mesh.for_batch(B).batch_axes()
    gather = lambda lg: mesh.all_gather(lg, axes, 0)
    cache = lambda: SV.shard_cache(M.init_cache(cfg, B, L, dev), cfg, mesh)
    out = {"bf16": _decode_logits(step, shards, toks, cache(), P, steps,
                                  gather)}
    with _f32_sums(mesh):
        out["bf16_f32_sums"] = _decode_logits(step, shards, toks, cache(),
                                              P, steps, gather)
    shards = _f32_leaves(shards)
    _empty(dev)
    with _in_f32():
        out["f32"] = _decode_logits(step, shards, toks, cache(), P, steps,
                                    gather)
    mesh.reset_calls()
    del shards
    _empty(dev)
    return out if mesh.rank == 0 else None


def compare_witness(one, got, W):
    """Each of the witness's decodes against one card's in bf16 and in f32;
    only the f32 pair is held, at 1e-4 (the path's arithmetic without
    bf16's roundings)."""
    rows = {}
    for name, logits in got["witness"].items():
        row = {}
        for ref in ("bf16", "f32"):
            want = one["witness"][ref]
            row[f"vs_one_card_{ref}"] = {
                "max_rel_err": _rel(logits, want),
                "row_rms": _row_rms(logits, want)}
        rows[f"witness gemma2-9b (1, {W}) {name}"] = row
    rows["witness gemma2-9b one card bf16"] = {"vs_one_card_f32": {
        "max_rel_err": _rel(one["witness"]["bf16"], one["witness"]["f32"]),
        "row_rms": _row_rms(one["witness"]["bf16"],
                            one["witness"]["f32"])}}
    for key, row in rows.items():
        f32 = row["vs_one_card_f32"]
        row["ok"] = not key.endswith(" f32") or (
            f32["max_rel_err"] <= 1e-4 and f32["row_rms"] <= 1e-4)
    return rows


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
    ap.add_argument("--parts", default="train,decode",
                    help="train, decode, witness, ssm (comma-separated)")
    ap.add_argument("--smoke", action="store_true",
                    help="a CPU rehearsal: 4 gloo ranks, smoke configs")
    args = ap.parse_args(argv)
    parts = tuple(args.parts.split(","))
    if not set(parts) <= {"train", "decode", "witness", "ssm"}:
        ap.error(f"--parts {args.parts}: train, decode, witness, ssm")
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
    one = one_card(args, dev) if "train" in parts else {}
    if "decode" in parts:
        one["decode"] = one_card_decode(args, dev, W)
    if "witness" in parts:
        one["witness"] = one_card_witness(args, dev, W)
    if "ssm" in parts:
        one["ssm"] = one_card_ssm(args, dev)
    store = ROOT / "build" / "lm_mesh_cards_ckpt"  # git ignores build/
    shutil.rmtree(store, ignore_errors=True)
    t1 = time.perf_counter()
    try:
        got = CM.spawn(_rank, W, args.smoke, args.steps, str(store), parts,
                       device=dev.type, join_timeout=2400.0)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"spawn_s": time.perf_counter() - t1})
    report = compare(one, got, W) if "train" in parts else {}
    if "decode" in parts:
        report.update(compare_decode(one["decode"], got, W, args.smoke))
    if "witness" in parts:
        report.update(compare_witness(one, got, W))
    if "ssm" in parts:
        report.update(compare_ssm(one["ssm"], got["ssm"], args.smoke))
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
