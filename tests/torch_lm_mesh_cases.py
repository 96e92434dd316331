"""Cases of ``tests/test_torch_lm_mesh.py``: the inputs (drawn by the JAX
reference, carried across as tensors), the JAX reference's side (run in
one subprocess with 8 forced host devices, ``reference_main``) and the
port's rank body (``world``, run on 8 gloo ranks by one spawn).

The reference's side runs ``tests/test_multidevice.py`` sections 2-4 as
written there, plus the ZeRO cell (section 3 at ``d_model=1024``, where
the spec tables give parameters ``"data"`` dims) on (4, 2) and (8, 1),
and the SSM families' forward and train step on (2, 4).
The rank body builds each mesh over the same 8 ranks in turn and returns,
on rank 0, every result gathered whole.  Nothing here imports JAX at
module level: the ranks import this module and must not load it.
"""

import contextlib
import dataclasses
import os
import pickle

import numpy as np
import torch

MOE_CFG = dict(name="t", family="moe", num_layers=2, d_model=64,
               num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128,
               layer_pattern=(("attn", "moe"),), num_experts=8, top_k=2,
               moe_d_ff=96, capacity_factor=8.0)
# the same MoE at a capacity that drops slots: per-shard capacity shows
TIGHT_CFG = dict(MOE_CFG, capacity_factor=1.0)
TRAIN_CFG = dict(name="t2", family="dense", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256)
ZERO_CFG = dict(TRAIN_CFG, name="t3", d_model=1024)
RING_CFG = dict(name="r", family="dense", num_layers=1, d_model=48,
                num_heads=6, num_kv_heads=3, d_ff=96, vocab_size=64,
                qkv_bias=True, remat="none")
MOE_MESH, RING_MESH = (2, 4), (2, 4)
TRAIN_CELLS = (("d64", TRAIN_CFG, (4, 2)), ("zero", ZERO_CFG, (4, 2)),
               ("zero", ZERO_CFG, (8, 1)))
# the port's own cells: on (2, 4) the 4 heads split 4 ways and the 2 KV
# heads do not (each rank picks its heads' K/V from the whole ones); on
# (1, 8) neither divides (attention runs whole on every rank) while vocab
# and ff split 8 ways
PORT_CELLS = (("d64", TRAIN_CFG, (2, 4)), ("d64", TRAIN_CFG, (1, 8)))
CKPT_FROM, CKPT_TO = (4, 2), ((2, 4), (8, 1))
LR = dict(peak_lr=1e-3, warmup=1, total=10)  # section 3's optimizer
WORLD = 8
# the partitioned steps: every kind of each arch's smoke config traced on
# meta against rank 0's real run (tests/test_dryrun_unit.py's cells, B=8,
# S=64); the decode cases (arch, mesh, cache length) run 8 steps after a
# 16-token prefill (decode steps over the prompt), past the local ring's
# wrap at 16: gemma2's 2 KV heads split the sequence over model=4 and the
# heads over model=2, gemma3's one KV head the sequence; in a cache of
# 30 on model=4 gemma2's global layers keep theirs whole (30 does not
# divide: ``cache_specs`` replicates it) while its local rings split
TRACE_ARCHS = ("gemma2-9b", "gemma3-1b", "kimi-k2-1t-a32b", "hubert-xlarge")
TRACE_MESHES = ((2, 4), (4, 2))
SSM_TRACE_MESH = (2, 4)  # the SSM families' partitioned steps, traced
TRACE_B, TRACE_S = 8, 64
DECODE_CASES = (("gemma2-9b", (2, 4), 32), ("gemma2-9b", (4, 2), 32),
                ("gemma3-1b", (2, 4), 32), ("gemma2-9b", (2, 4), 30))
DECODE_B, DECODE_PROMPT, DECODE_STEPS = 8, 16, 8
# the reference's 8-device compiles of tests/test_dryrun_unit.py's serving
# cells on (2, 4) but xlstm's (the SSM families' mesh steps are held by
# value against the reference's partitioned jit and by their meta traces:
# the SSM_* cells below)
HLO_CELLS = (("gemma2-9b", "prefill"), ("kimi-k2-1t-a32b", "prefill"),
             ("hubert-xlarge", "prefill"), ("gemma2-9b", "decode"),
             ("kimi-k2-1t-a32b", "decode"))


# the SSM mixers on a model axis: jamba's (mamba; its MoE at a capacity
# that drops nothing, since the expert-parallel capacity is over each
# data shard's tokens and one device's over the whole batch) and xlstm's
# (mLSTM, sLSTM) smoke configs.  Forward on (2, 4) and (4, 2) (the heads
# split 4 and 2 ways) and xlstm on (1, 8) (4 mLSTM heads on model=8: a
# head on each pair of ranks); one train step on (2, 4); a prefill and
# SSM_STEPS decode steps after a cache built by decode steps over the
# prompt on (2, 4), and xlstm on (1, 8).  The parameters are the
# reference's init (seed 0); the batch and the stream are numpy draws from
# SSM_SEED, for jamba the first seed whose every routing decision in the
# port's one-device run clears ROUTE_MARGIN (the margin rule;
# ``test_ssm_data_clears_the_routing_margin``)
SSM_ARCHS = ("jamba-1.5-large-398b", "xlstm-350m")
SSM_FORWARD_MESHES = {"jamba-1.5-large-398b": ((2, 4), (4, 2)),
                      "xlstm-350m": ((2, 4), (4, 2), (1, 8))}
SSM_TRAIN_MESH = (2, 4)
SSM_DECODE_MESHES = {"jamba-1.5-large-398b": ((2, 4),),
                     "xlstm-350m": ((2, 4), (1, 8))}
# the decode also run in f32 (``in_f32``) where its bf16 states are held
# at SSM_STATE_REL: mLSTM's head on a pair of ranks
SSM_F32_DECODE = {"xlstm-350m": (1, 8)}
SSM_B, SSM_S = 2, 32
SSM_DECODE_B, SSM_PROMPT, SSM_STEPS = 4, 16, 4
SSM_SEED = {"jamba-1.5-large-398b": {"batch": 14, "stream": 9},
            "xlstm-350m": {"batch": 0, "stream": 0}}
ROUTE_MARGIN = 1e-3


def ssm_config(arch, smoke_config):
    """``arch``'s smoke config from ``smoke_config`` (either package's),
    an MoE at the capacity that drops nothing (``E / top_k``)."""
    cfg = smoke_config(arch)
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg,
                               capacity_factor=cfg.num_experts / cfg.top_k)


def port_ssm_config(arch):
    from repro_torch import configs

    return ssm_config(arch, configs.smoke_config)


def ssm_tokens(arch, kind):
    """The SSM cells' tokens (numpy int32): ``"batch"`` [SSM_B, SSM_S]
    (the forward's input and the train step's, its labels the same), or
    ``"stream"`` [SSM_DECODE_B, SSM_PROMPT + SSM_STEPS]."""
    shape = (SSM_B, SSM_S) if kind == "batch" else \
        (SSM_DECODE_B, SSM_PROMPT + SSM_STEPS)
    return np.random.default_rng(SSM_SEED[arch][kind]).integers(
        0, 512, shape, dtype=np.int32)


@contextlib.contextmanager
def in_f32():
    """The model in f32 while active (activations, caches and the MoE and
    mamba casts: ``PDT`` of ``layers``, ``moe`` and ``ssm``), so f32
    parameters run the bf16 model's function without its roundings."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.models import ssm as SSM

    saved = L.PDT
    L.PDT = MOE.PDT = SSM.PDT = torch.float32
    try:
        yield
    finally:
        L.PDT = MOE.PDT = SSM.PDT = saved


def trace_kinds(arch):
    from repro_torch import configs

    return ("prefill", "train") if configs.smoke_config(arch).encoder_only \
        else ("prefill", "decode", "train")


def trace_cells():
    """``(arch, kind, mesh shape)`` of every traced partitioned step."""
    cells = [(arch, kind, shape) for shape in TRACE_MESHES
             for arch in TRACE_ARCHS for kind in trace_kinds(arch)]
    return cells + [(arch, kind, SSM_TRACE_MESH) for arch in SSM_ARCHS
                    for kind in trace_kinds(arch)]


def decode_tokens(arch):
    """The decode cases' token stream [B, prompt + steps] (numpy)."""
    from repro_torch import configs

    vocab = configs.smoke_config(arch).vocab_size
    return np.random.default_rng(11).integers(
        0, vocab, (DECODE_B, DECODE_PROMPT + DECODE_STEPS), dtype=np.int32)


def port_cfg(fields):
    from repro_torch.models.config import ModelConfig

    return ModelConfig(**fields)


# ---------------------------------------------------------------------------
# Inputs: the reference's draws, as tensors (made in the test process)
# ---------------------------------------------------------------------------


def inputs():
    """{name: tensors} of every cell, drawn as ``tests/test_multidevice.py``
    draws them (the reference's keys), converted bit for bit."""
    import jax
    import jax.numpy as jnp

    from repro.data import SyntheticLM
    from repro.models import layers as RL
    from repro.models import moe as RMOE
    from repro.models import train as RT
    from repro.models.config import ModelConfig as RCfg
    from repro_torch.models import model as TM

    to_t = lambda tree: jax.tree.map(lambda a: TM._tensor(np.asarray(a)),
                                     tree)
    out = {}
    mcfg = RCfg(**MOE_CFG)
    out["moe_p"] = to_t(RMOE.init_moe(jax.random.key(0), mcfg))
    out["moe_x"] = to_t(jax.random.normal(jax.random.key(1), (4, 16, 64),
                                          jnp.bfloat16))
    rcfg = RCfg(**RING_CFG)
    out["ring_p"] = to_t(jax.tree.map(lambda a: a.astype(jnp.float32),
                                      RL.init_attention(jax.random.key(7),
                                                        rcfg)))
    out["ring_x"] = to_t(jax.random.normal(jax.random.key(8), (4, 64, 48),
                                           jnp.float32))
    opt = RT.make_optimizer(**LR)
    for name, fields in (("d64", TRAIN_CFG), ("zero", ZERO_CFG)):
        state = jax.jit(lambda k, c=RCfg(**fields): RT.init_state(
            k, c, opt))(jax.random.key(0))
        out[f"params_{name}"] = to_t(state.params)
    pipe = SyntheticLM(256, batch=8, seq_len=32, seed=0)
    out["batch"], out["batch2"] = to_t(pipe.batch_at(0)), to_t(
        pipe.batch_at(1))
    out["compress_x"] = to_t(jax.random.normal(jax.random.key(5), (8, 1024),
                                               jnp.float32))
    from repro.models import model as RM
    from repro.configs import smoke_config

    for arch in sorted({a for a, _, _ in DECODE_CASES}):
        out[f"lm_{arch}"] = to_t(jax.jit(RM.init_params, static_argnums=1)(
            jax.random.key(0), smoke_config(arch)))
    for arch in SSM_ARCHS:
        out[f"ssm_{arch}"] = to_t(jax.jit(RM.init_params, static_argnums=1)(
            jax.random.key(0), ssm_config(arch, smoke_config)))
    rng = np.random.default_rng(3)
    out["moe_cot"] = torch.from_numpy(
        rng.standard_normal((4, 16, 64)).astype(np.float32))
    # the port's own MoE cell on a data axis: 8 rows, one a rank
    out["moe_x8"] = torch.from_numpy(
        rng.standard_normal((8, 16, 64)).astype(np.float32)).bfloat16()
    out["moe_cot8"] = torch.from_numpy(
        rng.standard_normal((8, 16, 64)).astype(np.float32))
    out["ring_cot"] = torch.from_numpy(
        rng.standard_normal((4, 64, 48)).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# The JAX reference (one subprocess, 8 forced host devices)
# ---------------------------------------------------------------------------


def reference_main(path):
    """``tests/test_multidevice.py`` sections 2-4 and the ZeRO cells; the
    results as numpy, pickled to ``path``."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.data import SyntheticLM
    from repro.models import layers as LY
    from repro.models import moe as MOE
    from repro.models import train as T
    from repro.models.config import ModelConfig
    from repro.optim import compressed_psum

    f32 = lambda a: np.asarray(a, np.float32)
    res = {}
    # ---- 2) sharded MoE == dense reference
    cfg = ModelConfig(**MOE_CFG)
    p = MOE.init_moe(jax.random.key(0), cfg)
    x = jax.random.normal(jax.random.key(1), (4, 16, 64), jnp.bfloat16)
    ref_moe, _ = MOE.moe_fwd_dense(p, x, cfg)
    mesh = compat.make_mesh(MOE_MESH, ("data", "model"),
                            axis_types=compat.auto_axes(2))
    with compat.set_mesh(mesh):
        got_moe, _ = jax.jit(
            lambda p, x: MOE.moe_fwd(p, x, cfg),
            in_shardings=(jax.tree.map(lambda _: NamedSharding(mesh, P()), p),
                          NamedSharding(mesh, P("data", None, None))))(p, x)
    res["moe"], res["moe_dense"] = f32(got_moe), f32(ref_moe)

    # ---- 3) sharded train step == single-device train step (+ ZeRO cells)
    opt = T.make_optimizer(**LR)
    batch = SyntheticLM(256, batch=8, seq_len=32, seed=0).batch_at(0)
    leaves = lambda tree: {
        "/".join(str(getattr(q, "key", getattr(q, "idx", q))) for q in path):
        f32(leaf) for path, leaf in
        jax.tree_util.tree_flatten_with_path(tree)[0]}
    singles = {}
    for name, fields, shape in TRAIN_CELLS:
        tcfg = ModelConfig(**fields)
        if name not in singles:
            s = T.init_state(jax.random.key(0), tcfg, opt)
            s, m = jax.jit(T.make_train_step(tcfg, opt))(s, batch)
            singles[name] = (float(m["loss"]), leaves(s.params))
        mesh2 = compat.make_mesh(shape, ("data", "model"),
                                 axis_types=compat.auto_axes(2))
        with compat.set_mesh(mesh2):
            state = T.init_state(jax.random.key(0), tcfg, opt)
            specs = T.train_state_specs(jax.eval_shape(lambda: state), mesh2,
                                        zero=True)
            sh = jax.tree.map(lambda s: NamedSharding(mesh2, s), specs,
                              is_leaf=lambda s: isinstance(s, P))
            state = jax.device_put(state, sh)
            bspec = jax.tree.map(
                lambda s: NamedSharding(mesh2, s),
                T.batch_specs(jax.eval_shape(lambda: batch), mesh2),
                is_leaf=lambda s: isinstance(s, P))
            state, m = jax.jit(T.make_train_step(tcfg, opt),
                               in_shardings=(sh, bspec),
                               out_shardings=(sh, None))(
                state, jax.device_put(batch, bspec))
        res[("train", name, shape)] = (float(m["loss"]), leaves(state.params))
    res["train_single"] = singles

    # ---- 3b) ring attention == chunked attention
    rcfg = ModelConfig(**RING_CFG)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      LY.init_attention(jax.random.key(7), rcfg))
    rx = jax.random.normal(jax.random.key(8), (4, 64, 48), jnp.float32)
    rref, _ = LY.attention_fwd(rp, rx, jnp.arange(64, dtype=jnp.int32), rcfg,
                               "attn")
    rmesh = compat.make_mesh(RING_MESH, ("data", "model"),
                             axis_types=compat.auto_axes(2))
    with compat.set_mesh(rmesh):
        rgot = jax.jit(
            lambda p, x: LY.ring_attention_block(p, x, rcfg, "attn", rmesh,
                                                 RING_MESH[1]),
            in_shardings=(jax.tree.map(lambda _: NamedSharding(rmesh, P()),
                                       rp),
                          NamedSharding(rmesh, P("data", None, None))))(rp,
                                                                        rx)
    res["ring"], res["ring_chunked"] = f32(rgot), f32(rref)

    # ---- 4) compressed_psum == psum
    mesh3 = compat.make_mesh((WORLD,), ("dp",),
                             axis_types=compat.auto_axes(1))
    xs = jax.random.normal(jax.random.key(5), (WORLD, 1024), jnp.float32)

    @functools.partial(compat.shard_map, mesh=mesh3, in_specs=P("dp"),
                       out_specs=P("dp"), check_vma=False)
    def comp(v):
        return compressed_psum(v, "dp")[None]

    res["compress"] = f32(comp(xs))
    res["compress_exact"] = f32(xs.sum(axis=0))
    res.update(_reference_ssm(leaves))
    res.update(_reference_serving())
    with open(path, "wb") as f:
        pickle.dump(res, f)


def _reference_ssm(leaves):
    """The SSM families' forward logits and one train step (its loss and
    the parameters after it) under the reference's GSPMD partitioning on
    SSM_TRAIN_MESH from the same init (seed 0): jitted with the spec
    tables' shardings of the state (ZeRO on) and of the batch."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.configs import smoke_config
    from repro.models import model as RM
    from repro.models import train as T

    named = lambda tree, mesh: jax.tree.map(
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda s: isinstance(s, P))
    res = {}
    opt = T.make_optimizer(**LR)
    mesh = compat.make_mesh(SSM_TRAIN_MESH, ("data", "model"),
                            axis_types=compat.auto_axes(2))
    for arch in SSM_ARCHS:
        cfg = ssm_config(arch, smoke_config)
        toks = jnp.asarray(ssm_tokens(arch, "batch"))
        batch = {"tokens": toks, "labels": toks}
        with compat.set_mesh(mesh):
            init = lambda k, cfg=cfg: T.init_state(k, cfg, opt)
            sh = named(T.train_state_specs(jax.eval_shape(
                init, jax.random.key(0)), mesh, zero=True), mesh)
            bsh = named(T.batch_specs(jax.eval_shape(lambda: batch), mesh),
                        mesh)
            state = jax.jit(init, out_shardings=sh)(jax.random.key(0))
            batch = jax.device_put(batch, bsh)
            logits, _ = jax.jit(lambda p, b: RM.forward(p, b, cfg),
                                in_shardings=(sh.params, {
                                    "tokens": bsh["tokens"]}))(
                state.params, {"tokens": batch["tokens"]})
            state, m = jax.jit(T.make_train_step(cfg, opt),
                               in_shardings=(sh, bsh),
                               out_shardings=(sh, None))(state, batch)
        res[("ssm_forward", arch)] = np.asarray(logits, np.float32)
        res[("ssm_train", arch)] = (float(m["loss"]), leaves(state.params))
    return res


def _reference_serving():
    """The reference's decode cases, one device and jitted with its dry
    run's shardings (``cache_specs``, ``param_specs(zero=serve_zero)``,
    the tokens' ``batch_specs``), and its HLO analysis of the serving
    cells' 8-device compiles on (2, 4)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.configs import input_specs, smoke_config
    from repro.launch import hloanalysis
    from repro.models import model as RM
    from repro.models import serve as SV
    from repro.models import train as T
    from repro.models.config import ShapeConfig
    from repro.models.sharding import param_specs

    named = lambda tree, mesh: jax.tree.map(
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda s: isinstance(s, P))
    f32 = lambda a: np.asarray(a, np.float32)
    res = {}

    def meshed(shape):
        return compat.make_mesh(shape, ("data", "model"),
                                axis_types=compat.auto_axes(2))

    def shardings(cfg, params, cache, tokens, mesh):
        return (named(param_specs(params, mesh, zero=cfg.serve_zero), mesh),
                named(T.batch_specs({"tokens": tokens}, mesh),
                      mesh)["tokens"],
                NamedSharding(mesh, P()),
                named(SV.cache_specs(cache, cfg, mesh), mesh))

    for arch in sorted({a for a, _, _ in DECODE_CASES}):
        cfg = smoke_config(arch)
        params = jax.jit(RM.init_params, static_argnums=1)(
            jax.random.key(0), cfg)
        toks = decode_tokens(arch)
        one = jax.jit(SV.make_decode_step(cfg))
        runs = [(None, L, one) for L in sorted(
            {L for a, _, L in DECODE_CASES if a == arch})]
        runs += [(shape, L, None) for a, shape, L in DECODE_CASES
                 if a == arch]
        for shape, L, step in runs:
            cache, p = RM.init_cache(cfg, DECODE_B, L), params
            if shape is not None:
                mesh = meshed(shape)
                sh = shardings(cfg, params, cache, toks[:, :1], mesh)
                step = jax.jit(SV.make_decode_step(cfg), in_shardings=sh,
                               out_shardings=(None, sh[3]),
                               donate_argnums=(3,))
                p, cache = jax.device_put(params, sh[0]), \
                    jax.device_put(cache, sh[3])
            logits = []
            for t in range(toks.shape[1]):
                lg, cache = step(p, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.int32(t), cache)
                if t >= DECODE_PROMPT - 1:
                    logits.append(f32(lg))
            res[("decode", arch, shape, L)] = {
                "logits": np.stack(logits),
                "cache": jax.tree.map(f32, cache)}

    mesh = meshed((2, 4))
    for arch, kind in HLO_CELLS:
        cfg = smoke_config(arch)
        shape = ShapeConfig(kind, TRACE_S, TRACE_B, kind)
        specs = input_specs(cfg, shape)
        params = RM.abstract_params(cfg)
        with compat.set_mesh(mesh):
            if kind == "prefill":
                fn = jax.jit(SV.make_prefill_step(cfg), in_shardings=(
                    named(param_specs(params, mesh, zero=cfg.serve_zero),
                          mesh), named(T.batch_specs(specs, mesh), mesh)))
                args = (params, specs)
            else:
                sh = shardings(cfg, params, specs["cache"], specs["tokens"],
                               mesh)
                fn = jax.jit(SV.make_decode_step(cfg), in_shardings=sh,
                             out_shardings=(None, sh[3]),
                             donate_argnums=(3,))
                args = (params, specs["tokens"], specs["pos"],
                        specs["cache"])
            text = fn.lower(*args).compile().as_text()
        ana = hloanalysis.analyze(text, WORLD)
        res[("hlo", arch, kind)] = {
            "flops": ana.flops, "collective_bytes": ana.collective_bytes,
            "per_collective": dict(ana.per_collective),
            "collective_count": ana.collective_count,
            "unresolved_loops": ana.unresolved_loops}
    return res


# ---------------------------------------------------------------------------
# The port's ranks (one spawn of WORLD gloo ranks)
# ---------------------------------------------------------------------------


def _rows(t, mesh):
    """This rank's rows of ``t`` over the batch axes."""
    n = mesh.axis_size("data")
    b = t.shape[0] // n
    return t[mesh.axis_index("data") * b:(mesh.axis_index("data") + 1) * b]


def _f32(t):
    return t.detach().float().clone()


def _moe_cell(mesh, inp, fields):
    """EP ``moe_fwd`` on ``mesh``: the output and the gradients of
    ``sum(out * cot)`` -- every leaf's and x's, gathered whole."""
    from repro_torch.launch import mesh as LM
    from repro_torch.models import moe as MOE
    from repro_torch.models import sharding as SH

    cfg = port_cfg(fields)
    specs = {"router": (None, None), "w_gate": ("model", None, None),
             "w_in": ("model", None, None), "w_out": ("model", None, None)}
    p = {k: SH.shard_leaf(v, specs[k], mesh).clone().requires_grad_()
         for k, v in inp["moe_p"].items()}
    x = _rows(inp["moe_x"], mesh).requires_grad_()
    out, aux = MOE.moe_fwd(p, x, cfg, mesh)
    torch.autograd.backward(out.float(), _rows(inp["moe_cot"], mesh))
    grads = {k: SH.gather_leaf(mesh.all_reduce(v.grad, "data"), specs[k],
                               mesh) for k, v in p.items()}
    return {"out": mesh.all_gather(out.detach(), "data"),
            "aux": float(aux.detach()), "grads": grads,
            "x_grad": mesh.all_gather(x.grad, "data")}


def _moe_data_cell(mesh, inp):
    """``moe_fwd`` on a data-only mesh (the experts whole on every rank,
    one batch row a rank): the reference's global capacity, so every
    rank routes the whole batch gathered over data and keeps its rows.
    The output, aux and the gradients of ``sum(out * cot) + aux``,
    summed over data."""
    from repro_torch.models import moe as MOE

    cfg = port_cfg(TIGHT_CFG)
    p = {k: v.clone().requires_grad_() for k, v in inp["moe_p"].items()}
    x = _rows(inp["moe_x8"], mesh).requires_grad_()
    out, aux = MOE.moe_fwd(p, x, cfg, mesh)
    loss = (out.float() * _rows(inp["moe_cot8"], mesh)).sum() + aux
    loss.backward()
    return {"out": mesh.all_gather(out.detach(), "data"),
            "aux": float(aux.detach()),
            "grads": {k: mesh.all_reduce(v.grad, "data")
                      for k, v in p.items()},
            "x_grad": mesh.all_gather(x.grad, "data")}


def _forward_cell(mesh, inp):
    """``model.forward(mesh=)`` of section 3's d64 model on this rank's
    rows: the logits gathered over vocab (model) and over data."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    cfg = port_cfg(TRAIN_CFG)
    params = inp["params_d64"]
    shards = SH.shard_tree(params, SH.param_specs(params, mesh), mesh)
    rows = {"tokens": _rows(inp["batch"]["tokens"], mesh)}
    with torch.no_grad():
        logits, _ = M.forward(T.model_params(shards, cfg), rows, cfg, mesh)
    return mesh.all_gather(logits, "data")


def _ring_cell(mesh, inp):
    """``ring_attention_block`` on ``mesh``, forward and gradient."""
    from repro_torch.models import layers as L

    cfg = port_cfg(RING_CFG)
    p = {k: v.clone().requires_grad_() for k, v in inp["ring_p"].items()}
    x = _rows(inp["ring_x"], mesh).requires_grad_()
    n = mesh.axis_size("model")
    out = L.ring_attention_block(p, x, cfg, "attn", mesh, n)
    torch.autograd.backward(out, _rows(inp["ring_cot"], mesh))
    calls = dict(mesh.calls)
    return {"out": mesh.all_gather(out.detach(), "data"),
            "grads": {k: mesh.all_reduce(v.grad, "data")
                      for k, v in p.items()},
            "x_grad": mesh.all_gather(x.grad, "data"), "calls": calls}


def _state(inp, name, mesh, fields):
    from repro_torch.models import train as T

    cfg = port_cfg(fields)
    opt = T.make_optimizer(**LR)
    params = {k: v for k, v in inp[f"params_{name}"].items()}
    whole = T.TrainState(step=torch.zeros((), dtype=torch.int32),
                         params=params, opt_state=opt.init(params))
    return cfg, opt, T.shard_state(whole, cfg, mesh, opt)


def _step_cell(mesh, inp, name, fields, batch=None, steps=1):
    """``steps`` sharded train steps from the reference's init: each
    step's metrics, the whole params after them (f32), the specs'
    ``"data"`` leaves, and the first step's gradient (synced over the
    batch axes, gathered whole)."""
    from repro_torch.checkpoint.store import _key, _leaves
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    cfg, opt, state = _state(inp, name, mesh, fields)
    step = T.make_train_step(cfg, opt, mesh=mesh)
    batch = inp["batch"] if batch is None else batch
    pspecs = T.state_specs(cfg, mesh, opt).params
    grads, _ = T._sharded_grads(
        state.params, batch, pspecs, mesh,
        lambda p, b, run: T.value_and_grad(p, b, cfg, mesh=run)[::-1])
    grads = {_key(p): _f32(v) for p, v in
             _leaves(SH.gather_tree(grads, pspecs, mesh))}
    metrics = []
    mesh.reset_calls()
    for _ in range(steps):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    calls = dict(mesh.calls)
    whole = T.gather_state(state, cfg, mesh, opt)
    specs = T.state_specs(cfg, mesh, opt).params
    data_leaves = sorted(
        _key(path) for path, _ in _leaves(whole.params)
        if "data" in SH_axes(_spec(specs, path)))
    return {"metrics": metrics, "calls": calls, "data_leaves": data_leaves,
            "grads": grads,
            "params": {_key(p): _f32(v) for p, v in _leaves(whole.params)}}


def SH_axes(spec):
    from repro_torch.models.sharding import sharded_axes

    return sharded_axes(spec)


def _spec(specs, path):
    from repro_torch.models.sharding import _spec_at

    return _spec_at(specs, path)


def _ckpt_cell(mesh_of, inp, store):
    """ZeRO cell: one step on CKPT_FROM, a sharded save, a restore onto
    each of CKPT_TO by ``remesh_restore``, the restored state gathered,
    and one more step on each mesh (and on the saving mesh)."""
    from repro_torch.checkpoint.store import _key, _leaves, save_checkpoint
    from repro_torch.launch.elastic import remesh_restore
    from repro_torch.models import train as T

    mesh = mesh_of(CKPT_FROM)
    cfg, opt, state = _state(inp, "zero", mesh, ZERO_CFG)
    state, _ = T.make_train_step(cfg, opt, mesh=mesh)(state, inp["batch"])
    flat = lambda st: {_key(p): v.clone() for p, v in _leaves(st)}
    saved = flat(T.gather_state(state, cfg, mesh, opt))
    save_checkpoint(store, 1, state, mesh=mesh,
                    specs=T.state_specs(cfg, mesh, opt))
    nxt, m = T.make_train_step(cfg, opt, mesh=mesh)(state, inp["batch2"])
    out = {"saved": saved, "next": {
        "loss": float(m["loss"]),
        "params": flat(T.gather_state(nxt, cfg, mesh, opt).params)}}
    for shape in CKPT_TO:
        new = mesh_of(shape)
        got, step = remesh_restore(store, cfg, new, optimizer=opt)
        restored = flat(T.gather_state(got, cfg, new, opt))
        got, m = T.make_train_step(cfg, opt, mesh=new)(got, inp["batch2"])
        out[shape] = {"step": step, "restored": restored,
                      "loss": float(m["loss"]),
                      "params": flat(T.gather_state(got, cfg, new,
                                                    opt).params)}
    return out


LOOP = dict(steps=4, batch=8, seq=32, log_every=0, peak_lr=1e-3,
            device="cpu")


def _loop_cell(mesh_of, store):
    """``train_loop(mesh=)``, the main path: 4 steps on (4, 2) with a
    checkpoint every 2; then the step-4 checkpoint removed and the run
    resumed from step 2 on (8, 1).  -> both runs' losses."""
    import shutil

    from repro_torch.launch import train as LT

    ckpt = os.path.join(store, "loop")
    mesh = mesh_of((4, 2))
    first = LT.train_loop(port_cfg(TRAIN_CFG), ckpt_dir=ckpt, ckpt_every=2,
                          mesh=mesh, **LOOP)["history"]
    if mesh.rank == 0:
        shutil.rmtree(os.path.join(ckpt, f"step_{LOOP['steps']:08d}"))
    mesh.barrier()
    resumed = LT.train_loop(port_cfg(TRAIN_CFG), ckpt_dir=ckpt, resume=True,
                            mesh=mesh_of((8, 1)), **LOOP)["history"]
    return {"history": first, "resumed": resumed}


def _ssm_forward_cell(mesh, inp, arch):
    """``model.forward(mesh=)`` of an SSM family's smoke config on this
    rank's rows (all of them where the batch does not split): the logits
    gathered over the batch axes, and the calls of the forward."""
    from repro_torch.models import model as M
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    cfg = port_ssm_config(arch)
    params = inp[f"ssm_{arch}"]
    specs = SH.param_specs(params, mesh)
    shards = SH.shard_tree(params, specs, mesh)
    toks = torch.from_numpy(ssm_tokens(arch, "batch"))
    run = mesh.for_batch(toks.shape[0])
    rows = T.batch_rows({"tokens": toks}, run)
    mesh.reset_calls()
    with torch.no_grad():
        logits, _ = M.forward(T.model_params(
            T.gather_zero(shards, specs, mesh), cfg), rows, cfg, run)
    calls = dict(mesh.calls)
    return {"logits": mesh.all_gather(logits, run.batch_axes(), 0),
            "calls": calls}


def _ssm_grads(mesh, params, batch, cfg):
    """One rank's ``_sharded_grads`` of ``params`` (whole, placed here by
    ``param_specs``) on ``batch``, gathered whole: ``{leaf: f32}``."""
    from repro_torch.checkpoint.store import _key, _leaves
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    specs = SH.param_specs(params, mesh)
    grads, _ = T._sharded_grads(
        SH.shard_tree(params, specs, mesh), batch, specs, mesh,
        lambda p, b, run: T.value_and_grad(p, b, cfg, mesh=run)[::-1])
    return {_key(p): _f32(v) for p, v in
            _leaves(SH.gather_tree(grads, specs, mesh))}


def _ssm_step_cell(mesh, inp, arch):
    """One sharded train step of an SSM family from the reference's init
    (``_step_cell``'s record: metrics, calls, the whole params after it,
    the synced gradient) and, for xlstm, whose bf16 gradient is held
    loosely (``SSM_GRAD_REL``), the same gradient in f32 (``in_f32``: f32
    copies of the parameters)."""
    from repro_torch.checkpoint.store import _key, _leaves
    from repro_torch.models import sharding as SH
    from repro_torch.models import train as T

    cfg = port_ssm_config(arch)
    opt = T.make_optimizer(**LR)
    params = inp[f"ssm_{arch}"]
    whole = T.TrainState(step=torch.zeros((), dtype=torch.int32),
                         params=params, opt_state=opt.init(params))
    state = T.shard_state(whole, cfg, mesh, opt)
    toks = torch.from_numpy(ssm_tokens(arch, "batch"))
    batch = {"tokens": toks, "labels": toks}
    grads = _ssm_grads(mesh, params, batch, cfg)
    grads32 = None
    if arch in SSM_F32_DECODE:
        with in_f32():
            grads32 = _ssm_grads(mesh, SH.map_leaves(
                lambda _, t: t.float(), params), batch, cfg)
    mesh.reset_calls()
    state, m = T.make_train_step(cfg, opt, mesh=mesh)(state, batch)
    calls = dict(mesh.calls)
    after = T.gather_state(state, cfg, mesh, opt)
    return {"metrics": [{k: float(v) for k, v in m.items()}],
            "calls": calls, "grads": grads, "grads_f32": grads32,
            "params": {_key(p): _f32(v) for p, v in _leaves(after.params)}}


def _ssm_decode_cell(mesh, inp, arch, f32=False):
    """The partitioned serving steps of an SSM family: the prefill step's
    last-position logits of the prompt, then the cache built by decode
    steps over the prompt and SSM_STEPS more (the logits from the
    prompt's last step on, gathered over the batch axes), the cache after
    the last (gathered), and one step's calls; ``f32``: the same in f32
    (``in_f32``, f32 copies of the parameters), its ``"f32"`` entry."""
    out = _ssm_decode(mesh, inp[f"ssm_{arch}"], arch)
    if f32:
        from repro_torch.models import sharding as SH

        with in_f32():
            out["f32"] = _ssm_decode(mesh, SH.map_leaves(
                lambda _, t: t.float(), inp[f"ssm_{arch}"]), arch)
    return out


def _ssm_decode(mesh, whole_params, arch):
    """``_ssm_decode_cell``'s record from ``whole_params``."""
    from repro_torch.checkpoint.store import _key, _leaves
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import sharding as SH

    cfg = port_ssm_config(arch)
    toks = torch.from_numpy(ssm_tokens(arch, "stream"))
    B, L = toks.shape
    params = SV.shard_params(whole_params, cfg, mesh)
    axes = mesh.for_batch(B).batch_axes()
    with torch.no_grad():
        prefill = SV.make_prefill_step(cfg, mesh)(
            params, {"tokens": toks[:, :SSM_PROMPT]})
    whole = M.init_cache(cfg, B, L, "cpu")
    specs = SV.cache_specs(whole, cfg, mesh)
    cache = SV.shard_cache(whole, cfg, mesh)
    step = SV.make_decode_step(cfg, mesh, L)
    logits = []
    for t in range(L):
        mesh.reset_calls()
        lg, cache = step(params, toks[:, t:t + 1], t, cache)
        calls = dict(mesh.calls)
        if t >= SSM_PROMPT - 1:
            logits.append(mesh.all_gather(lg, axes, 0))
    cache = SH.gather_tree(cache, specs, mesh)
    return {"prefill": mesh.all_gather(prefill, axes, 0),
            "logits": torch.stack(logits), "calls": calls,
            "cache": {_key(p): v.clone() for p, v in _leaves(cache)}}


def _real(leaf, cfg, gen):
    """A tensor of ``leaf``'s shape and dtype with values: token ids in
    the vocab, normal draws for the rest."""
    if leaf.dtype == torch.int32:
        return torch.randint(0, cfg.vocab_size, leaf.shape, generator=gen,
                             dtype=torch.int32)
    return torch.randn(leaf.shape, generator=gen).to(leaf.dtype)


def _trace_cell(mesh, arch, kind):
    """Rank 0's analysis of the partitioned step of ``kind`` (the dry
    run's ``build_cell`` on this mesh) on real shards of seeded values:
    what its meta trace must count."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import opanalysis as OA
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import train as T
    from repro_torch.models.config import ShapeConfig

    cfg = configs.smoke_config(arch)
    shape = ShapeConfig(kind, TRACE_S, TRACE_B, kind)
    fn, _ = D.build_cell(cfg, shape, mesh)
    gen = torch.Generator().manual_seed(0)
    batch = {k: _real(v, cfg, gen)
             for k, v in configs.input_specs(cfg, shape).items()
             if k not in ("pos", "cache")}
    if kind == "train":
        args = (T.shard_state(T.init_state(gen, cfg, device="cpu"), cfg,
                              mesh), batch)
    else:
        params = SV.shard_params(M.init_params(cfg, gen, "cpu"), cfg, mesh)
        args = (params, batch) if kind == "prefill" else (
            params, batch["tokens"], TRACE_S - 1, SV.shard_cache(
                M.init_cache(cfg, TRACE_B, TRACE_S, "cpu"), cfg, mesh))
    _, ana = OA.analyze(fn, *args, mesh=mesh)
    return ana.to_dict()


def _decode_cell(mesh, inp, arch, max_len):
    """The partitioned decode of ``arch``'s smoke config from the
    reference's parameters: the prompt's decode steps, then
    ``DECODE_STEPS`` more on the stream; the logits of the prompt's last
    step and of each one after (gathered over the batch axes), the cache
    after the last (gathered), and one step's calls and wire bytes."""
    from repro_torch import configs
    from repro_torch.checkpoint.store import _key, _leaves
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models import sharding as SH

    cfg = configs.smoke_config(arch)
    toks = torch.from_numpy(decode_tokens(arch))
    params = SV.shard_params(inp[f"lm_{arch}"], cfg, mesh)
    whole = M.init_cache(cfg, DECODE_B, max_len, "cpu")
    specs = SV.cache_specs(whole, cfg, mesh)
    cache = SV.shard_cache(whole, cfg, mesh)
    step = SV.make_decode_step(cfg, mesh, max_len)
    axes = mesh.for_batch(DECODE_B).batch_axes()
    logits = []
    for t in range(toks.shape[1]):
        mesh.reset_calls()
        lg, cache = step(params, toks[:, t:t + 1], t, cache)
        calls = {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes)}
        if t >= DECODE_PROMPT - 1:
            logits.append(mesh.all_gather(lg, axes, 0))
    cache = SH.gather_tree(cache, specs, mesh)
    return {"logits": torch.stack(logits), "calls": calls,
            "cache": {_key(p): v.clone() for p, v in _leaves(cache)}}


def world(pe_mesh, inp, store):
    """The rank body: every cell on the meshes it names, over the spawn's
    WORLD ranks; rank 0 returns the results."""
    from repro_torch.launch import mesh as LM
    from repro_torch.optim import compressed_psum

    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = LM.make_lm_mesh(shape, device="cpu")
        return meshes[shape]

    out = {"moe": _moe_cell(mesh_of(MOE_MESH), inp, MOE_CFG),
           "moe_tight": _moe_cell(mesh_of(MOE_MESH), inp, TIGHT_CFG)}
    out["ring"] = _ring_cell(mesh_of(RING_MESH), inp)
    out["moe_data"] = _moe_data_cell(mesh_of((8, 1)), inp)
    out["forward"] = _forward_cell(mesh_of((2, 4)), inp)
    for name, fields, shape in TRAIN_CELLS:
        out[("train", name, shape)] = _step_cell(mesh_of(shape), inp, name,
                                                 fields)
    # a batch of 6 rows does not split over data=4: the replicated batch
    six = {k: v[:6] for k, v in inp["batch"].items()}
    out["replicated"] = _step_cell(mesh_of((4, 2)), inp, "d64", TRAIN_CFG,
                                   batch=six)
    for name, fields, shape in PORT_CELLS:
        out[("train", name, shape)] = _step_cell(mesh_of(shape), inp, name,
                                                 fields)
    dp = LM.make_lm_mesh((WORLD,), ("dp",), "cpu")
    out["compress"] = compressed_psum(inp["compress_x"][dp.rank],
                                      group=dp.group("dp"))
    out["ckpt"] = _ckpt_cell(mesh_of, inp, store)
    out["train_loop"] = _loop_cell(mesh_of, store)
    for arch in SSM_ARCHS:
        for shape in SSM_FORWARD_MESHES[arch]:
            out[("ssm_forward", arch, shape)] = _ssm_forward_cell(
                mesh_of(shape), inp, arch)
        out[("ssm_train", arch)] = _ssm_step_cell(mesh_of(SSM_TRAIN_MESH),
                                                  inp, arch)
        for shape in SSM_DECODE_MESHES[arch]:
            out[("ssm_decode", arch, shape)] = _ssm_decode_cell(
                mesh_of(shape), inp, arch,
                shape == SSM_F32_DECODE.get(arch))
    for arch, kind, shape in trace_cells():
        out[("trace", arch, kind, shape)] = _trace_cell(mesh_of(shape), arch,
                                                        kind)
    for arch, shape, max_len in DECODE_CASES:
        out[("decode", arch, shape, max_len)] = _decode_cell(
            mesh_of(shape), inp, arch, max_len)
    return out
