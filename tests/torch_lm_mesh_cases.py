"""Cases of ``tests/test_torch_lm_mesh.py``: the inputs (drawn by the JAX
reference, carried across as tensors), the JAX reference's side (run in
one subprocess with 8 forced host devices, ``reference_main``) and the
port's rank body (``world``, run on 8 gloo ranks by one spawn).

The reference's side runs ``tests/test_multidevice.py`` sections 2-4 as
written there, plus the ZeRO cell (section 3 at ``d_model=1024``, where
the spec tables give parameters ``"data"`` dims) on (4, 2) and (8, 1).
The rank body builds each mesh over the same 8 ranks in turn and returns,
on rank 0, every result gathered whole.  Nothing here imports JAX at
module level: the ranks import this module and must not load it.
"""

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
    with open(path, "wb") as f:
        pickle.dump(res, f)


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


def _refusals(mesh_of):
    """An SSM family on a model axis > 1 raises before any collective;
    on a data-only mesh it runs."""
    from repro_torch import configs
    from repro_torch.models import model as M

    out = {}
    for arch in ("jamba-1.5-large-398b", "xlstm-350m"):
        cfg = configs.smoke_config(arch)
        try:
            M.check_mesh(cfg, mesh_of((4, 2)))
            out[arch] = None
        except NotImplementedError as e:
            out[arch] = str(e)
        M.check_mesh(cfg, mesh_of((8, 1)))
    return out


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
    out["refusals"] = _refusals(mesh_of)
    return out
