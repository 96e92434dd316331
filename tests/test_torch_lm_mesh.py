"""The LM across processes: ``tests/test_multidevice.py`` sections 2-4 on
8 gloo ranks.

One spawn of 8 ranks builds each ``LmMesh`` over them in turn
(``torch_lm_mesh_cases.world``): expert-parallel ``moe_fwd`` on (2, 4)
and the dense path on (8, 1), ``ring_attention_block`` on (2, 4),
``model.forward`` on (2, 4), the sharded train step on (4, 2) at
``d_model=64`` and on (4, 2) and (8, 1) at ``d_model=1024`` (the ZeRO
cell: there the spec tables give parameters ``"data"`` dims), and the
port's own (2, 4) (heads split, KV heads not) and (1, 8) cells, a batch
that does not split over data, ``compressed_psum`` over the 8 ranks'
group, a sharded checkpoint saved on (4, 2) and restored by
``remesh_restore`` onto (2, 4) and (8, 1), ``train_loop(mesh=)`` with a
resume onto another mesh, and the SSM refusal.  The JAX reference runs sections 2-4 (and the ZeRO cells) in one
subprocess with 8 forced host devices, started beside the spawn, on the
same inputs (its own draws, carried across bit for bit).  Each result is
held

  * to the reference at its bars: MoE ``== 0.0``, ring attention
    ``< 2e-6``, the train step's loss ``< 1e-3`` and parameters
    ``< 2e-2`` (against the reference's sharded and single-device steps),
    ``compressed_psum``'s error ratio ``< 1.5``.  At ``d_model=1024`` the
    loss is 1030 and its f32 mean moves by 0.030 between the reference's
    own single-device and (8, 1) steps (2.9e-5 of it), so the ZeRO cell's
    loss bar is 5e-5 of the loss there;
  * to the port's one-device functions: EP ``moe_fwd`` bit for bit to
    ``moe_fwd_dense`` on each data shard's tokens (its capacity is over
    the local tokens: at ``capacity_factor=1`` it differs from one dense
    call over the whole batch, at 8 it does not), its gradients within
    1e-6 of max |grad|; ring attention within 1e-6 of ``attention_fwd``'s
    chunked attention, gradients within 2e-6 of max |grad| (f32, another
    summation order); a train step's loss within 2e-4 of |loss| (bf16
    partials summed over the model axis), its synced gradient within
    3e-2 of each leaf's max |grad| and its parameters within ``3 * lr``
    (Adam's first step is about ``-lr * sign(g)``: a sign that flips on
    a near-zero gradient moves a parameter by ``2 * lr``, and a gradient
    off by a factor moves none, hence the gradient check);
    ``compressed_psum`` bit for bit to the stacked form; a restored state
    bit for bit to the saved one.

Cheap tests with no spawn hold ``shard_leaf`` / ``gather_leaf`` round
trips on every leaf of every config's ``train_state_specs`` on (4, 2),
(2, 4) and (8, 1), with threads standing in for the ranks.
"""

import functools
import os
import pickle
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest
import torch

import torch_lm_mesh_cases as cases
from repro_torch import configs
from repro_torch.checkpoint.store import _key, _leaves
from repro_torch.core import mesh as CM
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import sharding as SH
from repro_torch.models import train as T

LOSS_BAR, PARAMS_BAR = 1e-3, 2e-2  # tests/test_multidevice.py's
ZERO_LOSS_REL = 5e-5  # of |loss| (see the module docstring)
LOSS_REL = 2e-4  # against the port's one-device step, of |loss|
PARAMS_TOL = 3 * cases.LR["peak_lr"]
GRAD_REL = 3e-2  # of a leaf's max |grad| (bf16: 2^-7 is 7.8e-3)


@functools.lru_cache(maxsize=None)
def _inputs():
    return cases.inputs()


@functools.lru_cache(maxsize=None)
def _reference_process():
    """Start the JAX reference in one subprocess with 8 forced host
    devices (``XLA_FLAGS`` stays out of this process)."""
    tmp = tempfile.TemporaryDirectory(prefix="lm_mesh_ref_")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        f"--xla_force_host_platform_device_count={cases.WORLD}"))
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(here, "..", "src"), here])
    script = ("import torch_lm_mesh_cases as c; c.reference_main("
              f"{os.path.join(tmp.name, 'ref.pkl')!r})")
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    return proc, tmp


@functools.lru_cache(maxsize=None)
def _reference():
    proc, tmp = _reference_process()
    try:
        _, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, err.decode()[-3000:]
    with open(os.path.join(tmp.name, "ref.pkl"), "rb") as f:
        return pickle.load(f)


@functools.lru_cache(maxsize=None)
def _world():
    inp = _inputs()
    _reference_process()  # the reference runs beside the spawn
    with tempfile.TemporaryDirectory(prefix="lm_mesh_ckpt_") as store:
        return CM.spawn(cases.world, cases.WORLD, inp, store, device="cpu",
                        join_timeout=600)


def _max(a, b):
    return float((torch.as_tensor(a).float()
                  - torch.as_tensor(b).float()).abs().max())


def _rel(a, b):
    """max |a - b| / max |b|."""
    return _max(a, b) / float(torch.as_tensor(b).float().abs().max())


# ---------------------------------------------------------------------------
# shard_leaf / gather_leaf round trips, threads for ranks (no spawn)
# ---------------------------------------------------------------------------


class _ThreadMesh(LM.LmMesh):
    """One rank of an ``LmMesh`` whose ranks are threads of this process:
    ``all_gather`` trades blocks on a shared board."""

    def __init__(self, shape, rank, board, barrier):
        names = ("data", "model")
        coords = dict(zip(names, LM._unravel(rank, shape)))
        super().__init__(axes=tuple(zip(names, shape)), rank=rank,
                         device=torch.device("cpu"), backend="threads",
                         coords=coords, groups={})
        self.board, self.barrier, self.turn = board, barrier, 0

    def all_gather(self, t, names, dim=0):
        g = self.axis_size(names)
        if g == 1:
            return t
        self.board[(self.turn, self.rank)] = t
        self.barrier.wait()
        rest = [n for n in self.axis_names if n not in LM._names(names)]
        peers = sorted(r for r in range(self.size) if all(
            LM._unravel(r, tuple(self.shape.values()))[self.axis_names.index(
                n)] == self.coords[n] for n in rest))
        out = torch.cat([self.board[(self.turn, r)] for r in peers], dim)
        self.barrier.wait()
        self.turn += 1
        return out


def _round_trip(shape, tree, specs):
    """Every rank's shards of ``tree`` gathered back on every rank."""
    W = shape[0] * shape[1]
    board, barrier = {}, threading.Barrier(W, timeout=60)
    got, errors = {}, []

    def rank(r):
        try:
            mesh = _ThreadMesh(shape, r, board, barrier)
            shards = SH.shard_tree(tree, specs, mesh)
            got[r] = (shards, SH.gather_tree(shards, specs, mesh))
        except BaseException as e:  # re-raised below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(W)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return got


@pytest.mark.parametrize("shape", ((4, 2), (2, 4), (8, 1)), ids=str)
def test_shard_gather_round_trip_every_config(shape):
    """Every leaf of every config's train state: each rank's block has
    the spec's shape, and the gathered blocks have the whole shape; the
    full configs' parameters on ``meta`` (their moments have the same
    specs), the smoke configs' whole state with values, which come back
    bit for bit."""
    _reference_process()  # the reference runs beside these tests
    sizes = dict(zip(("data", "model"), shape))
    mesh_spec = LM.make_mesh(shape, ("data", "model"))
    for arch in configs.ARCHS:
        for cfg, device in ((configs.get_config(arch), "meta"),
                            (configs.smoke_config(arch), "cpu")):
            state = T.init_state(torch.Generator().manual_seed(0)
                                 if device == "cpu" else None, cfg,
                                 device=device)
            specs = T.train_state_specs(T.abstract_state(cfg), mesh_spec,
                                        zero=True)
            if device == "meta":
                state, specs = state.params, specs.params
            got = _round_trip(shape, state, specs)
            whole = dict(_leaves(state))
            for r, (shards, back) in got.items():
                for path, leaf in _leaves(shards):
                    spec = SH._spec_at(specs, path)
                    want = tuple(
                        d // int(np.prod([sizes[n] for n in SH._axes_of(e)]))
                        for d, e in zip(whole[path].shape, spec))
                    assert tuple(leaf.shape) == want, (arch, path)
                for path, leaf in _leaves(back):
                    assert leaf.shape == whole[path].shape, (arch, path)
                    if device == "cpu":
                        assert torch.equal(leaf, whole[path]), (arch, path)


# ---------------------------------------------------------------------------
# Section 2: expert-parallel moe_fwd
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dense_per_shard(name):
    """``moe_fwd_dense`` on each data shard's tokens on its own, and the
    gradients of ``sum(out * cot)`` summed over the shards."""
    fields = {"moe": cases.MOE_CFG, "moe_tight": cases.TIGHT_CFG}[name]
    cfg = cases.port_cfg(fields)
    inp = _inputs()
    p = {k: v.clone().requires_grad_() for k, v in inp["moe_p"].items()}
    x = inp["moe_x"].clone().requires_grad_()
    n = cases.MOE_MESH[0]
    b = x.shape[0] // n
    out = torch.cat([MOE.moe_fwd_dense(p, x[i * b:(i + 1) * b], cfg)[0]
                     for i in range(n)])
    torch.autograd.backward(out.float(), inp["moe_cot"])
    whole = MOE.moe_fwd_dense(inp["moe_p"], inp["moe_x"], cfg)[0]
    return out.detach(), {k: v.grad for k, v in p.items()}, x.grad, whole


def test_moe_expert_parallel_vs_reference():
    assert _max(_world()["moe"]["out"], _reference()["moe"]) == 0.0


@pytest.mark.parametrize("name", ("moe", "moe_tight"))
def test_moe_expert_parallel_vs_dense_per_data_shard(name):
    """EP on (2, 4) is ``moe_fwd_dense`` on each data shard's tokens, bit
    for bit (the capacity is over the local tokens); the gradients of
    every expert leaf and of x too, and the router's within 1e-6."""
    got = _world()[name]
    want, grads, x_grad, whole = _dense_per_shard(name)
    assert torch.equal(got["out"], want)
    for k in ("w_gate", "w_in", "w_out"):
        assert torch.equal(got["grads"][k], grads[k]), k
    assert torch.equal(got["x_grad"], x_grad)
    assert _rel(got["grads"]["router"], grads["router"]) <= 1e-6
    # one dense call over the whole batch takes a global capacity: equal
    # where nothing drops, not where the per-shard capacities drop others
    if name == "moe":
        assert torch.equal(got["out"], whole)
    else:
        assert not torch.equal(got["out"], whole)


def test_moe_on_a_data_axis_is_the_global_dense_call():
    """On (8, 1) the experts do not split: every rank routes the whole
    batch (gathered over data) at the global capacity and keeps its row,
    so the output and aux are one dense call's bit for bit, at a capacity
    that drops slots; the gradients of ``sum(out * cot) + aux`` summed
    over data are its gradients (bf16 leaves summed in bf16 over 8
    ranks; x's rows get each rank's share of aux's gradient, summed by
    the gather's reduce-scatter)."""
    cfg = cases.port_cfg(cases.TIGHT_CFG)
    inp = _inputs()
    p = {k: v.clone().requires_grad_() for k, v in inp["moe_p"].items()}
    x = inp["moe_x8"].clone().requires_grad_()
    out, aux = MOE.moe_fwd_dense(p, x, cfg)
    ((out.float() * inp["moe_cot8"]).sum() + aux).backward()
    got = _world()["moe_data"]
    assert torch.equal(got["out"], out.detach())
    assert got["aux"] == float(aux)
    for k, v in p.items():
        assert _rel(got["grads"][k], v.grad) <= GRAD_REL, k
    assert _rel(got["x_grad"], x.grad) <= GRAD_REL


def test_forward_on_a_mesh():
    """``model.forward(mesh=)`` on (2, 4) (heads split 4 ways, vocab and
    ff too): the logits, gathered, within 1e-2 of max |logit| of the
    one-device forward's (the LM bound; bf16 partials summed over the
    model axis)."""
    from repro_torch.models import model as TM

    cfg = cases.port_cfg(cases.TRAIN_CFG)
    inp = _inputs()
    with torch.no_grad():
        want, _ = TM.forward(T.model_params(inp["params_d64"], cfg),
                             {"tokens": inp["batch"]["tokens"]}, cfg)
    assert _rel(_world()["forward"], want) <= 1e-2


# ---------------------------------------------------------------------------
# Section 3b: ring attention
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _chunked():
    cfg = cases.port_cfg(cases.RING_CFG)
    inp = _inputs()
    p = {k: v.clone().requires_grad_() for k, v in inp["ring_p"].items()}
    x = inp["ring_x"].clone().requires_grad_()
    out, _ = L.attention_fwd(p, x, torch.arange(64, dtype=torch.int32), cfg,
                             "attn")
    torch.autograd.backward(out, inp["ring_cot"])
    return out.detach(), {k: v.grad for k, v in p.items()}, x.grad


def test_ring_attention_vs_reference():
    assert _max(_world()["ring"]["out"], _reference()["ring"]) < 2e-6


def test_ring_attention_vs_chunked():
    got = _world()["ring"]
    out, grads, x_grad = _chunked()
    assert _rel(got["out"], out) <= 1e-6
    for k, g in grads.items():
        assert _rel(got["grads"][k], g) <= 2e-6, k
    assert _rel(got["x_grad"], x_grad) <= 2e-6
    # each rank's n-1 hops: K, V and positions forward, K and V backward
    n = cases.RING_MESH[1]
    assert got["calls"]["ring_hop"] == (3 + 2) * (n - 1)


# ---------------------------------------------------------------------------
# Section 3: the sharded train step
# ---------------------------------------------------------------------------

TRAIN_KEYS = [("train",) + cell[::2] for cell in cases.TRAIN_CELLS]


@functools.lru_cache(maxsize=None)
def _one_device(name, rows=None):
    """The port's one-device step from the reference's init: metrics, the
    params (f32) after it and its gradient."""
    fields = cases.TRAIN_CFG if name == "d64" else cases.ZERO_CFG
    cfg, opt = cases.port_cfg(fields), T.make_optimizer(**cases.LR)
    inp = _inputs()
    params = inp[f"params_{name}"]
    state = T.TrainState(step=torch.zeros((), dtype=torch.int32),
                         params=params, opt_state=opt.init(params))
    batch = {k: v[:rows] for k, v in inp["batch"].items()}
    _, grads = T.value_and_grad(params, batch, cfg)
    state, m = T.make_train_step(cfg, opt)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            {_key(p): v.float() for p, v in _leaves(state.params)},
            {_key(p): v.float() for p, v in _leaves(grads)})


def _check_step(got, want_metrics, want_params, want_grads):
    loss = want_metrics["loss"]
    assert abs(got["metrics"][0]["loss"] - loss) <= LOSS_REL * abs(loss)
    assert abs(got["metrics"][0]["grad_norm"] - want_metrics["grad_norm"]) \
        <= 1e-3 * want_metrics["grad_norm"]
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        assert _max(got["params"][k], v) <= PARAMS_TOL, k
    # the gradient before the optimizer (Adam's update hides a leaf's
    # scale): bf16 leaves summed over the batch axes in bf16 and bf16
    # partials over the model axis, so a few bf16 ulps of max |grad|
    assert set(got["grads"]) == set(want_grads)
    for k, v in want_grads.items():
        assert _rel(got["grads"][k], v) <= GRAD_REL, k


@pytest.mark.parametrize("key", TRAIN_KEYS, ids=str)
def test_train_step_vs_reference(key):
    """Against the reference's sharded step on the same mesh and its
    single-device step, at the reference's bars."""
    got = _world()[key]
    loss = got["metrics"][0]["loss"]
    bar = LOSS_BAR if key[1] == "d64" else ZERO_LOSS_REL * abs(loss)
    ref = _reference()
    for want_loss, want_params in (ref[key], ref["train_single"][key[1]]):
        assert abs(loss - want_loss) < bar
        assert set(got["params"]) == set(want_params)
        for k, v in want_params.items():
            assert _max(got["params"][k], v) < PARAMS_BAR, k


@pytest.mark.parametrize("key", TRAIN_KEYS + [
    ("train",) + cell[::2] for cell in cases.PORT_CELLS], ids=str)
def test_train_step_vs_one_device(key):
    _check_step(_world()[key], *_one_device(key[1]))


@pytest.mark.parametrize("key", TRAIN_KEYS, ids=str)
def test_zero_cell_places_data_dims(key):
    """The ZeRO cell's specs give parameters ``"data"`` dims (gathered
    before use, gradients reduce-scattered); section 3's ``d_model=64``
    gives none (no dim reaches 1024)."""
    got = _world()[key]
    if key[1] == "d64":
        assert got["data_leaves"] == []
        assert "reduce_scatter" not in got["calls"]
    else:
        assert len(got["data_leaves"]) >= 10
        assert "slots/slot00/attn/wq" in got["data_leaves"]
        assert got["calls"]["reduce_scatter"] == len(got["data_leaves"])
        assert got["calls"]["all_gather"] == len(got["data_leaves"])


def test_replicated_batch_falls_back():
    """6 rows do not split over data=4: every rank keeps the whole batch
    (the reference's replicated batch), and the step is the one-device
    step on those rows."""
    got = _world()["replicated"]
    _check_step(got, *_one_device("d64", rows=6))
    assert "reduce_scatter" not in got["calls"]


# ---------------------------------------------------------------------------
# Section 4: compressed_psum over a process group
# ---------------------------------------------------------------------------


def test_compressed_psum_over_group():
    got = _world()["compress"]
    x = _inputs()["compress_x"]
    ref = _reference()
    scale = float(x.abs().max()) / 127 * cases.WORLD
    assert _max(got, ref["compress_exact"]) / scale < 1.5
    assert _max(got, ref["compress"][0]) == 0.0
    from repro_torch.optim import compressed_psum

    assert torch.equal(got, compressed_psum(x))


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", cases.CKPT_TO, ids=str)
def test_remesh_restore(shape):
    """A state saved on (4, 2) (gathered, rank 0 writes) and restored onto
    ``shape`` by ``remesh_restore``: bit for bit the saved state, and one
    more step within the tolerances of the step on the saving mesh."""
    ck = _world()["ckpt"]
    got = ck[shape]
    assert got["step"] == 1
    assert set(got["restored"]) == set(ck["saved"])
    for k, v in ck["saved"].items():
        assert got["restored"][k].dtype == v.dtype
        assert torch.equal(got["restored"][k], v), k
    want = ck["next"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_REL * abs(want["loss"])
    for k, v in want["params"].items():
        assert _max(got["params"][k], v) <= PARAMS_TOL, k


def test_train_loop_on_mesh_and_resume():
    """The main path, ``train_loop(mesh=)``: 4 steps on (4, 2), then the
    run resumed from its step-2 checkpoint on (8, 1): every loss within
    ``LOSS_REL`` of the one-device ``train_loop``'s."""
    from repro_torch.launch import train as LT

    got = _world()["train_loop"]
    want = LT.train_loop(cases.port_cfg(cases.TRAIN_CFG), **cases.LOOP)[
        "history"]
    assert len(got["history"]) == 4 and len(got["resumed"]) == 2
    for a, b in zip(got["history"] + got["resumed"], want + want[2:]):
        assert abs(a - b) <= LOSS_REL * abs(b), (got, want)


def test_ssm_on_model_axis_raises():
    """The SSM mixers have no model-axis split: on (4, 2) an SSM family
    raises naming the ROADMAP item; on (8, 1) it passes the check."""
    for arch, msg in _world()["refusals"].items():
        assert msg is not None and "ROADMAP.md item 22" in msg, arch
