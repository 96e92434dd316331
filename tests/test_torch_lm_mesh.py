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
resume onto another mesh, and the SSM mixers on a model axis (jamba's
and xlstm's smoke configs: forward on (2, 4), (4, 2) and xlstm's (1, 8),
one train step on (2, 4), a prefill and decode on (2, 4) and xlstm's
(1, 8); held to the port's one-device functions, the forward and step
also to the reference's GSPMD jit on (2, 4)).  Then the partitioned
steps of the dry run: the train, prefill and decode steps of gemma2,
gemma3, kimi-k2 and hubert (prefill and train) at smoke size on (2, 4)
and (4, 2), and of jamba and xlstm on (2, 4), each analyzed on rank 0 (``opanalysis.analyze(mesh=)``),
whose counts the meta trace on a trace mesh must equal exactly; and the
partitioned decode (``serve.make_decode_step(mesh=)``) of gemma2 (its 2
KV heads split the sequence over model=4, the heads over model=2) and
gemma3 (one KV head: the sequence) for 8 steps after a 16-token prefill,
past the local ring's wrap, and gemma2 on (2, 4) in a cache of 30,
whose global layers' cache stays whole on every rank (30 does not
divide over 4) beside split local rings.  The JAX reference runs sections 2-4 (and the
ZeRO cells), the decode cases (one device, and jitted with its dry run's
``cache_specs`` shardings) and the HLO analysis of its 8-device serving
compiles on (2, 4) in one subprocess with 8 forced host devices, started
beside the spawn, on the same inputs (its own draws, carried across bit
for bit).  Each result is held

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
    bit for bit to the saved one; the partitioned decode's logits within
    ``DECODE_PORT_REL`` of the port's one-device decode's (the sequence
    split's f32 combine against the one-device softmax rounded to bf16
    before its value product, and the bf16 partials summed over the model
    axis) and its gathered cache within ``CACHE_REL`` of the one-device
    cache.

The decode is held to the reference at the LM bars: 1e-2 of max |ref|
and each row's RMS error within 1e-2 of its RMS
(``tests/torch_lm_witness.py``), against both its one-device and its
sharded decode.  The per-device dot FLOPs of the serving cells on (2, 4)
equal the reference's HLO count (its partitioner and the port place
every product alike: each rank projects the one KV head its query heads
share, ``layers._local_kv``); the collective bytes are recorded beside
the reference's, not held to them (GSPMD picks its own collectives).

Cheap tests with no spawn hold ``shard_leaf`` / ``gather_leaf`` round
trips on every leaf of every config's ``train_state_specs`` on (4, 2),
(2, 4) and (8, 1), and ``shard_cache`` / ``gather_tree`` of the SSM
families' decode caches also on (1, 8), with threads standing in for
the ranks.
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
LM_BAR = 1e-2  # tests/test_serve.py:33, and the per-row RMS check
DECODE_PORT_REL = 1e-2  # mesh decode against the port's one-device one
# a cache leaf of gathered bf16 K/V against another decode's: 2e-2 of max
# |leaf|, about 4 bf16 ulps of its largest element (the K/V of a deep
# layer carry the bf16 partials summed over the model axis in the layers
# before it: 3 ulps against the port's one-device cache at gemma3's last
# layer, 1.5 against the reference's between its own two decodes)
CACHE_REL = 2e-2
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
    bit for bit.  A leaf whose last dim concatenates parts (the SSM
    mixers' ``in_proj`` / ``w_qkv``: ``sharding._PARTS``) gives each rank
    its block of every part."""
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
                    parts = getattr(spec, "parts", 1)
                    if device == "cpu" and parts > 1 and spec[-1]:
                        _check_parts(leaf, whole[path], parts, r,
                                     sizes["model"])
                for path, leaf in _leaves(back):
                    assert leaf.shape == whole[path].shape, (arch, path)
                    if device == "cpu":
                        assert torch.equal(leaf, whole[path]), (arch, path)


def _check_parts(block, whole, parts, rank, n):
    """``block`` is model rank ``rank % n``'s block of each of ``whole``'s
    ``parts`` equal parts along its last dim, in part order (the model
    axis is the last of (data, model), so the rank's index on it is
    ``rank % n``; the data axis leaves the last dim whole)."""
    i = rank % n
    want = torch.cat([part.chunk(n, -1)[i]
                      for part in whole.chunk(parts, -1)], -1)
    assert torch.equal(block, want)


@pytest.mark.parametrize("shape", ((4, 2), (2, 4), (8, 1), (1, 8)), ids=str)
def test_ssm_cache_round_trip(shape):
    """``shard_cache`` / ``gather_tree`` of the SSM families' decode
    caches (the smoke configs, with values; B=8): each rank's block has
    ``block_shape``, and the gathered cache comes back bit for bit.  On
    (1, 8) xlstm's 4 mLSTM heads sit on pairs of ranks: rank r's ``C``
    is head r // 2's value half r % 2, its ``n`` the head's whole."""
    from repro_torch.models import model as TM
    from repro_torch.models import serve as TSV

    mesh = LM.make_mesh(shape, ("data", "model"))
    for arch in cases.SSM_ARCHS:
        cfg = configs.smoke_config(arch)
        gen = torch.Generator().manual_seed(0)
        cache = SH.map_leaves(lambda _, t: torch.randn(
            t.shape, generator=gen).to(t.dtype),
            TM.init_cache(cfg, 8, 16, "cpu"))
        specs = TSV.cache_specs(cache, cfg, mesh)
        got = _round_trip(shape, cache, specs)
        whole = dict(_leaves(cache))
        for r, (shards, back) in got.items():
            for path, leaf in _leaves(shards):
                spec = SH._spec_at(specs, path)
                assert tuple(leaf.shape) == SH.block_shape(
                    whole[path].shape, spec, mesh), (arch, path)
                if getattr(spec, "within", None) and path[-1] == "C":
                    w = whole[path]
                    half = w.shape[-1] // 2
                    assert shape == (1, 8) and torch.equal(
                        leaf, w[:, :, r // 2:r // 2 + 1, :,
                                (r % 2) * half:(r % 2 + 1) * half])
                if getattr(spec, "within", None) and path[-1] == "n":
                    assert torch.equal(leaf, whole[path][:, :, r // 2:
                                                         r // 2 + 1])
            for path, leaf in _leaves(back):
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


def _check_step(got, want_metrics, want_params, want_grads,
                grad_bar=GRAD_REL, norm_bar=1e-3):
    loss = want_metrics["loss"]
    assert abs(got["metrics"][0]["loss"] - loss) <= LOSS_REL * abs(loss)
    assert abs(got["metrics"][0]["grad_norm"] - want_metrics["grad_norm"]) \
        <= norm_bar * want_metrics["grad_norm"]
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        assert _max(got["params"][k], v) <= PARAMS_TOL, k
    # the gradient before the optimizer (Adam's update hides a leaf's
    # scale): bf16 leaves summed over the batch axes in bf16 and bf16
    # partials over the model axis, so a few bf16 ulps of max |grad|
    assert set(got["grads"]) == set(want_grads)
    for k, v in want_grads.items():
        assert _rel(got["grads"][k], v) <= grad_bar, k


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


# ---------------------------------------------------------------------------
# The partitioned steps: the meta trace against rank 0's run
# ---------------------------------------------------------------------------

TRACE_KEYS = [("trace", arch, kind, shape)
              for arch, kind, shape in cases.trace_cells()]
COUNTS = ("flops_by_dtype", "bytes_accessed", "ops", "collective_calls",
          "per_collective", "per_axes")


@functools.lru_cache(maxsize=None)
def _meta_trace(arch, kind, shape):
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import opanalysis as OA
    from repro_torch.models.config import ShapeConfig

    mesh = LM.make_trace_mesh(shape)
    fn, args = D.build_cell(configs.smoke_config(arch), ShapeConfig(
        kind, cases.TRACE_S, cases.TRACE_B, kind), mesh)
    for _, t in OA.tree_leaves(args):
        assert t.device.type == "meta"
    return OA.analyze(fn, *args, mesh=mesh)[1].to_dict()


@pytest.mark.parametrize("key", TRACE_KEYS, ids=str)
def test_meta_trace_equals_rank0_run(key):
    """FLOPs by dtype, bytes, launches by op, and the collectives' calls
    and wire bytes by kind and by axes: equal, exactly."""
    got = _world()[key]
    want = _meta_trace(*key[1:])
    for field in COUNTS:
        assert got[field] == want[field], (field, got[field], want[field])
    assert want["collective_count"] > 0


@pytest.mark.parametrize("arch,kind", cases.HLO_CELLS)
def test_serving_dot_flops_vs_reference_hlo(arch, kind, record_property):
    """Per-device dot FLOPs of the serving cells on (2, 4) against the
    reference's HLO analysis of its 8-device compile: equal.  The
    collective bytes go beside the reference's, unheld."""
    got = _meta_trace(arch, kind, (2, 4))
    ref = _reference()[("hlo", arch, kind)]
    assert ref["unresolved_loops"] == 0
    assert sum(got["flops_by_dtype"].values()) == ref["flops"]
    record_property("collective_bytes", {
        "port": got["collective_bytes"], "port_calls":
            got["collective_calls"], "reference": ref["collective_bytes"],
        "reference_calls": ref["per_collective"]})
    assert got["collective_bytes"] > 0 and ref["collective_bytes"] > 0


# ---------------------------------------------------------------------------
# The partitioned decode
# ---------------------------------------------------------------------------


def _row_rms(got, want):
    """The worst row's RMS error over its RMS (rows: every dim but the
    last)."""
    g = torch.as_tensor(got).float().reshape(-1, got.shape[-1])
    w = torch.as_tensor(want).float().reshape(-1, want.shape[-1])
    err = (g - w).pow(2).mean(-1).sqrt()
    return float((err / w.pow(2).mean(-1).sqrt()).max())


@functools.lru_cache(maxsize=None)
def _one_device_decode(arch, max_len):
    """The port's one-device decode of the case's stream: the logits from
    the prompt's last step on, and the cache after the last step."""
    from repro_torch.models import model as TM

    cfg = configs.smoke_config(arch)
    params = TM.params_from_reference(_inputs()[f"lm_{arch}"], cfg,
                                      device="cpu")
    toks = torch.from_numpy(cases.decode_tokens(arch))
    cache = TM.init_cache(cfg, cases.DECODE_B, max_len, "cpu")
    logits = []
    for t in range(toks.shape[1]):
        lg, cache = TM.decode_step(params, toks[:, t:t + 1], t, cache, cfg)
        if t >= cases.DECODE_PROMPT - 1:
            logits.append(lg)
    return torch.stack(logits), {_key(p): v for p, v in _leaves(cache)}


DECODE_KEYS = [("decode",) + case for case in cases.DECODE_CASES]


@pytest.mark.parametrize("key", DECODE_KEYS, ids=str)
def test_decode_on_mesh_vs_reference(key):
    """Every step's logits against the reference's one-device decode and
    its decode jitted with the dry run's shardings on the same mesh, at
    the LM bars; the gathered cache against the reference's sharded one
    within ``CACHE_REL``."""
    _, arch, shape, max_len = key
    got = _world()[key]
    ref = _reference()
    for want in (ref[("decode", arch, None, max_len)], ref[key]):
        assert got["logits"].shape == want["logits"].shape
        assert _rel(got["logits"], want["logits"]) <= LM_BAR
        assert _row_rms(got["logits"], want["logits"]) <= LM_BAR
    flat = {"/".join(str(getattr(q, "key", q)) for q in path): leaf
            for path, leaf in __import__("jax").tree_util
            .tree_flatten_with_path(ref[key]["cache"])[0]}
    assert set(flat) == set(got["cache"])
    for k, v in got["cache"].items():
        assert _rel(v, flat[k]) <= CACHE_REL, k


def _decode_calls(arch, n, max_len):
    """The calls one partitioned decode step issues over model=n: per
    attention layer by its cache's placement (heads split: the
    attention's reduce; a split sequence: the query's gather where
    ``wq`` splits, the combine's max and sum and the attention's reduce
    where ``wo`` splits; a replicated cache: ``wq``'s gather and the
    reduce where they split), the MLP's reduce, and the vocab-split
    embedding's reduce and the logits' gather."""
    from repro_torch.models import model as TM

    cfg = configs.smoke_config(arch)
    heads = cfg.num_heads % n == 0
    calls = {"all_reduce": 1, "all_gather": 1}
    for _, _, (mixer, _) in TM.layer_blocks(cfg):
        if cfg.num_kv_heads % n == 0:
            calls["all_reduce"] += 2
            continue
        if TM._cache_len(cfg, mixer, max_len) % n == 0:  # a split sequence
            calls["all_gather"] += heads
            calls["all_reduce"] += 1 + heads + 2
        else:  # a replicated cache: wq (and bq) gathered
            calls["all_gather"] += heads * (1 + cfg.qkv_bias)
            calls["all_reduce"] += 1 + heads
    return calls


@pytest.mark.parametrize("key", DECODE_KEYS, ids=str)
def test_decode_on_mesh_vs_one_device(key):
    """Against the port's one-device decode: the logits within
    ``DECODE_PORT_REL`` and the gathered cache within ``CACHE_REL`` of
    their max; the calls of one step as the placement dictates
    (``_decode_calls``)."""
    _, arch, shape, max_len = key
    got = _world()[key]
    want, cache = _one_device_decode(arch, max_len)
    assert _rel(got["logits"], want) <= DECODE_PORT_REL
    assert set(got["cache"]) == set(cache)
    for k, v in cache.items():
        assert got["cache"][k].shape == v.shape
        assert _rel(got["cache"][k], v) <= CACHE_REL, k
    assert got["calls"]["calls"] == _decode_calls(arch, shape[1], max_len)


# ---------------------------------------------------------------------------
# The SSM mixers on a model axis (jamba: mamba; xlstm: mLSTM and sLSTM)
# ---------------------------------------------------------------------------

SSM_FORWARD_KEYS = [("ssm_forward", arch, shape) for arch in cases.SSM_ARCHS
                    for shape in cases.SSM_FORWARD_MESHES[arch]]
SSM_DECODE_KEYS = [("ssm_decode", arch, shape) for arch in cases.SSM_ARCHS
                   for shape in cases.SSM_DECODE_MESHES[arch]]
F32_GRAD_REL = 1e-4  # the f32 witness: the same function, another order


def _ssm_batch(arch, rows=None):
    toks = torch.from_numpy(cases.ssm_tokens(arch, "batch"))[:rows]
    return {"tokens": toks, "labels": toks}


@functools.lru_cache(maxsize=None)
def _ssm_one_device_forward(arch):
    from repro_torch.models import model as TM

    cfg = cases.port_ssm_config(arch)
    params = T.model_params(_inputs()[f"ssm_{arch}"], cfg)
    with torch.no_grad():
        return TM.forward(params, {"tokens": _ssm_batch(arch)["tokens"]},
                          cfg)[0]


def _route_margins(cfg, run):
    """The smallest margin between a token's k-th and (k+1)-th gate over
    every routing decision of ``run()`` (the port's router, recorded)."""
    margins = [float("inf")]
    route = MOE._route

    def recording(xt, router, c):
        got = route(xt, router, c)
        g = torch.sort(got[2], dim=-1, descending=True).values
        margins.append(float((g[:, c.top_k - 1] - g[:, c.top_k]).min()))
        return got

    MOE._route = recording
    try:
        with torch.no_grad():
            run()
    finally:
        MOE._route = route
    return min(margins)


def test_ssm_data_clears_the_routing_margin():
    """jamba's batch and stream (``cases.SSM_SEED``): every routing
    decision of the one-device forward and decode clears the next gate by
    ``ROUTE_MARGIN``, so the mesh's bf16 sums route every token alike."""
    arch = "jamba-1.5-large-398b"
    cfg = cases.port_ssm_config(arch)
    assert _route_margins(cfg, lambda: _ssm_one_device_forward.__wrapped__(
        arch)) >= cases.ROUTE_MARGIN
    assert _route_margins(cfg, lambda: _ssm_one_device_decode.__wrapped__(
        arch)) >= cases.ROUTE_MARGIN


@pytest.mark.parametrize("key", SSM_FORWARD_KEYS, ids=str)
def test_ssm_forward_on_a_mesh(key):
    """``model.forward(mesh=)`` of jamba and xlstm on a model axis (heads
    and channels split 4 or 2 ways; xlstm on (1, 8): a head on each pair
    of ranks, q and k gathered) against the one-device forward: the LM
    bars (the bf16 partials of ``out_proj`` and mamba's ``w_bc`` summed
    over the model axis)."""
    _, arch, shape = key
    got = _world()[key]
    want = _ssm_one_device_forward(arch)
    assert _rel(got["logits"], want) <= LM_BAR
    assert _row_rms(got["logits"], want) <= LM_BAR
    assert got["calls"]["all_reduce"] > 0
    # the logits' gather over vocab, each ZeRO leaf's over data, and
    # mLSTM's q and k where the model axis outnumbers the heads
    cfg = cases.port_ssm_config(arch)
    params = _inputs()[f"ssm_{arch}"]
    specs = SH.param_specs(params, LM.make_mesh(shape, ("data", "model")))
    zero = sum("data" in SH.sharded_axes(SH._spec_at(specs, path))
               for path, _ in _leaves(params))
    mlstm = sum(m == "mlstm" for m, _ in cfg.layer_pattern) \
        if shape[1] > cfg.num_heads else 0
    assert got["calls"]["all_gather"] == 1 + zero + mlstm


@pytest.mark.parametrize("arch", cases.SSM_ARCHS)
def test_ssm_forward_vs_reference(arch):
    """The (2, 4) forward against the reference's forward jitted with the
    spec tables' shardings on the same mesh (GSPMD partitions its
    mixers), at the LM bars."""
    got = _world()[("ssm_forward", arch, cases.SSM_TRAIN_MESH)]["logits"]
    want = _reference()[("ssm_forward", arch)]
    assert _rel(got, want) <= LM_BAR
    assert _row_rms(got, want) <= LM_BAR


@functools.lru_cache(maxsize=None)
def _ssm_one_device_step(arch):
    """The port's one-device step over the mesh's data shards as
    microbatches (the expert-parallel MoE's aux is each data shard's,
    averaged, as the reference's shard_map body takes it): metrics, the
    params (f32) after it, its gradient and the gradient in f32."""
    cfg, opt = cases.port_ssm_config(arch), T.make_optimizer(**cases.LR)
    params = _inputs()[f"ssm_{arch}"]
    batch = _ssm_batch(arch)
    n = cases.SSM_TRAIN_MESH[0]
    b = cases.SSM_B // n

    def grads(p):
        out = None
        for i in range(n):
            shard = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            g = {_key(q): v.float() / n for q, v in
                 _leaves(T.value_and_grad(p, shard, cfg)[1])}
            out = g if out is None else {k: out[k] + g[k] for k in out}
        return out

    grads32 = None
    if arch in cases.SSM_F32_DECODE:
        with cases.in_f32():
            grads32 = grads(SH.map_leaves(lambda _, t: t.float(), params))
    state = T.TrainState(step=torch.zeros((), dtype=torch.int32),
                         params=params, opt_state=opt.init(params))
    state, m = T.make_train_step(cfg, opt, microbatches=n)(state, batch)
    return ({k: float(v) for k, v in m.items()},
            {_key(q): v.float() for q, v in _leaves(state.params)},
            grads(params), grads32)


# xlstm's bf16 gradient is ill-conditioned at smoke size: the reference
# against itself (jit against op by op) moves a leaf by 0.4104 of its max
# |grad| (ROADMAP.md, the training notes), so its train test holds the port's
# gradient at the reference's own spread on its inputs
# (tests/test_torch_train_xlstm.py); the mesh's is held at the same 0.41
# here (the gradient norm too), and its f32 witness at F32_GRAD_REL
SSM_GRAD_REL = {"jamba-1.5-large-398b": GRAD_REL, "xlstm-350m": 0.41}
SSM_NORM_REL = {"jamba-1.5-large-398b": 1e-3, "xlstm-350m": 0.41}
SSM_LOSS_RTOL = 1e-3  # against the reference (tests/torch_train_cases.py)


@pytest.mark.parametrize("arch", cases.SSM_ARCHS)
def test_ssm_train_step_vs_one_device(arch):
    """One sharded train step on (2, 4) against the one-device step at
    ``_check_step``'s bars (xlstm's gradient at ``SSM_GRAD_REL``); mamba's
    ``w_bc`` and ``in_proj`` gradients named (the ``w_bc`` product's
    partial needs its gradient summed over the axis too:
    ``launch.mesh.sum_parts``); xlstm's every gradient in f32 within
    ``F32_GRAD_REL`` of the one-device f32 gradient."""
    got = _world()[("ssm_train", arch)]
    metrics, params, grads, grads32 = _ssm_one_device_step(arch)
    _check_step(got, metrics, params, grads, SSM_GRAD_REL[arch],
                SSM_NORM_REL[arch])
    assert (got["grads_f32"] is None) == (grads32 is None) == (
        arch not in cases.SSM_F32_DECODE)
    for k, v in (grads32 or {}).items():
        assert _rel(got["grads_f32"][k], v) <= F32_GRAD_REL, k
    named = [k for k in grads if k.endswith(("mamba/w_bc", "mamba/in_proj",
                                             "lstm/w_qkv"))]
    assert named
    for k in named:
        assert _rel(got["grads"][k], grads[k]) <= SSM_GRAD_REL[arch], k


@pytest.mark.parametrize("arch", cases.SSM_ARCHS)
def test_ssm_train_step_vs_reference(arch):
    """Against the reference's step jitted with the spec tables'
    shardings on (2, 4): the parameters within the reference's bar
    (``PARAMS_BAR``), the loss within ``SSM_LOSS_RTOL`` of it, the port's
    training tests' bar against the reference (GSPMD computes the global
    batch's MoE aux, the expert-parallel port each data shard's: jamba's
    loss moves by 8e-5 of itself)."""
    got = _world()[("ssm_train", arch)]
    want_loss, want_params = _reference()[("ssm_train", arch)]
    loss = got["metrics"][0]["loss"]
    assert abs(loss - want_loss) <= SSM_LOSS_RTOL * abs(want_loss)
    assert set(got["params"]) == set(want_params)
    for k, v in want_params.items():
        assert _max(got["params"][k], v) < PARAMS_BAR, k


@functools.lru_cache(maxsize=None)
def _ssm_one_device_decode(arch, inp=None):
    """The one-device prefill step of the stream's prompt, and the decode
    of the whole stream from an empty cache: the logits from the
    prompt's last step on and the cache after the last (from ``inp``'s
    parameters, ``_inputs()`` by default)."""
    from repro_torch.models import model as TM
    from repro_torch.models import serve as TSV

    cfg = cases.port_ssm_config(arch)
    params = T.model_params((inp or _inputs())[f"ssm_{arch}"], cfg)
    toks = torch.from_numpy(cases.ssm_tokens(arch, "stream"))
    B, L = toks.shape
    with torch.no_grad():
        prefill = TSV.make_prefill_step(cfg)(
            params, {"tokens": toks[:, :cases.SSM_PROMPT]})
        cache = TM.init_cache(cfg, B, L, "cpu")
        logits = []
        for t in range(L):
            lg, cache = TM.decode_step(params, toks[:, t:t + 1], t, cache,
                                       cfg)
            if t >= cases.SSM_PROMPT - 1:
                logits.append(lg)
    return prefill, torch.stack(logits), {_key(p): v for p, v in
                                          _leaves(cache)}


def _ssm_decode_calls(arch, n):
    """The calls of one partitioned decode step over model=n: mamba's
    ``w_bc`` sum and its ``out_proj`` reduce, mLSTM's reduce (and its q/k
    gather where n outnumbers the heads), sLSTM's reduce, the MLP's and
    the expert-parallel MoE's reduce (and its aux's mean over data), the
    attention by ``_decode_calls``, the embedding's reduce and the
    logits' gather."""
    from repro_torch.models import model as TM

    cfg = cases.port_ssm_config(arch)
    calls = {"all_reduce": 1, "all_gather": 1}
    for _, _, (mixer, mlp) in TM.layer_blocks(cfg):
        calls["all_reduce"] += {"mamba": 2, "mlstm": 1, "slstm": 1}.get(
            mixer, 0) + (mlp != "none") + (mlp == "moe")
        if mixer == "mlstm" and n > cfg.num_heads:
            calls["all_gather"] += 1
    if "attn" in [m for m, _ in cfg.layer_pattern]:
        attn = _decode_calls_of(cfg, n, cases.SSM_PROMPT + cases.SSM_STEPS)
        for k, v in attn.items():
            calls[k] += v
    return calls


def _decode_calls_of(cfg, n, max_len):
    """``_decode_calls``' attention terms of ``cfg``'s attention layers."""
    from repro_torch.models import model as TM

    heads = cfg.num_heads % n == 0
    calls = {"all_reduce": 0, "all_gather": 0}
    for _, _, (mixer, _) in TM.layer_blocks(cfg):
        if mixer not in ("attn", "local"):
            continue
        if cfg.num_kv_heads % n == 0:
            calls["all_reduce"] += 1
        elif TM._cache_len(cfg, mixer, max_len) % n == 0:
            calls["all_gather"] += heads
            calls["all_reduce"] += heads + 2
        else:
            calls["all_gather"] += heads * (1 + cfg.qkv_bias)
            calls["all_reduce"] += heads
    return calls


# an SSM state (f32) of the bf16 decode against one device's: the
# recurrence integrates the bf16 partials of every step before it (xlstm's
# last sLSTM cell state after 20 steps: 2.01e-2 of its max on (2, 4)), so
# GRAD_REL's few bf16 ulps of max; the f32 witness holds the path itself
SSM_STATE_REL = GRAD_REL
F32_DECODE_REL = 1e-5


@functools.lru_cache(maxsize=None)
def _ssm_one_device_decode_f32(arch):
    inp = _inputs()
    f32 = dict(inp)
    f32[f"ssm_{arch}"] = SH.map_leaves(lambda _, t: t.float(),
                                       inp[f"ssm_{arch}"])
    with cases.in_f32():
        return _ssm_one_device_decode.__wrapped__(arch, f32)


def _check_ssm_decode(got, want, state_rel):
    prefill, logits, cache = want
    assert _rel(got["prefill"], prefill) <= DECODE_PORT_REL
    assert got["logits"].shape == logits.shape
    assert _rel(got["logits"], logits) <= DECODE_PORT_REL
    assert set(got["cache"]) == set(cache)
    for k, v in cache.items():
        assert got["cache"][k].shape == v.shape
        bar = CACHE_REL if k.endswith(("/k", "/v")) else state_rel
        assert _rel(got["cache"][k], v) <= bar, k


@pytest.mark.parametrize("key", SSM_DECODE_KEYS, ids=str)
def test_ssm_decode_on_mesh_vs_one_device(key):
    """The partitioned prefill and decode of jamba and xlstm against the
    one-device steps: the prefill's and every decode step's logits
    within ``DECODE_PORT_REL`` of their max, the gathered cache (each SSM
    state where the mixer's split keeps it, ``serve.cache_specs``) within
    ``CACHE_REL`` (K/V) and ``SSM_STATE_REL`` (the SSM states); one
    step's calls as the placement dictates.  Where the case also ran in
    f32, its logits and every cache leaf within ``F32_DECODE_REL``."""
    _, arch, shape = key
    got = _world()[key]
    _check_ssm_decode(got, _ssm_one_device_decode(arch), SSM_STATE_REL)
    assert got["calls"] == _ssm_decode_calls(arch, shape[1])
    assert ("f32" in got) == (shape == cases.SSM_F32_DECODE.get(arch))
    if "f32" in got:
        f32 = _ssm_one_device_decode_f32(arch)
        assert _rel(got["f32"]["logits"], f32[1]) <= F32_DECODE_REL
        assert _rel(got["f32"]["prefill"], f32[0]) <= F32_DECODE_REL
        for k, v in f32[2].items():
            assert _rel(got["f32"]["cache"][k], v) <= F32_DECODE_REL, k
