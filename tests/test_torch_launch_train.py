"""The port's training launchers, on the CPU.

* ``train_loop``: four steps straight against two, a checkpoint and a
  resume for the other two -- the losses bit for bit (step-indexed data,
  the whole state in the checkpoint);
* train checkpoints across packages: a state the reference writes
  (``repro.checkpoint.save_checkpoint`` of its ``TrainState``, moments
  after one update) restores into the port's ``TrainState`` bit for bit,
  and a state the port writes restores into the reference's;
* ``StepWatchdog`` and ``plan_elastic_batch`` against the reference's;
* ``remesh_restore``: the reference's elastic test (train on 8, resume on
  4 at twice the microbatches) on mesh descriptors;
* the CLI, ``python -m repro_torch.launch.train ... --device cpu``.
"""

import functools
import json
import os
import shutil
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as RCK
from repro import optim as RO
from repro.launch import elastic as RE
from repro.launch import train as RLT
from repro.models import model as RM
from repro.models import train as RT
from repro.models.config import ModelConfig as RModelConfig
from repro_torch import checkpoint as TCK
from repro_torch.data import SyntheticLM
from repro_torch.launch import elastic as TE
from repro_torch.launch import train as TLT
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import train as TT
from repro_torch.models.config import ModelConfig
from torch_train_cases import as_f32, port_leaves, ref_leaves, to_port

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(name="t", family="dense", num_layers=3, d_model=64, num_heads=4,
          num_kv_heads=2, d_ff=128, vocab_size=256,
          layer_pattern=(("local", "dense"), ("attn", "dense")),
          tail_pattern=(("attn", "dense"),), window=8)
CFG, RCFG = ModelConfig(**KW), RModelConfig(**KW)


def test_train_loop_resume_is_bit_exact(tmp_path):
    straight = TLT.train_loop(CFG, steps=4, batch=4, seq=16, device="cpu",
                              ckpt_dir=str(tmp_path / "a"), ckpt_every=2,
                              log_every=0, peak_lr=1e-2)
    assert TCK.latest_step(str(tmp_path / "a")) == 4
    TLT.train_loop(CFG, steps=4, batch=4, seq=16, device="cpu",
                   ckpt_dir=str(tmp_path / "b"), ckpt_every=2, log_every=0,
                   peak_lr=1e-2)
    # drop the final checkpoint: resume from step 2's
    shutil.rmtree(tmp_path / "b" / "step_00000004")
    resumed = TLT.train_loop(CFG, steps=4, batch=4, seq=16, device="cpu",
                             ckpt_dir=str(tmp_path / "b"), resume=True,
                             log_every=0, peak_lr=1e-2)
    assert resumed["steps"] == 2
    assert resumed["history"] == straight["history"][2:]
    assert straight["history"][-1] < straight["history"][0]
    a = TCK.restore_checkpoint(str(tmp_path / "a"),
                               TT.abstract_state(CFG), device="cpu")[0]
    b = TCK.restore_checkpoint(str(tmp_path / "b"),
                               TT.abstract_state(CFG), device="cpu")[0]
    for (path, x), (_, y) in zip(TCK.store._leaves(a),
                                 TCK.store._leaves(b)):
        assert torch.equal(x, y), path


@functools.lru_cache(maxsize=None)
def _reference_state():
    """The reference's TrainState after one AdamW update of random
    gradients (nonzero moments, count 1), with its step set to 1."""
    opt = RT.make_optimizer(peak_lr=1e-3, warmup=2, total=10)

    @jax.jit
    def one_update(key, grads):
        state = RT.init_state(key, RCFG, opt)
        updates, opt_state = opt.update(grads, state.opt_state, state.params)
        return RT.TrainState(step=state.step + 1,
                             params=RO.apply_updates(state.params, updates),
                             opt_state=opt_state)

    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda p: jax.numpy.asarray(
        rng.standard_normal(p.shape), p.dtype), RM.abstract_params(RCFG))
    return one_update(jax.random.key(3), grads)


def test_reference_train_checkpoint_restores_bit_exact(tmp_path):
    state = _reference_state()
    RCK.save_checkpoint(str(tmp_path), 1, state)
    got, step = TLT.restore_state(str(tmp_path), CFG, TT.make_optimizer(),
                                  "cpu")
    assert step == 1 and isinstance(got, TT.TrainState)
    want = ref_leaves(state)
    have = port_leaves(got)
    assert set(have) == set(want)
    assert "opt_state/1/mu/slots/slot00/attn/wq" in have
    for key, w in want.items():
        w = np.asarray(w)
        assert str(have[key].dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(as_f32(have[key]), as_f32(w),
                                      err_msg=key)


def test_port_train_checkpoint_restores_in_reference_bit_exact(tmp_path):
    state = TT.TrainState(step=torch.tensor(1, dtype=torch.int32),
                          params=None, opt_state=None)
    ref = _reference_state()
    state.params, state.opt_state = to_port(ref.params), to_port(ref.opt_state)
    TCK.save_checkpoint(str(tmp_path), 1, state)
    got, step = RCK.restore_checkpoint(str(tmp_path),
                                       RT.abstract_state(RCFG))
    assert step == 1
    want = port_leaves(state)
    for key, leaf in ref_leaves(got).items():
        np.testing.assert_array_equal(as_f32(leaf), as_f32(want[key]),
                                      err_msg=key)


def test_step_watchdog_equals_reference(capsys):
    durations = [1.0, 1.1, 0.9, 1.0, 1.05, 5.0, 1.0, 0.2, 4.0, 3.1, 10.0]
    for factor, warmup in ((3.0, 5), (2.0, 3), (1.5, 1)):
        rw, tw = RLT.StepWatchdog(factor, warmup), TLT.StepWatchdog(factor,
                                                                    warmup)
        assert [tw.observe(d) for d in durations] == \
            [rw.observe(d) for d in durations]
        assert tw.flagged == rw.flagged > 0
    assert "straggler suspected" in capsys.readouterr().out


def test_plan_elastic_batch_equals_reference():
    for args in ((256, 16, 8, 1), (256, 16, 8, 2), (8, 8, 4, 1),
                 (64, 4, 4, 3), (64, 2, 8, 1), (30, 6, 3, 2)):
        assert TE.plan_elastic_batch(*args) == RE.plan_elastic_batch(*args)
    with pytest.raises(ValueError):
        TE.plan_elastic_batch(10, 8, 4)
    with pytest.raises(ValueError):
        RE.plan_elastic_batch(10, 8, 4)


def test_remesh_restore_continues_the_trajectory(tmp_path):
    """tests/test_elastic.py on the port: 5 steps on an 8-wide data mesh,
    a checkpoint, the rest on a 4-wide mesh at twice the microbatches;
    the losses track the uninterrupted run within 0.05."""
    opt = TT.make_optimizer(peak_lr=1e-3, warmup=2, total=40)
    pipe = SyntheticLM(256, batch=8, seq_len=32, seed=0, device="cpu")
    step = TT.make_train_step(CFG, opt)

    def fresh():
        return TT.init_state(torch.Generator().manual_seed(0), CFG, opt,
                             device="cpu")

    state, ref_losses = fresh(), []
    for s in range(10):
        state, m = step(state, pipe.batch_at(s))
        ref_losses.append(float(m["loss"]))
    state = fresh()
    for s in range(5):
        state, _ = step(state, pipe.batch_at(s))
    TCK.save_checkpoint(str(tmp_path), 5, state)
    state4, start = TE.remesh_restore(str(tmp_path), CFG,
                                      make_host_mesh(4), optimizer=opt,
                                      device="cpu")
    assert start == 5 and int(state4.step) == 5
    _, mb = TE.plan_elastic_batch(8, old_dp=8, new_dp=4)
    assert mb == 2
    step4 = TT.make_train_step(CFG, opt, microbatches=mb)
    deltas = []
    for s in range(start, 10):
        state4, m = step4(state4, pipe.batch_at(s))
        deltas.append(abs(float(m["loss"]) - ref_losses[s]))
    assert max(deltas) < 0.05, deltas


def test_cli_trains_a_smoke_arch_on_the_cpu(tmp_path):
    out = tmp_path / "res.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gemma3-1b", "--smoke", "--steps", "4", "--batch", "2", "--seq",
         "32", "--device", "cpu", "--out-json", str(out), "--ckpt-dir",
         str(tmp_path / "ck")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] done" in proc.stdout
    res = json.loads(out.read_text())
    assert res["steps"] == 4 and np.isfinite(res["final_loss"])
    assert TCK.latest_step(str(tmp_path / "ck")) == 4
