"""Training driver: config -> mesh -> data -> train loop, with fault
tolerance (checkpoint/restart, async saves, per-step watchdog).

The port of ``repro/launch/train.py``.  Usage (any arch's SMOKE config on
the CPU; without ``--device`` it trains on the card):

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \\
        --resume --device cpu

A checkpoint is the reference's train checkpoint (``step``,
``params/...``, ``opt_state/1/mu/...``), so either package resumes the
other's.  The data pipeline is step-indexed, so a resumed run replays the
exact token stream.

``train_loop(..., mesh=)`` trains on an ``LmMesh``
(``repro_torch.launch.mesh``): every rank of the process group calls it
with its mesh; each holds its shards of the state, draws the same global
batch and takes its rows; rank 0 alone logs and writes checkpoints (the
state gathered unsharded, the others waiting at a barrier).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core.engine import resolve_device
from repro_torch.data import make_pipeline
from repro_torch.models import train as T
from repro_torch.models.config import ModelConfig


class StepWatchdog:
    """Straggler/hang mitigation at the driver level: if a step exceeds
    ``factor`` x the rolling median, log a warning (at scale: report the
    slow host to the controller for replacement; here: surface it)."""

    def __init__(self, factor: float = 3.0, warmup: int = 5):
        self.durations = []
        self.factor = factor
        self.warmup = warmup
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        if len(self.durations) < self.warmup:
            return False
        med = float(np.median(self.durations[-50:]))
        if seconds > self.factor * med:
            self.flagged += 1
            print(f"[watchdog] step took {seconds:.3f}s "
                  f"(median {med:.3f}s) -- straggler suspected")
            return True
        return False


def restore_state(ckpt_dir: str, cfg: ModelConfig, optimizer, device,
                  step: int | None = None, mesh=None):
    """The latest (or ``step``'s) train checkpoint under ``ckpt_dir`` as a
    TrainState on ``device``: ``(state, step)``; this rank's shards of it
    on an ``LmMesh`` (``mesh=``)."""
    specs = None if mesh is None else T.state_specs(cfg, mesh, optimizer)
    return restore_checkpoint(ckpt_dir, T.abstract_state(cfg, optimizer),
                              step=step, device=resolve_device(device),
                              mesh=mesh, specs=specs)


def train_loop(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
               ckpt_dir: str | None = None, resume: bool = False,
               ckpt_every: int = 50, log_every: int = 10,
               peak_lr: float = 3e-4, microbatches: int = 1,
               seed: int = 0, device=None, mesh=None) -> dict:
    """Train ``steps`` steps on CUDA unless ``device`` names another; on
    ``mesh`` (an ``LmMesh``, the reference's ``mesh=``) sharded across
    its ranks, on the mesh's device.  Each step's loss is read back to
    the host (its end on the host clock)."""
    device = resolve_device(device) if mesh is None else mesh.device
    lead = mesh is None or mesh.rank == 0
    optimizer = T.make_optimizer(peak_lr=peak_lr, warmup=min(100, steps // 10),
                                 total=steps)
    step_fn = T.make_train_step(cfg, optimizer, microbatches=microbatches,
                                mesh=mesh)
    start = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_state(ckpt_dir, cfg, optimizer, device,
                                     mesh=mesh)
        if lead:
            print(f"[train] resumed from step {start}")
    else:
        gen = torch.Generator(device=device).manual_seed(seed)
        state = T.init_state(gen, cfg, optimizer, device, mesh=mesh)

    pipe = make_pipeline(cfg, batch, seq, seed=seed, device=device)
    ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    save = {} if mesh is None else {
        "mesh": mesh, "specs": T.state_specs(cfg, mesh, optimizer)}
    watchdog = StepWatchdog()
    history = []
    t_train0 = time.time()
    for s in range(start, steps):
        t0 = time.time()
        # step-indexed pipeline: resume replays the exact stream
        state, metrics = step_fn(state, pipe.batch_at(s))
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.time() - t0
        watchdog.observe(dt)
        history.append(metrics["loss"])
        if lead and log_every and (s + 1) % log_every == 0:
            print(f"[train] step {s + 1:5d} loss={metrics['loss']:.4f} "
                  f"ce={metrics['ce']:.4f} gnorm={metrics['grad_norm']:.3f} "
                  f"{dt * 1e3:.0f}ms")
        if ckpt and (s + 1) % ckpt_every == 0:
            ckpt.save(s + 1, state, **save)
    if ckpt:
        ckpt.save(steps, state, **save)
        ckpt.wait()
    wall = time.time() - t_train0
    return {"final_loss": history[-1] if history else None,
            "first_loss": history[0] if history else None,
            "steps": steps - start, "wall_s": wall,
            "straggler_flags": watchdog.flagged,
            "history": history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--out-json", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = (configs.smoke_config if args.smoke else configs.get_config)(args.arch)
    res = train_loop(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     ckpt_dir=args.ckpt_dir, resume=args.resume,
                     ckpt_every=args.ckpt_every, peak_lr=args.peak_lr,
                     microbatches=args.microbatches, device=args.device)
    print(f"[train] done: loss {res['first_loss']:.4f} -> "
          f"{res['final_loss']:.4f} in {res['steps']} steps "
          f"({res['wall_s']:.1f}s)")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({k: v for k, v in res.items() if k != "history"}, f)
    return res


if __name__ == "__main__":
    main()
