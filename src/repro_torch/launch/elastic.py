"""Elastic scaling: checkpoint-mediated re-meshing after capacity change.

The port of ``repro/launch/elastic.py``.  The contract that makes
elasticity work (DESIGN.md section 5):
  1. checkpoints are *mesh-agnostic* -- leaves are saved unsharded, so any
     mesh can load them (``repro_torch.checkpoint``);
  2. the data pipeline is *step-indexed* -- ``batch_at(step)`` is pure, so
     the resumed job replays the stream exactly with no data state;
  3. shardings are *derived from the mesh*, not stored --
     ``train_state_specs(mesh)`` recomputes the placement for whatever mesh
     survives.

``remesh_restore`` restores onto an ``LmMesh`` (``repro_torch.launch.mesh``,
the ranks of the surviving process group) for real: each rank keeps its
shards under the new mesh's ``train_state_specs``.  A ``MeshSpec``
descriptor places nothing: the state lands whole on one device.
"""

from __future__ import annotations

from repro_torch.launch.mesh import LmMesh
from repro_torch.launch.train import restore_state
from repro_torch.models import train as T


def remesh_restore(ckpt_dir: str, cfg, new_mesh, optimizer=None,
                   device=None):
    """Restore the latest checkpoint onto ``new_mesh`` (any shape/size).
    On an ``LmMesh`` every rank calls it and keeps its shards under
    ``train_state_specs(abstract_state(cfg), new_mesh, zero=cfg.zero)``,
    on the mesh's device; a ``MeshSpec`` places nothing, and the state
    lands whole on ``device`` (CUDA unless it names another).

    Returns (state, step). Batch size must stay divisible by the new data
    axes; callers adjust microbatching to keep the global batch constant
    (gradient-equivalent elasticity).
    """
    optimizer = optimizer or T.make_optimizer()
    if isinstance(new_mesh, LmMesh):
        return restore_state(ckpt_dir, cfg, optimizer, new_mesh.device,
                             mesh=new_mesh)
    return restore_state(ckpt_dir, cfg, optimizer, device)


def plan_elastic_batch(global_batch: int, old_dp: int, new_dp: int,
                       microbatches: int = 1):
    """Keep the global batch (and thus the optimizer trajectory) constant
    when the data-parallel width changes: scale microbatching instead.

    Returns (per_step_batch, new_microbatches).  E.g. 256 @ dp=16 mb=1
    -> dp=8 gives mb=2: each device processes 2x the tokens per step,
    gradients are identical in expectation and the step count is unchanged.
    """
    if global_batch % new_dp:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"surviving dp width {new_dp}")
    scale = max(1, old_dp // max(new_dp, 1))
    return global_batch, microbatches * scale
