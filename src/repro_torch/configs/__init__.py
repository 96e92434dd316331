"""Experiment configurations of the port: the paper's graphs, strategies and
sweeps (``graphs``), and the assigned LM architectures.

The LM half is the twin of ``repro.configs``: ``get_config(name)`` /
``smoke_config(name)`` / ``input_specs(cfg, shape)``; shape cells in
``repro_torch.models.config.SHAPES``.  Every architecture module defines
CONFIG (the exact assigned configuration) and SMOKE (a reduced same-family
config for CPU tests).  ``all_cells`` enumerates the 40 (arch x shape)
cells with their runnable/skip status per DESIGN.md section 4 (long_500k
only for sub-quadratic-capable archs; no decode for encoder-only archs).
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, ShapeConfig, SHAPES

ARCHS = (
    "jamba-1.5-large-398b",
    "granite-20b",
    "gemma3-1b",
    "qwen1.5-4b",
    "gemma2-9b",
    "kimi-k2-1t-a32b",
    "llama4-scout-17b-a16e",
    "paligemma-3b",
    "xlstm-350m",
    "hubert-xlarge",
)

_MODULES = {name: "repro_torch.configs." + name.replace("-", "_")
            .replace(".", "_") for name in ARCHS}


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list(ARCHS)}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _mod(name).CONFIG


def smoke_config(name: str) -> ModelConfig:
    return _mod(name).SMOKE


def list_archs():
    return list(ARCHS)


# ---------------------------------------------------------------------------
# Cell enumeration (arch x shape) with skip reasons
# ---------------------------------------------------------------------------


def cell_status(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """'run' or a 'skip: <reason>' string, per DESIGN.md section 4."""
    if cfg.encoder_only and shape.kind == "decode":
        return "skip: encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return "skip: pure full-attention arch; 500k decode KV impractical" \
               " (sub-quadratic archs only, per brief)"
    return "run"


def all_cells():
    """Yields (arch, shape_name, status) for all 40 cells."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            yield arch, sname, cell_status(cfg, shape)


# ---------------------------------------------------------------------------
# Input specs (meta tensors -- no allocation)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                train: bool | None = None):
    """Abstract model inputs for one cell, as tensors on the ``meta``
    device (shape and dtype, no storage):

    train cells:   {"tokens"/"frames"/..., "labels"}
    prefill cells: the same minus labels
    decode cells:  {"tokens": [B,1], "pos": scalar, "cache": <tree>}
    """
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.frontends import audio_spec, vision_spec

    B, S = shape.global_batch, shape.seq_len
    train = shape.kind == "train" if train is None else train
    ints = lambda *dims: torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind == "decode":
        return {"tokens": ints(B, 1), "pos": ints(),
                "cache": M.init_cache(cfg, B, S, device="meta")}

    if cfg.frontend == "audio":
        specs = {"frames": audio_spec(cfg, B, S)}
    elif cfg.frontend == "vision":
        specs = {"tokens": ints(B, S - cfg.frontend_len),
                 "patches": vision_spec(cfg, B)}
    else:
        specs = {"tokens": ints(B, S)}
    if train:
        specs["labels"] = ints(B, S)
    return specs
