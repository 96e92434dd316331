"""The port's synthetic data pipeline, on the CPU.

The twin of ``tests/test_data.py``.  The port draws from
``torch.Generator``s, not threefry, so its tokens are not the
reference's; it keeps the reference's properties: determinism per
(seed, step) -- the restart contract --, different streams for other
steps and seeds, tokens in range, bigram structure far above the iid
floor, the frontends' batch shapes, and the reference's zipf prior and
bigram sizes.
"""

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import SyntheticLM, batch_for_shape, make_pipeline
from repro_torch.models.config import ShapeConfig


def _lm(*args, **kw):
    return SyntheticLM(*args, device="cpu", **kw)


def test_step_indexed_determinism():
    p1 = _lm(512, batch=4, seq_len=32, seed=7)
    p2 = _lm(512, batch=4, seq_len=32, seed=7)
    for step in (0, 5, 1000):
        assert torch.equal(p1.batch_at(step)["tokens"],
                           p2.batch_at(step)["tokens"])
    # a pipeline's own history does not matter: step 5 after 1000
    assert torch.equal(p1.batch_at(5)["tokens"], p2.batch_at(5)["tokens"])


def test_different_steps_differ():
    p = _lm(512, batch=4, seq_len=32, seed=7)
    assert not torch.equal(p.batch_at(1)["tokens"], p.batch_at(2)["tokens"])


def test_seed_changes_stream():
    a = _lm(512, 2, 16, seed=1).batch_at(0)["tokens"]
    b = _lm(512, 2, 16, seed=2).batch_at(0)["tokens"]
    assert not torch.equal(a, b)


def test_tokens_in_range_and_labels():
    p = _lm(512, batch=8, seq_len=64, seed=0)
    b = p.batch_at(3)
    t = b["tokens"]
    assert t.dtype == torch.int32 and t.shape == (8, 64)
    assert int(t.min()) >= 0 and int(t.max()) < 512
    assert torch.equal(b["labels"], t)
    # the bigram lives in the head of the zipf: active_vocab caps the ids
    big = _lm(262_144, batch=2, seq_len=16, seed=0)
    assert big.v_eff == 4096 and int(big.batch_at(0)["tokens"].max()) < 4096


def test_bigram_structure_is_learnable():
    """Adjacent-token mutual information must be far above the iid floor --
    otherwise the training examples can't show a falling loss."""
    p = _lm(256, batch=64, seq_len=64, seed=0, active_vocab=256)
    t = p.batch_at(0)["tokens"].numpy()
    x, y = t[:, :-1].ravel(), t[:, 1:].ravel()
    xb, yb = x % 16, y % 16
    joint = np.zeros((16, 16))
    np.add.at(joint, (xb, yb), 1)
    joint /= joint.sum()
    px, py = joint.sum(1), joint.sum(0)
    mi = np.nansum(joint * np.log((joint + 1e-12) / (px[:, None] * py[None, :]
                                                     + 1e-12)))
    assert mi > 0.05, f"bigram MI too low: {mi}"


def test_first_token_follows_the_zipf_prior():
    """Token 0 is the zipf head: it leads the first position's counts."""
    t = _lm(512, batch=512, seq_len=2, seed=3).batch_at(0)["tokens"][:, 0]
    counts = torch.bincount(t.long(), minlength=512)
    assert int(counts.argmax()) == 0 and int(counts[0]) > 512 // 10


def test_batch_for_shape_frontends():
    shape = ShapeConfig("s", seq_len=64, global_batch=2, kind="train")
    cfg = configs.smoke_config("hubert-xlarge")
    b = batch_for_shape(cfg, shape, device="cpu")
    assert b["frames"].shape == (2, 64, cfg.d_model)
    assert b["labels"].shape == (2, 64)
    cfg = configs.smoke_config("paligemma-3b")
    b = batch_for_shape(cfg, shape, device="cpu")
    assert b["tokens"].shape == (2, 64 - cfg.frontend_len)
    assert b["patches"].shape == (2, cfg.frontend_len, cfg.d_model)
    assert b["labels"].shape == (2, 64)
    again = batch_for_shape(cfg, shape, device="cpu")
    assert all(torch.equal(b[k], again[k]) for k in b)
    b = batch_for_shape(configs.smoke_config("gemma3-1b"), shape,
                        device="cpu")
    assert b["tokens"].shape == (2, 64)


@pytest.mark.parametrize("arch", ("gemma3-1b", "hubert-xlarge",
                                  "paligemma-3b"))
def test_make_pipeline_is_step_indexed(arch):
    cfg = configs.smoke_config(arch)
    pipe = make_pipeline(cfg, 2, 48, seed=5, device="cpu")
    a, b = pipe.batch_at(4), pipe.batch_at(4)
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["labels"], pipe.batch_at(5)["labels"])
