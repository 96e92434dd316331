"""The port's tensor-tree checkpoint store against the JAX reference, on the
CPU.

The twins of the ten tree cells of ``tests/test_checkpoint.py`` (exact
round trip, bf16 bits, latest + GC, crashed writers, shape and leaf
mismatches, the async writer and its failure), on torch trees, and the
cells that hold the file format shared: a step written by ``repro`` restores
bit for bit in the port, and one written by the port restores bit for bit
in ``repro``, bf16 included; and the reference's LM parameters, written by
``repro`` and restored by the port through ``params_from_reference``,
equal the direct conversion bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.checkpoint import restore_checkpoint as rrestore
from repro.checkpoint import save_checkpoint as rsave
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import _leaves, _list_steps
from repro_torch.models import model as TM


def tree():
    return {
        "a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "nested": {"b": torch.ones((2, 2), dtype=torch.bfloat16) * 1.5,
                   "c": torch.tensor(7, dtype=torch.int32)},
        "list": [torch.zeros((5,), dtype=torch.float16)],
    }


def rtree():
    """The reference test's tree, in JAX."""
    return {
        "a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
        "nested": {"b": jnp.ones((2, 2), jnp.bfloat16) * 1.5,
                   "c": jnp.asarray(7, jnp.int32)},
        "list": [jnp.zeros((5,), jnp.float16)],
    }


def meta(t):
    """The tree's shapes and dtypes without storage (``jax.eval_shape``)."""
    if isinstance(t, dict):
        return {k: meta(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(meta(v) for v in t)
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def same_trees(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype
        assert np.array_equal(bits(x), bits(y))


def test_roundtrip_exact(tmp_path):
    t = tree()
    save_checkpoint(str(tmp_path), 3, t)
    restored, step = restore_checkpoint(str(tmp_path), meta(t), device="cpu")
    assert step == 3
    same_trees(t, restored)
    # a tree of real tensors places each leaf on its own device
    again, _ = restore_checkpoint(str(tmp_path), t)
    same_trees(t, again)


def test_bf16_preserved_bitwise(tmp_path):
    t = {"w": (torch.arange(64, dtype=torch.float32) * 0.1).to(torch.bfloat16)}
    save_checkpoint(str(tmp_path), 1, t)
    r, _ = restore_checkpoint(str(tmp_path), meta(t), device="cpu")
    assert np.array_equal(bits(t["w"]), bits(r["w"]))


def test_latest_and_gc(tmp_path):
    t = tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    assert latest_step(str(tmp_path)) == 5
    assert sorted(_list_steps(str(tmp_path))) == [4, 5]


def test_crashed_tmp_ignored(tmp_path):
    os.makedirs(tmp_path / "step_00000009.tmp_junk")
    save_checkpoint(str(tmp_path), 1, tree())
    assert latest_step(str(tmp_path)) == 1
    assert not any(".tmp_" in n for n in os.listdir(tmp_path))


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), meta({"w": torch.zeros((5,))}),
                           device="cpu")


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), meta({"w": torch.zeros((4,)),
                                                "extra": torch.zeros((1,))}),
                           device="cpu")


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = tree()
    for s in (10, 20, 30):
        ck.save(s, t)
    ck.wait()
    assert latest_step(str(tmp_path)) == 30
    assert sorted(_list_steps(str(tmp_path))) == [20, 30]
    r, _ = restore_checkpoint(str(tmp_path), meta(t), device="cpu")
    same_trees(t, r)
    # the snapshot is taken at save(): a later in-place update is not saved
    w = {"w": torch.zeros(4)}
    ck.save(40, w)
    w["w"].add_(1)
    ck.wait()
    r, _ = restore_checkpoint(str(tmp_path), meta(w), device="cpu")
    assert float(r["w"].abs().max()) == 0.0


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), {"w": torch.zeros(1)})


def test_missing_leaves_named_up_front(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    want = meta({"w": torch.zeros((4,)),
                 "opt": {"mu": torch.zeros((4,)), "nu": torch.zeros((4,))}})
    with pytest.raises(KeyError) as exc:
        restore_checkpoint(str(tmp_path), want, device="cpu")
    msg = str(exc.value)
    assert "2 leaves" in msg and "opt/mu" in msg and "opt/nu" in msg


def test_async_writer_failure_reraised(tmp_path, monkeypatch):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)

    def boom(*a, **k):
        raise OSError("disk full (injected)")

    monkeypatch.setattr(store.np, "savez", boom)
    ck.save(1, {"w": torch.zeros((4,))})
    with pytest.raises(OSError, match="injected"):
        ck.wait()
    monkeypatch.undo()
    ck.wait()  # error was cleared by the raise; the writer is reusable
    ck.save(2, {"w": torch.zeros((4,))})
    ck.wait()
    assert latest_step(str(tmp_path)) == 2
    assert not any(".tmp_" in n for n in os.listdir(tmp_path))


# ---------------------------------------------------------------------------
# The file format, shared with the reference
# ---------------------------------------------------------------------------


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def test_reference_step_restores_bit_exact(tmp_path):
    """repro writes, the port reads: the same leaves, paths, dtypes and
    bits (bf16 decoded through torch, without ml_dtypes)."""
    r = rtree()
    r["w"] = (jnp.arange(64, dtype=jnp.float32) * 0.1).astype(jnp.bfloat16)
    rsave(str(tmp_path), 7, r)
    like = meta(tree()) | {"w": torch.empty(64, dtype=torch.bfloat16,
                                            device="meta")}
    got, step = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert step == 7
    rl = jax.tree_util.tree_flatten_with_path(r)[0]
    tl = list(_leaves(got))
    assert len(rl) == len(tl)
    for (_, t), (_, a) in zip(tl, rl):
        assert str(t.dtype).removeprefix("torch.") == str(a.dtype)
        assert np.array_equal(bits(t), _ref_bits(a))
    # and the keys meta.json lists are the reference's own
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as z:
        assert "__dtype__/w" in z.files and "nested/b" in z.files


def test_port_step_restores_bit_exact_in_reference(tmp_path):
    """The port writes, repro reads: its bf16 leaves come back as
    ml_dtypes bfloat16 with the port's bits."""
    t = tree()
    t["w"] = (torch.arange(64, dtype=torch.float32) * 0.1).to(torch.bfloat16)
    t["pair"] = (torch.full((3,), -2.5),
                 torch.tensor([1, 2], dtype=torch.int32))
    save_checkpoint(str(tmp_path), 4, t)
    want = jax.tree.map(lambda a: jax.ShapeDtypeStruct(
        a.shape, jnp.dtype(str(a.dtype).removeprefix("torch."))),
        t, is_leaf=lambda a: isinstance(a, torch.Tensor))
    got, step = rrestore(str(tmp_path), want)
    assert step == 4
    rl = jax.tree_util.tree_flatten_with_path(got)[0]
    tl = list(_leaves(t))
    assert len(rl) == len(tl)
    for (_, a), (_, b) in zip(tl, rl):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert np.array_equal(bits(a), _ref_bits(b))


def test_reference_lm_params_restore_through_params_from_reference(tmp_path):
    """repro's init_params tree, written by repro, restored by the port in
    the reference's layout (``params_to_reference`` of the meta-device
    parameters) and carried across: bit-equal to the direct conversion."""
    for arch in ("gemma3-1b", "hubert-xlarge"):
        rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
        rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0), rcfg)
        d = str(tmp_path / arch)
        rsave(d, 1, rp)
        like = TM.params_to_reference(TM.abstract_params(tcfg), tcfg)
        restored, _ = restore_checkpoint(d, like, device="cpu")
        got = TM.params_from_reference(restored, tcfg, device="cpu")
        want = TM.params_from_reference(jax.tree.map(np.asarray, rp), tcfg,
                                        device="cpu")
        same_trees(got, want)
        # and the port's own layout round-trips through its own store
        save_checkpoint(str(tmp_path / (arch + "-port")), 2, got)
        back, _ = restore_checkpoint(str(tmp_path / (arch + "-port")),
                                     TM.abstract_params(tcfg), device="cpu")
        same_trees(back, got)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "xlstm-350m"])
def test_ssm_moe_params_cross_package_round_trips(tmp_path, arch):
    """The SSM and MoE leaves (mamba's f32 ``w_dt``/``b_dt``/``a_log``/
    ``d_skip``, mLSTM's f32 ``w_gates``, sLSTM's ``r_gates``, the f32
    router and the ``[E, ...]`` experts) both ways: ``repro`` writes and
    the port restores bit for bit; the port writes its tree in the
    reference's layout and ``repro`` restores it bit for bit against its
    own abstract parameters."""
    rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0), rcfg)
    rsave(str(tmp_path / "ref"), 1, rp)
    like = TM.params_to_reference(TM.abstract_params(tcfg), tcfg)
    restored, _ = restore_checkpoint(str(tmp_path / "ref"), like,
                                     device="cpu")
    got = TM.params_from_reference(restored, tcfg, device="cpu")
    same_trees(got, TM.params_from_reference(jax.tree.map(np.asarray, rp),
                                             tcfg, device="cpu"))
    # the port's own draw, written by the port, read by the reference
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(3), "cpu")
    save_checkpoint(str(tmp_path / "port"), 2, TM.params_to_reference(tp,
                                                                      tcfg))
    back, step = rrestore(str(tmp_path / "port"), RM.abstract_params(rcfg))
    assert step == 2
    rl = jax.tree_util.tree_flatten_with_path(back)[0]
    tl = list(_leaves(TM.params_to_reference(tp, tcfg)))
    assert len(rl) == len(tl)
    for (_, a), (_, b) in zip(tl, rl):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype)
        assert np.array_equal(bits(a), _ref_bits(b))


def test_fp8_leaves_roundtrip(tmp_path):
    """fp8 leaves take the same-width uint8 view and come back bit-exact,
    in both packages."""
    t = {"e4": torch.linspace(-3, 3, 16).to(torch.float8_e4m3fn),
         "e5": torch.linspace(-3, 3, 16).to(torch.float8_e5m2)}
    save_checkpoint(str(tmp_path), 1, t)
    got, _ = restore_checkpoint(str(tmp_path), meta(t), device="cpu")
    for k in t:
        assert got[k].dtype == t[k].dtype
        assert torch.equal(got[k].view(torch.uint8), t[k].view(torch.uint8))
    want = {k: jax.ShapeDtypeStruct((16,), jnp.dtype(str(v.dtype)
                                                     .removeprefix("torch.")))
            for k, v in t.items()}
    r, _ = rrestore(str(tmp_path), want)
    for k in t:
        assert np.array_equal(np.asarray(r[k]).view(np.uint8),
                              t[k].view(torch.uint8).numpy())
