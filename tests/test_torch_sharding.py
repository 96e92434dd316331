"""The port's sharding rules against the JAX reference, on the CPU.

The twin of ``tests/test_sharding.py``: the port keeps the rules as data
(specs are tuples; a mesh is anything with ``.shape`` and
``.axis_names``), and every table equals the reference's, entry by entry:

* ``resolve``, ``_rule_for`` and ``_fsdp_axes`` on the reference's own
  cases and a grid of logical axes, dims and meshes;
* ``param_specs`` of every architecture's full config (the port's
  meta-device state in the reference's layout) on the ``{data: 16,
  model: 16}`` and pod meshes, with and without ZeRO;
* ``train_state_specs`` (moments mirror params), ``batch_specs`` and
  ``cache_specs`` of the full configs' decode caches;
* the mesh descriptors of ``launch/mesh.py``.
"""

import itertools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as RC
from repro.models import model as RM
from repro.models import serve as RSV
from repro.models import sharding as RSH
from repro.models import train as RT
from repro_torch import configs as TC
from repro_torch.checkpoint.store import _key, _leaves
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.models import serve as TSV
from repro_torch.models import sharding as TSH
from repro_torch.models import train as TT


class FakeMesh:
    """A mesh of the given axis sizes for both packages (the reference's
    ``batch_specs`` reads ``devices.shape``)."""

    def __init__(self, sizes):
        self._sizes = sizes
        self.devices = np.empty(tuple(sizes.values()))

    @property
    def shape(self):
        return dict(self._sizes)

    @property
    def axis_names(self):
        return tuple(self._sizes)


MESH = FakeMesh({"data": 16, "model": 16})
POD_MESH = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"data16_model16": MESH, "pod2_data16_model16": POD_MESH}


def _ref_specs(spec_tree, like):
    """``{key: spec tuple}`` over the reference's leaves of ``like``."""
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda s: isinstance(s, P))[0]
    out = {}
    for path, spec in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(
            p, "name", p)))) for p in path)
        out[key] = tuple(spec)
    return out


def _port_specs(spec_tree, like):
    """``{key: spec}`` at every tensor leaf of ``like`` (the spec tree's
    own tuples are its leaves, so it is walked along ``like``)."""
    out = {}
    for path, _ in _leaves(like):
        node = spec_tree
        for step in path:
            node = getattr(node, step) if isinstance(step, str) and \
                not isinstance(node, dict) else node[step]
        out[_key(path)] = node
    return out


def test_resolve_reference_cases():
    assert TSH.resolve(("heads",), (4,), MESH) == (None,)
    assert TSH.resolve(("heads",), (64,), MESH) == ("model",)
    assert TSH.resolve(("vocab",), (504,), MESH) == (None,)
    assert TSH.resolve(("expert", "heads"), (32, 32), MESH) == ("model", None)
    assert TSH.resolve(("batch",), (256,), POD_MESH) == (("pod", "data"),)
    assert TSH.resolve(("batch",), (1,), POD_MESH) == (None,)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_resolve_grid_equals_reference(mesh_name):
    mesh = MESHES[mesh_name]
    for axes in itertools.product(list(TSH.LOGICAL), repeat=2):
        for dims in itertools.product((1, 4, 16, 32, 48, 1024), repeat=2):
            assert TSH.resolve(axes, dims, mesh) == \
                tuple(RSH.resolve(axes, dims, mesh)), (axes, dims)


def test_rule_and_fsdp_tables_equal_reference():
    assert TSH.LOGICAL == RSH.LOGICAL
    assert TSH._PARAM_RULES == RSH._PARAM_RULES
    assert TSH._MOE_RULES == RSH._MOE_RULES
    for name in list(RSH._PARAM_RULES) + ["other"]:
        for prefix in ((), ("slots",), ("moe",), ("slots", "moe")):
            for ndim in (1, 2, 3, 4):
                path = prefix + (name,)
                assert TSH._rule_for(path, ndim) == \
                    RSH._rule_for(path, ndim), (path, ndim)
    for mesh in MESHES.values():
        sizes = dict(mesh.shape)
        for axes in ((None, None), ("heads", None), (None, "ff"),
                     (None, None, None)):
            for dims in ((1024, 64), (2048, 2048), (32, 4096),
                         (4, 1024, 2048)):
                dims = dims[:len(axes)]
                assert TSH._fsdp_axes(axes, dims, sizes) == \
                    RSH._fsdp_axes(axes, dims, sizes), (axes, dims)


@pytest.mark.parametrize("arch", RC.list_archs())
def test_param_specs_equal_reference(arch):
    """Every leaf's spec, for the full config, on both meshes, ZeRO on and
    off."""
    like = TT.abstract_state(TC.get_config(arch)).params
    rparams = RM.abstract_params(RC.get_config(arch))
    for mesh in MESHES.values():
        for zero in (True, False):
            want = _ref_specs(RSH.param_specs(rparams, mesh, zero=zero),
                              rparams)
            got = _port_specs(TSH.param_specs(like, mesh, zero=zero), like)
            assert got == want, (arch, mesh.shape, zero)


@pytest.mark.parametrize("arch", ("qwen1.5-4b", "kimi-k2-1t-a32b"))
def test_train_state_specs_equal_reference(arch):
    rstate = RT.abstract_state(RC.get_config(arch))
    tstate = TT.abstract_state(TC.get_config(arch))
    want = _ref_specs(RT.train_state_specs(rstate, MESH), rstate)
    got = _port_specs(TT.train_state_specs(tstate, MESH), tstate)
    assert got == want
    specs = TT.train_state_specs(tstate, MESH)
    assert specs.opt_state[1]["mu"] is specs.params  # moments mirror params


def test_batch_specs_equal_reference():
    for mesh in (*MESHES.values(), FakeMesh({"data": 1})):
        for shape in ((256, 4096), (1, 4096), (32, 4096, 1024), (8,)):
            want = RT.batch_specs({"x": jax.ShapeDtypeStruct(shape, "int32")},
                                  mesh)
            got = TT.batch_specs({"x": torch.empty(shape, device="meta")},
                                 mesh)
            assert got["x"] == tuple(want["x"]), (mesh.shape, shape)


# where the mixers' model-axis split keeps each SSM state of the full
# configs at B=128 on both meshes (the batch over the batch axes, "b"):
# jamba's mamba by channel; xlstm's 4 mLSTM heads on model=16 a head on
# each group of 4 ranks (C split along its value dim inside the group, n
# whole on each of its ranks), its sLSTM by channel
SSM_STATE_SPECS = {
    ("mamba", "conv"): ((None, "b", None, "model"), None),
    ("mamba", "ssm"): ((None, "b", "model", None), None),
    ("mlstm", "C"): ((None, "b", None, None, "model"), (-3, 4, ("model",))),
    ("mlstm", "n"): ((None, "b", None, None), (-2, 4, ("model",))),
    ("slstm", "c"): ((None, "b", "model"), None),
}


@pytest.mark.parametrize("arch", RC.list_archs())
def test_cache_specs_equal_reference(arch):
    """The reference's rule (``reference_cache_specs``, which the dry run
    prices) equals the reference's on every leaf; ``cache_specs`` equals
    it on every attention leaf and keeps each SSM state where the mixers
    split it (``SSM_STATE_SPECS``)."""
    rcfg, tcfg = RC.get_config(arch), TC.get_config(arch)
    rcache = RM.abstract_cache(rcfg, 128, 4096)
    tcache = TM.abstract_cache(tcfg, 128, 4096)
    want_shapes = {k: tuple(v.shape) for k, v in _ref_leaves_shapes(rcache)}
    got_shapes = {_key(p): tuple(t.shape) for p, t in _leaves(tcache)}
    assert got_shapes == want_shapes
    mixers = {f"slot{i:02d}": m for i, (m, _) in enumerate(tcfg.layer_pattern)}
    mixers.update({f"tail{i:02d}": m
                   for i, (m, _) in enumerate(tcfg.tail_pattern)})
    for mesh in MESHES.values():
        want = _ref_specs(RSV.cache_specs(rcache, rcfg, mesh), rcache)
        assert _port_specs(TSV.reference_cache_specs(tcache, tcfg, mesh),
                           tcache) == want, mesh.shape
        got = _port_specs(TSV.cache_specs(tcache, tcfg, mesh), tcache)
        assert set(got) == set(want)
        batch = tuple(n for n in ("pod", "data") if n in mesh.shape)
        batch = batch if len(batch) > 1 else batch[0]
        for key, spec in got.items():
            slot, name = key.split("/")
            mixer = mixers[slot]
            if mixer in ("attn", "local"):
                assert spec == want[key], key
                continue
            entries, within = SSM_STATE_SPECS[
                (mixer, name if mixer != "slstm" else "c")]
            assert spec == tuple(batch if e == "b" else e for e in entries)
            assert getattr(spec, "within", None) == within, key


def _ref_leaves_shapes(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [("/".join(str(getattr(p, "key", p)) for p in path), leaf)
            for path, leaf in flat]


def test_constrain_and_named_shardings_are_identities():
    x = torch.ones(3)
    assert TSH.constrain(x, "batch") is x
    spec = {"a": ("data", None)}
    assert TSH.named_shardings(spec, MESH) is spec


def test_mesh_descriptors():
    prod = TMESH.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.axis_names == ("data", "model")
    pod = TMESH.make_production_mesh(multi_pod=True)
    assert pod.axis_names == ("pod", "data", "model")
    assert TMESH.mesh_chips(pod) == 512
    host = TMESH.make_host_mesh()
    assert host.shape == {"data": 1} and TMESH.mesh_chips(host) == 1
    assert TMESH.make_host_mesh(4, name="pe").shape == {"pe": 4}
    # the port's descriptors drive the reference's rules as its meshes do
    like = TT.abstract_state(TC.get_config("gemma3-1b")).params
    assert _port_specs(TSH.param_specs(like, prod), like) == \
        _port_specs(TSH.param_specs(like, MESH), like)
