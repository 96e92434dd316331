"""How far two valid decodes of a deep gemma2-shaped model sit apart on
the CPU (not a test module: it prints readings and asserts nothing).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_decode_witness.py \
        [--layers 4 42]

gemma2-9b's block pattern, softcaps and GQA (16 heads, 8 KV heads) at
d_model 256 and ``--layers`` depths, random weights drawn by the
reference (seed 0): 8 decode steps after a 16-token prompt at B=8 in a
cache of 32, the logits of the prompt's last step and each step after.
Per depth, max |a - b| / max |b| and the worst row's RMS error over its
RMS between the port's partitioned decode on (2, 4) (8 gloo ranks; the
heads split over model=4) and the port's one-device decode, the port's
and the reference's one-device decodes, and the reference's decode
jitted with its dry run's shardings on (2, 4) (8 forced host devices)
and its one-device decode.  Two decodes that differ only in where bf16
rounds drift apart with depth in a random-weight network; the readings
say by how much at gemma2-9b's 42 layers.  One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import torch

B, PROMPT, STEPS, LEN, VOCAB = 8, 16, 8, 32, 512


def fields(layers):
    return dict(name=f"gemma2-shaped-{layers}", family="dense",
                num_layers=layers, d_model=256, num_heads=16,
                num_kv_heads=8, d_ff=512, vocab_size=VOCAB,
                layer_pattern=(("local", "dense"), ("attn", "dense")),
                head_dim=32, window=16, attn_logit_softcap=50.0,
                final_logit_softcap=30.0, tie_embeddings=True)


def tokens():
    return np.random.default_rng(11).integers(
        0, VOCAB, (B, PROMPT + STEPS), dtype=np.int32)


def reference(layers, path):
    """The reference's parameters and its two decodes, pickled."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro import compat
    from repro.models import model as RM
    from repro.models import serve as SV
    from repro.models import train as T
    from repro.models.config import ModelConfig
    from repro.models.sharding import param_specs

    cfg = ModelConfig(**fields(layers))
    params = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0),
                                                       cfg)
    named = lambda tree, mesh: jax.tree.map(
        lambda s: NamedSharding(mesh, s), tree,
        is_leaf=lambda s: isinstance(s, P))
    toks = tokens()
    out = {"params": jax.tree.map(np.asarray, params)}
    for shape in (None, (2, 4)):
        cache, p = RM.init_cache(cfg, B, LEN), params
        step = jax.jit(SV.make_decode_step(cfg))
        if shape is not None:
            mesh = compat.make_mesh(shape, ("data", "model"),
                                    axis_types=compat.auto_axes(2))
            sh = (named(param_specs(params, mesh, zero=False), mesh),
                  named(T.batch_specs({"tokens": toks[:, :1]}, mesh),
                        mesh)["tokens"],
                  NamedSharding(mesh, P()),
                  named(SV.cache_specs(cache, cfg, mesh), mesh))
            step = jax.jit(SV.make_decode_step(cfg), in_shardings=sh,
                           out_shardings=(None, sh[3]))
            p, cache = jax.device_put(params, sh[0]), \
                jax.device_put(cache, sh[3])
        logits = []
        for t in range(PROMPT + STEPS):
            lg, cache = step(p, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t),
                             cache)
            if t >= PROMPT - 1:
                logits.append(np.asarray(lg, np.float32))
        out[shape] = np.stack(logits)
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _mesh_decode(pe_mesh, layers, params):
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as M
    from repro_torch.models import serve as SV
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(**fields(layers))
    mesh = LM.make_lm_mesh((2, 4), device="cpu")
    shards = SV.shard_params(params, cfg, mesh)
    cache = SV.shard_cache(M.init_cache(cfg, B, LEN, "cpu"), cfg, mesh)
    step = SV.make_decode_step(cfg, mesh, LEN)
    toks = torch.from_numpy(tokens())
    logits = []
    for t in range(PROMPT + STEPS):
        lg, cache = step(shards, toks[:, t:t + 1], t, cache)
        if t >= PROMPT - 1:
            logits.append(mesh.all_gather(lg, "data", 0))
    return torch.stack(logits)


def _apart(a, b):
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    rows_a, rows_b = a.reshape(-1, VOCAB), b.reshape(-1, VOCAB)
    rms = ((rows_a - rows_b).pow(2).mean(-1).sqrt()
           / rows_b.pow(2).mean(-1).sqrt())
    return {"max_rel": float((a - b).abs().max() / b.abs().max()),
            "row_rms": float(rms.max())}


def readings(layers):
    from repro_torch.core import mesh as CM
    from repro_torch.models import model as M
    from repro_torch.models.config import ModelConfig

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.pkl")
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=8"))
        subprocess.run([sys.executable, __file__, "--reference",
                        str(layers), path], env=env, check=True)
        with open(path, "rb") as f:
            ref = pickle.load(f)
    cfg = ModelConfig(**fields(layers))
    params = M.params_from_reference(ref["params"], cfg, device="cpu")
    toks = torch.from_numpy(tokens())
    cache, one = M.init_cache(cfg, B, LEN, "cpu"), []
    for t in range(PROMPT + STEPS):
        lg, cache = M.decode_step(params, toks[:, t:t + 1], t, cache, cfg)
        if t >= PROMPT - 1:
            one.append(lg)
    one = torch.stack(one)
    mesh = CM.spawn(_mesh_decode, 8, layers,
                    M.params_to_reference(params, cfg), device="cpu")
    return {"layers": layers,
            "port_mesh_vs_port_one_device": _apart(mesh, one),
            "port_one_device_vs_reference_one_device": _apart(one, ref[None]),
            "reference_sharded_vs_reference_one_device": _apart(
                ref[(2, 4)], ref[None]),
            "max_abs_logit": float(one.abs().max())}


def main():
    if sys.argv[1:2] == ["--reference"]:
        reference(int(sys.argv[2]), sys.argv[3])
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 42])
    args = ap.parse_args()
    rows = [readings(n) for n in args.layers]
    for row in rows:
        print(row, flush=True)
    print(json.dumps({"decode_witness": rows}))


if __name__ == "__main__":
    main()
