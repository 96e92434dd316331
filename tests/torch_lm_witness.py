"""How far the port's LM forward sits from the reference's, and why, on the
CPU (not a test module: it prints readings and asserts nothing).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_lm_witness.py \
        [--archs hubert-xlarge] [--seeds 16]

Per arch and input seed, at the smoke size of ``tests/test_torch_lm.py``
and on parameters carried across from the reference: max |err| / max
|ref| of the port's forward logits against the reference's (compiled, as
the tests run it), and of each against an f32 run of the reference's own
forward (parameters and inputs upcast, ``PDT`` set to f32), the scale
bf16 rounding alone sets.  Then the block witness on hubert's first
layer (input seed 1): the share of norm2's bf16 outputs that differ from
the reference's compiled block when norm2 reads the bf16-rounded sum
``x + out`` and when it reads the f32 sum, as ``model._residual_mlp``
does.  One JSON line at the end.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_lm as T
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.models import layers as TL
from repro_torch.models import model as TM


def _f32_forward(rp, rb, rcfg):
    """The reference's forward with every bf16 leaf upcast and PDT f32."""
    up = (lambda a: a.astype(jnp.float32)
          if a.dtype == jnp.bfloat16 else a)
    pdt, RL.PDT = RL.PDT, jnp.float32
    try:
        return np.asarray(jax.jit(lambda p, b: RM.forward(p, b, rcfg)[0])(
            jax.tree.map(up, rp), jax.tree.map(up, rb)))
    finally:
        RL.PDT = pdt


def forward_readings(arch, seeds):
    rcfg, rp, tcfg, tp = T._model(arch)
    ref = jax.jit(lambda p, b: RM.forward(p, b, rcfg)[0])
    rows = []
    for seed in range(seeds):
        rb, tb = T._batch(rcfg, seed)
        want = np.asarray(ref(rp, rb))
        got = TM.forward(tp, tb, tcfg)[0]
        f32 = _f32_forward(rp, rb, rcfg)
        rows.append({"seed": seed, "port_vs_ref": T._rel(got, want),
                     "ref_vs_f32": T._rel(want, f32),
                     "port_vs_f32": T._rel(got, f32),
                     "max_abs_logit": float(np.abs(want).max())})
    return rows


def norm2_witness():
    rcfg, rp, tcfg, tp = T._model("hubert-xlarge")
    rb, _ = T._batch(rcfg, 1)
    x = RM._embed_inputs(rp, rb, rcfg)
    pos = jnp.arange(x.shape[1], dtype=jnp.int32)
    p = jax.tree.map(lambda a: a[0], rp["slots"])["slot00"]

    def block(p, x):
        h = RL.rmsnorm(p["norm1"], x, rcfg.norm_eps)
        out, _ = RL.attention_fwd(p["attn"], h, pos, rcfg, "attn")
        return out, RL.rmsnorm(p["norm2"], x + out, rcfg.norm_eps)

    out, h2 = jax.jit(block)(p, x)
    norm2 = tp["layers"][0]["norm2"]
    xt, ot = TM._tensor(np.asarray(x)), TM._tensor(np.asarray(out))
    rounded = TL.rmsnorm(norm2, xt + ot, tcfg.norm_eps)
    fused = TL.rmsnorm(norm2, xt.float() + ot, tcfg.norm_eps).to(xt.dtype)
    want = T._np(h2)
    return {"norm2_differ_rounded_sum": float((T._np(rounded) != want).mean()),
            "norm2_differ_f32_sum": float((T._np(fused) != want).mean())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default="hubert-xlarge")
    ap.add_argument("--seeds", type=int, default=16)
    args = ap.parse_args(argv)
    torch.manual_seed(0)
    out = {}
    for arch in args.archs.split(","):
        rows = forward_readings(arch, args.seeds)
        for r in rows:
            print(arch, json.dumps(r), flush=True)
        out[arch] = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
                     for k in ("port_vs_ref", "ref_vs_f32", "port_vs_f32",
                               "max_abs_logit")}
    out["norm2_witness"] = norm2_witness()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
