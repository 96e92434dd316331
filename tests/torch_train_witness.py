"""Readings behind the training tests' bounds, on the CPU (not a test
module: it prints readings and asserts nothing).

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_train_witness.py

At the smoke size and on the cases of ``tests/torch_train_cases.py``:
xlstm's gradient, the reference against itself (jit against op by op)
and the port against the jitted reference, the worst leaf of each; then
jamba's smallest routing margin for batch seeds 0-7 and, on seed 0, the
port's worst gradient leaf against the reference.  One JSON line each.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import jax

import torch_train_cases as C
from repro import configs as RC
from repro.models import model as RM
from repro.models import train as RT
from repro_torch import configs as TC
from repro_torch.models import train as TT


def worst(errors):
    key = max(errors, key=errors.get)
    return [key, errors[key]]


def main():
    c = C.case("xlstm-350m")
    with jax.disable_jit():
        _, eager = jax.value_and_grad(functools.partial(
            RT.loss_fn, cfg=dataclasses.replace(c.rcfg, remat="none")),
            has_aux=True)(c.rp, c.rb)
    grads = TT.value_and_grad(c.tp, c.tb, c.tcfg)[1]
    print(json.dumps({
        "xlstm_reference_jit_vs_eager": worst(
            C.grad_errors(C.to_port(eager), c.rgrads)),
        "xlstm_port_vs_reference": worst(C.grad_errors(grads, c.rgrads))}),
        flush=True)

    arch = "jamba-1.5-large-398b"
    rcfg, tcfg = RC.smoke_config(arch), TC.smoke_config(arch)
    rp = jax.jit(RM.init_params, static_argnums=1)(jax.random.key(0), rcfg)
    tp = C.to_port(rp)
    print(json.dumps({"jamba_min_route_margin_by_seed": [
        C.min_route_margin(tcfg, tp, C.make_batch(rcfg, s)[1])
        for s in range(8)]}), flush=True)
    rb, tb = C.make_batch(rcfg, 0)
    (_, _), rgrads = jax.jit(jax.value_and_grad(functools.partial(
        RT.loss_fn, cfg=rcfg), has_aux=True))(rp, rb)
    grads = TT.value_and_grad(tp, tb, tcfg)[1]
    print(json.dumps({"jamba_seed0_port_vs_reference": worst(
        C.grad_errors(grads, rgrads))}), flush=True)


if __name__ == "__main__":
    main()
