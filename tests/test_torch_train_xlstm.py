"""The port's training step on xlstm (mLSTM, sLSTM) against the JAX
reference, on the CPU.

* the loss within 1e-3 of the jitted reference's, and every gradient leaf
  within the reference's own jit-against-eager spread on the same inputs
  (the largest over its leaves, computed here; at least 3e-2): the mLSTM
  backward is ill-conditioned in bf16 at smoke size (the chunk scan's f32
  backward alone agrees within 1e-5, ``tests/test_torch_train.py``);
* ``remat`` "dots" and "full" leave every loss and gradient bit unchanged.
"""

import dataclasses
import functools

import jax

from repro.models import train as RT
from torch_train_cases import (GRAD_BOUND, case, check_loss_and_grads,
                               check_remat_is_bit_neutral, grad_errors,
                               to_port)

ARCH = "xlstm-350m"


def test_xlstm_loss_and_grads_within_reference_spread():
    c = case(ARCH)
    # the reference against itself, op by op; its remat changes no bit,
    # and "none" runs op by op in two thirds of the time
    with jax.disable_jit():
        _, eager = jax.value_and_grad(functools.partial(
            RT.loss_fn, cfg=dataclasses.replace(c.rcfg, remat="none")),
            has_aux=True)(c.rp, c.rb)
    spread = max(grad_errors(to_port(eager), c.rgrads).values())
    check_loss_and_grads(ARCH, max(GRAD_BOUND, spread))


def test_xlstm_remat_is_bit_neutral():
    check_remat_is_bit_neutral(ARCH)
