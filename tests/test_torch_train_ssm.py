"""The port's training step on jamba (mamba, attention and the
sort-by-destination MoE) against the JAX reference, on the CPU (the dense
architectures, the optimizer and the port's own training tests are in
``tests/test_torch_train.py``, xlstm in ``tests/test_torch_train_xlstm.py``).

* the loss within 1e-3 of the jitted reference's and every gradient leaf
  within 3e-2 of its max |ref|, on a batch whose routing clears the
  margin rule (``torch_train_cases.case``);
* ``remat`` "dots" and "full" leave every loss and gradient bit unchanged.
"""

from torch_train_cases import check_loss_and_grads, check_remat_is_bit_neutral

ARCH = "jamba-1.5-large-398b"


def test_jamba_loss_and_grads_vs_reference():
    check_loss_and_grads(ARCH)


def test_jamba_remat_is_bit_neutral():
    check_remat_is_bit_neutral(ARCH)
