"""``make_train_step`` of the port against the reference's jitted
``train_step``: the Mamba2 hybrid and xLSTM (CPU, f32, reduced).

From the same weights (``params_from_jax``) and the same pipeline batch,
one step's loss, ce, gradients, ``grad_norm``, ``lr``, updated
parameters, ``mu``, ``nu`` and ``step`` (bounds in tests/_torch_train.py);
xlstm's gradients at ``XLSTM_GRAD_TOL`` (settled in
tests/test_torch_train_xlstm{,_f64}.py); zamba2 over three steps in a row,
loss and ce within 1e-5 relative at each.
"""

import jax
import pytest

from _torch_train import (GRAD_TOL, XLSTM_GRAD_TOL, Runs, hold_losses,
                          hold_step)
from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ARCHS = ("zamba2-2.7b", "xlstm-1.3b")
THREE = ("zamba2-2.7b",)


@pytest.fixture(scope="module")
def runs():
    return Runs(THREE)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(runs, arch):
    _, got, want = runs(arch)
    tol = XLSTM_GRAD_TOL if arch == "xlstm-1.3b" else GRAD_TOL
    hold_step(got, want, grad_tol=tol)


@pytest.mark.parametrize("arch", THREE)
def test_three_steps(runs, arch):
    _, got, want = runs(arch)
    assert len(got["metrics"]) == 3
    hold_losses(got["metrics"], want["metrics"])
