"""``make_train_step`` of the port against the reference's jitted
``train_step``: gemma3-1b (local/global attention) (CPU, f32, reduced).

From the same weights (``params_from_jax``) and the same pipeline batch,
one step's loss, ce, gradients, ``grad_norm``, ``lr``, updated
parameters, ``mu``, ``nu`` and ``step`` (bounds in tests/_torch_train.py);
then three steps in a row, loss and ce within 1e-5 relative at each.
"""

import jax
import pytest

from _torch_train import Runs, hold_losses, hold_step
from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ARCHS = ("gemma3-1b",)
THREE = ("gemma3-1b",)


@pytest.fixture(scope="module")
def runs():
    return Runs(THREE)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(runs, arch):
    _, got, want = runs(arch)
    hold_step(got, want)


@pytest.mark.parametrize("arch", THREE)
def test_three_steps(runs, arch):
    _, got, want = runs(arch)
    assert len(got["metrics"]) == 3
    hold_losses(got["metrics"], want["metrics"])
