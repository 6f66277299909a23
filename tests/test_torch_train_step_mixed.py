"""``make_train_step`` of the port against the reference's jitted
``train_step``: MoE and the encoder-decoder (CPU, f32, reduced).

From the same weights (``params_from_jax``) and the same pipeline batch,
one step's loss, ce, gradients, ``grad_norm``, ``lr``, updated
parameters, ``mu``, ``nu`` and ``step`` (bounds in tests/_torch_train.py);
olmoe with its capacity dropping assignments (``capacity_factor`` 0.5)
and over three steps in a row, loss and ce within 1e-5 relative at
each.
"""

import jax
import pytest

from _torch_train import Runs, hold_losses, hold_step
from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ARCHS = ("olmoe-1b-7b", "llama4-scout-17b-a16e", "whisper-medium")
THREE = ("olmoe-1b-7b",)

# olmoe with drops: int(0.5 * T * k / E) = 8 slots an expert for 64 tokens
CHANGES = {"olmoe-1b-7b": dict(capacity_factor=0.5)}


@pytest.fixture(scope="module")
def runs():
    return Runs(THREE, CHANGES)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(runs, arch):
    _, got, want = runs(arch)
    hold_step(got, want)


@pytest.mark.parametrize("arch", THREE)
def test_three_steps(runs, arch):
    _, got, want = runs(arch)
    assert len(got["metrics"]) == 3
    hold_losses(got["metrics"], want["metrics"])
