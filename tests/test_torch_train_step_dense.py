"""``make_train_step`` of the port against the reference's jitted
``train_step``: the dense decoder families but gemma3 (CPU, f32, reduced).

From the same weights (``params_from_jax``) and the same pipeline batch,
one step's loss, ce, gradients, ``grad_norm``, ``lr``, updated
parameters, ``mu``, ``nu`` and ``step`` (bounds in tests/_torch_train.py);
granite also with ``compress_grads`` (the reference's int8
quantize-dequantize inside the step, one scale a leaf of its tree).
The files ``test_torch_train_step_{dense,gemma3,mixed,ssm}.py`` split
the ten configs so that each runs near 100 s under six test workers.
"""

import jax
import pytest

from _torch_train import Runs, hold_step
from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ARCHS = ("granite-20b", "minitron-4b", "qwen2-72b", "qwen2-vl-7b")
THREE = ()


@pytest.fixture(scope="module")
def runs():
    return Runs(THREE)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step(runs, arch):
    _, got, want = runs(arch)
    hold_step(got, want)


def test_train_step_compress_grads(runs):
    _, got, want = runs("granite-20b", compress=True)
    hold_step(got, want)
