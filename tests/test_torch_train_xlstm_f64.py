"""The xLSTM family's gradients against f64 (CPU).

The reduced xlstm's f32 gradients of ``loss_fn`` differ between the two
packages by more than the 1e-4 of ``max|g|`` that holds every other
family (``GRAD_TOL``); tests/test_torch_train_xlstm.py finds every piece
of the blocks equal.  Here, in f64 (``tests/_torch_xlstm_f64.py``: both
packages' explicit f32 casts made f64, ``jax_enable_x64``, in a process
of its own) the two packages' gradients agree to 1e-10, and the
reference's own f32 gradients stray from them by up to
``XLSTM_F64_GAP`` = 1.66e-4 (held with ``F64_GAP_HEADROOM`` = 1.1x room
for another CPU's rounding), past ``GRAD_TOL``: f32 rounding that the
stack of xLSTM blocks amplifies on the way back, in either package.  The
port's f32 gradients are held at ``XLSTM_GRAD_TOL`` = twice that
measurement, from the f64 values and from the reference's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from _torch_train import (F64_GAP_HEADROOM, GRAD_TOL, XLSTM_F64_GAP,
                          XLSTM_GRAD_TOL)

HERE = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def f64():
    """Both packages' f32 and f64 gradients of the reduced model, in a
    process of its own (tests/_torch_xlstm_f64.py)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(HERE.parent / "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    out = subprocess.run([sys.executable, str(HERE / "_torch_xlstm_f64.py")],
                         capture_output=True, text=True, env=env,
                         timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("batch", ["pipeline", "uniform"])
def test_f64_gradients_agree(f64, batch):
    assert f64[batch]["port64_vs_ref64"] <= 1e-10


@pytest.mark.parametrize("batch", ["pipeline", "uniform"])
def test_reference_f32_within_its_measured_gap(f64, batch):
    assert f64[batch]["ref32_vs_f64"] <= F64_GAP_HEADROOM * XLSTM_F64_GAP


def test_the_gap_exceeds_the_default_bound(f64):
    """The gap this file settles: the reference's f32 gradients are past
    GRAD_TOL from their own f64 values, and the port's f32 gradients past
    it from the reference's (on the uniform batch)."""
    assert max(r["ref32_vs_f64"] for r in f64.values()) > GRAD_TOL
    assert f64["uniform"]["port32_vs_ref32"] > GRAD_TOL


@pytest.mark.parametrize("batch", ["pipeline", "uniform"])
def test_port_f32_within_twice_the_measured_gap(f64, batch):
    assert f64[batch]["port32_vs_f64"] <= XLSTM_GRAD_TOL
    assert f64[batch]["port32_vs_ref32"] <= XLSTM_GRAD_TOL
