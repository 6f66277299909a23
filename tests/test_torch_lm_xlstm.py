"""The port's xLSTM cells and xlstm-1.3b against the reference (CPU, f32).

``mlstm_apply`` (the SSD scan a head), ``mlstm_decode`` step by step
(output, matrix memory and stabiliser), ``slstm_apply`` (the loop over
time) and ``slstm_decode`` step by step (output and the four carries);
the reduced xlstm's logits, its decode against the reference's decode,
the serving loop's tokens and ``count_params``.  The reference's two
mLSTM forms disagree (``mlstm_apply`` has no stabiliser; ROADMAP.md §3),
so each form is held against its own counterpart, never one against the
other.

Tolerance: ``atol = 1e-4 * max(1, max|want|)``, ``rtol = 1e-4`` (f32
products summed in another order); tokens and counts exactly.
"""

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import xlstm as RX
from repro.models.model import count_params as ref_count_params
import repro_torch.configs as PC
from repro_torch.models import count_params
from repro_torch.models import xlstm as PX
from repro_torch.models.convert import _load

from _torch_lm import Case, close, configs, hold_decode, hold_serve, t

jax.config.update("jax_platforms", "cpu")

F32 = np.float32


class Cell:
    """One reduced xlstm mLSTM or sLSTM cell in both packages (gate
    biases drawn non-zero) and inputs (2, 40, d)."""

    def __init__(self, kind):
        self.ref_cfg, self.cfg = configs("xlstm-1.3b")
        init = RX.init_mlstm if kind == "m" else RX.init_slstm
        tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3),
                                             self.ref_cfg))
        r = np.random.default_rng(11)
        bias = tree["w_gates" if kind == "m" else "wx"]
        bias["bias"] = (0.5 * r.standard_normal(bias["bias"].shape)
                        ).astype(F32)
        self.tree = tree
        self.mod = (PX.MLstm if kind == "m" else PX.SLstm)(self.cfg)
        with torch.no_grad():
            assert _load(self.mod, tree) == sum(
                v.size for v in jax.tree.leaves(tree))
        self.x = r.standard_normal((2, 40, self.cfg.d_model)).astype(F32)


@pytest.fixture(scope="module")
def mcell():
    return Cell("m")


@pytest.fixture(scope="module")
def scell():
    return Cell("s")


def test_mlstm_apply(mcell):
    want = RX.mlstm_apply(mcell.tree, mcell.x, mcell.ref_cfg)
    with torch.no_grad():
        got = PX.mlstm_apply(mcell.mod, t(mcell.x), mcell.cfg)
    close(got.numpy(), want)


def test_mlstm_decode_step_by_step(mcell):
    ref_cache = RX.init_mlstm_cache(2, mcell.ref_cfg)
    cache = PX.init_mlstm_cache(2, mcell.cfg, device="cpu")
    assert cache.C.shape == (2, 4, 17, 16) and float(cache.m[0, 0]) == -1e9
    step = jax.jit(lambda p, x, c: RX.mlstm_decode(p, x, c, mcell.ref_cfg))
    for i in range(mcell.x.shape[1]):
        x = mcell.x[:, i:i + 1]
        want, ref_cache = step(mcell.tree, x, ref_cache)
        with torch.no_grad():
            got, cache = PX.mlstm_decode(mcell.mod, t(x), cache, mcell.cfg)
        close(got.numpy(), want)
        close(cache.C.numpy(), ref_cache.C)
        close(cache.m.numpy(), ref_cache.m)


def test_slstm_apply(scell):
    want = RX.slstm_apply(scell.tree, scell.x, scell.ref_cfg)
    with torch.no_grad():
        got = PX.slstm_apply(scell.mod, t(scell.x), scell.cfg)
    close(got.numpy(), want)


def test_slstm_decode_step_by_step(scell):
    ref_cache = RX.init_slstm_cache(2, scell.ref_cfg)
    cache = PX.init_slstm_cache(2, scell.cfg, device="cpu")
    step = jax.jit(lambda p, x, c: RX.slstm_decode(p, x, c, scell.ref_cfg))
    for i in range(scell.x.shape[1]):
        x = scell.x[:, i:i + 1]
        want, ref_cache = step(scell.tree, x, ref_cache)
        with torch.no_grad():
            got, cache = PX.slstm_decode(scell.mod, t(x), cache, scell.cfg)
        close(got.numpy(), want)
        for name in ("c", "n", "h", "m"):
            close(getattr(cache, name).numpy(), getattr(ref_cache, name))


def test_slstm_carries_h_in_the_activations_dtype(scell):
    cache = PX.init_slstm_cache(2, scell.cfg, dtype=torch.bfloat16,
                                device="cpu")
    with torch.no_grad():
        got, cache = PX.slstm_decode(
            scell.mod, t(scell.x[:, :1]).to(torch.bfloat16), cache, scell.cfg)
        full = PX.slstm_apply(scell.mod, t(scell.x).to(torch.bfloat16),
                              scell.cfg)
    assert got.dtype == full.dtype == cache.h.dtype == torch.bfloat16
    assert cache.c.dtype == cache.n.dtype == cache.m.dtype == torch.float32


# -- the model -----------------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm():
    return Case("xlstm-1.3b")


def test_xlstm_logits(xlstm):
    got, aux = xlstm.apply()
    assert got.shape == (2, 64, xlstm.cfg.padded_vocab) and aux == 0.0
    close(got, xlstm.ref_logits)


def test_xlstm_decode_equals_the_reference_decode(xlstm):
    hold_decode(xlstm, feed=32)


def test_xlstm_serving_loop_tokens_equal_the_reference():
    hold_serve("xlstm-1.3b")


def test_xlstm_count_params_equals_the_reference():
    cfg = PC.get_config("xlstm-1.3b")
    assert count_params(cfg) == 1_144_129_856 == \
        ref_count_params(RC.get_config("xlstm-1.3b"))
    assert count_params(cfg, active_only=True) == count_params(cfg)
    assert count_params(PC.reduced(cfg)) == \
        ref_count_params(RC.reduced(RC.get_config("xlstm-1.3b")))
