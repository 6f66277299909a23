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


def _vjp_ref(cell, x, ct):
    """The reference's mLSTM output and its gradients (x, then each leaf of
    the tree by ``module`` name) under the cotangent ``ct``."""
    out, vjp = jax.vjp(lambda p, xx: RX.mlstm_apply(p, xx, cell.ref_cfg),
                       cell.tree, x)
    d_tree, dx = vjp(ct)
    leaves = {f"{m}.{k}": np.asarray(v) for m, sub in d_tree.items()
              for k, v in sub.items()}
    return np.asarray(out), np.asarray(dx), leaves


def _vjp_port(cell, x, ct, sides=None):
    xt = t(x).requires_grad_()
    named = list(cell.mod.named_parameters())
    with PX.NormaliserSides(sides) as ns:
        out = PX.mlstm_apply(cell.mod, xt, cell.cfg)
        grads = torch.autograd.grad(out, [xt] + [p for _, p in named],
                                    t(ct))
    return (out.detach().numpy(), grads[0].numpy(),
            {n: g.numpy() for (n, _), g in zip(named, grads[1:])}, ns.seen)


def test_mlstm_grads_on_the_recorded_and_pinned_sides(mcell):
    """At the folded batch of 16 (4 sequences x 4 heads in the scan's
    batch): the readout under ``NormaliserSides`` (recording, then pinned
    to its own record) is the free readout bit for bit, and its output
    and gradients equal the reference's ``mlstm_apply`` and its VJP."""
    r = np.random.default_rng(12)
    x = r.standard_normal((4, 64, mcell.cfg.d_model)).astype(F32)
    ct = r.standard_normal((4, 64, mcell.cfg.d_model)).astype(F32)
    out, dx, leaves = _vjp_ref(mcell, x, ct)
    free = _vjp_port(mcell, x, ct)
    assert [s.shape for s in free[3]] == [(4, 64, mcell.cfg.n_heads, 1)]
    pinned = _vjp_port(mcell, x, ct, sides=free[3])
    for a, b in ((free[0], pinned[0]), (free[1], pinned[1])):
        assert np.array_equal(a, b)
    for n in free[2]:
        assert np.array_equal(free[2][n], pinned[2][n])
    close(free[0], out)
    close(free[1], dx)
    for n, want in leaves.items():
        close(free[2][n], want)


def test_mlstm_readout_at_the_kink():
    """The smallest input on which two computations of one readout part:
    ``|den|`` one f64 rounding step under 1, ``1 - 2**-26``, rounds to
    1.0 in f32.  The reference's readout ``num / max(|den|, 1)`` then
    passes no gradient to ``den`` in f64 (clamped) and the port's f32 one
    passes ``-num`` (the jump of the kink, not an error of either).  On
    the f64 side (``NormaliserSides(pinned=...)``) the f32 readout's
    gradients are the f64 reference's."""
    num64 = np.array([[[[0.75]]]])
    den64 = np.array([[[[1.0 - 2.0 ** -26]]]])
    jax.config.update("jax_enable_x64", True)
    try:
        _, vjp = jax.vjp(lambda n, d: n / jax.numpy.maximum(
            jax.numpy.abs(d), 1.0), num64, den64)
        want_dnum, want_dden = (np.asarray(g) for g in vjp(np.ones(
            (1, 1, 1, 1))))
    finally:
        jax.config.update("jax_enable_x64", False)
    assert want_dden == 0.0 and want_dnum == 1.0

    def port(sides=None):
        num = torch.tensor(num64, dtype=torch.float32, requires_grad=True)
        den = torch.tensor(den64, dtype=torch.float32, requires_grad=True)
        assert float(den.detach()) == 1.0
        with PX.NormaliserSides(sides) as ns:
            y = PX._normalise(num, den)
        return [g.item() for g in torch.autograd.grad(y.sum(), [num, den])
                ], ns.seen

    (dnum, dden), seen = port()
    assert seen[0].item() and dnum == 1.0 and dden == -0.75
    (dnum, dden), _ = port(sides=[torch.tensor(den64) >= 1])
    assert (dnum, dden) == (1.0, 0.0)


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
