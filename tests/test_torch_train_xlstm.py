"""The xLSTM family's gradients: the port's against the reference's (CPU).

The reduced xlstm's f32 gradients of ``loss_fn`` differ between the two
packages by more than the 1e-4 of ``max|g|`` that holds every other
family (``GRAD_TOL``), while the forwards agree.  Settled here:

* every piece of an mLSTM block (``_mlstm_qkv``, the SSD scan on the
  per-head layout, the normaliser's ``max(|den|, 1)``, ``rms_norm``, the
  SiLU gate), the whole block and the sLSTM block have VJPs within 1e-5
  of ``max|g|`` of the reference's on the same input and cotangent, so
  no piece of the port differs;
* in f64 the two packages' gradients agree, and the reference's own
  f32 gradients stray from them past ``GRAD_TOL``
  (tests/test_torch_train_xlstm_f64.py), so the gap is f32 rounding
  that the stack of xLSTM blocks amplifies on the way back, in either
  package, not a fault of either.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import xlstm as RX
from repro.models.layers import rms_norm as ref_rms_norm
from repro.models.ssm import ssd_chunked as ref_ssd
from repro_torch.models import params_from_jax
from repro_torch.models import xlstm as PX
from repro_torch.models.layers import rms_norm

from _torch_train import TrainCase
from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PIECE_TOL = 1e-5
F32 = np.float32


def t(a):
    return torch.from_numpy(np.array(a))


def hold_vjp(got, want, tol=PIECE_TOL):
    """Each gradient within ``tol`` of its ``max|want|``."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        gap = float(np.abs(np.asarray(g) - w).max()) / scale
        assert gap <= tol, (i, gap)


@pytest.fixture(scope="module")
def model():
    """The reduced xlstm's first mLSTM and sLSTM blocks in both packages,
    an input (2, 32, d) and a cotangent, numpy-seeded."""
    case = TrainCase("xlstm-1.3b")
    params = params_from_jax(case.cfg, case.tree, device="cpu")
    seg = case.tree["segments"][0]
    r = np.random.default_rng(7)
    shape = (2, 32, case.cfg.d_model)
    return dict(
        cfg=case.cfg, ref_cfg=case.ref_cfg,
        m_tree=jax.tree.map(lambda a: a[0, 0], seg["mlstms"]),
        m_mod=params.segments[0][0].mlstms[0],
        s_tree=jax.tree.map(lambda a: a[0], seg["slstm"]),
        s_mod=params.segments[0][0].slstm,
        x=r.standard_normal(shape).astype(F32),
        ct=r.standard_normal(shape).astype(F32))


def port_vjp(fn, inputs, ct, params=()):
    """Gradients of ``sum(fn(*inputs) * ct)`` wrt ``inputs`` then
    ``params``."""
    leaves = [t(a).requires_grad_() for a in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    cts = ct if isinstance(ct, tuple) else (ct,)
    total = sum((o * t(c)).sum() for o, c in zip(outs, cts))
    return [g.numpy() for g in torch.autograd.grad(
        total, leaves + list(params))]


def ref_vjp(fn, inputs, ct, tree=None):
    """The reference's, as :func:`port_vjp` (``tree``: params, last)."""
    cts = ct if isinstance(ct, tuple) else (ct,)

    def total(*args):
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cts))

    args = list(inputs) + ([tree] if tree is not None else [])
    grads = jax.jit(jax.grad(total, argnums=tuple(range(len(args)))))(*args)
    head = list(grads[:len(inputs)])
    return head + (jax.tree.leaves(grads[-1]) if tree is not None else [])


def _tree_order(mod, tree):
    """The module's parameters in the order of ``tree``'s leaves."""
    named = dict(mod.named_parameters())
    paths = jax.tree_util.tree_leaves_with_path(tree)
    return [named[".".join(str(getattr(k, "key", k)) for k in path)]
            for path, _ in paths]


def test_mlstm_block_vjp(model):
    """One mLSTM block (pre-norm, cell, residual): gradients of its input
    and every weight."""
    cfg, rc, mod, tree = (model["cfg"], model["ref_cfg"], model["m_mod"],
                          model["m_tree"])
    got = port_vjp(lambda x: x + PX.mlstm_apply(
        mod.core, rms_norm(x, mod.ln.scale, cfg.norm_eps), cfg),
        [model["x"]], model["ct"], _tree_order(mod, tree))
    want = ref_vjp(lambda x, p: x + RX.mlstm_apply(
        p["core"], ref_rms_norm(p["ln"], x, rc.norm_eps), rc),
        [model["x"]], model["ct"], tree)
    hold_vjp(got, want)


def test_slstm_block_vjp(model):
    cfg, rc, mod, tree = (model["cfg"], model["ref_cfg"], model["s_mod"],
                          model["s_tree"])
    got = port_vjp(lambda x: x + PX.slstm_apply(
        mod.core, rms_norm(x, mod.ln.scale, cfg.norm_eps), cfg),
        [model["x"]], model["ct"], _tree_order(mod, tree))
    want = ref_vjp(lambda x, p: x + RX.slstm_apply(
        p["core"], ref_rms_norm(p["ln"], x, rc.norm_eps), rc),
        [model["x"]], model["ct"], tree)
    hold_vjp(got, want)


def test_mlstm_qkv_vjp(model):
    """q, k, v and the two log-sigmoid gates (torch's softplus, threshold
    20, against ``-jax.nn.softplus``), gates pushed past the threshold."""
    cfg, rc, mod, tree = (model["cfg"], model["ref_cfg"], model["m_mod"],
                          model["m_tree"])
    x = model["x"] * 8.0
    r = np.random.default_rng(8)
    shapes = [(2, 32, cfg.n_heads, cfg.head_dim_)] * 3 + [
        (2, 32, cfg.n_heads)] * 2
    ct = tuple(r.standard_normal(s).astype(F32) for s in shapes)
    used = {k: tree["core"][k] for k in ("wq", "wk", "wv", "w_gates")}
    got = port_vjp(lambda x: PX._mlstm_qkv(mod.core, x, cfg), [x], ct,
                   _tree_order(mod.core, used))
    want = ref_vjp(lambda x, p: RX._mlstm_qkv(p, x, rc), [x], ct, used)
    hold_vjp(got, want)


def test_per_head_scan_vjp():
    """The SSD scan a head: the port folds the heads into the batch axis,
    the reference ``vmap``s over them."""
    r = np.random.default_rng(9)
    B, L, H, P, N = 2, 32, 4, 17, 16
    xs = r.standard_normal((B, L, H, P)).astype(F32)
    log_f = -np.abs(r.standard_normal((B, L, H))).astype(F32)
    k = r.standard_normal((B, L, H, N)).astype(F32)
    q = r.standard_normal((B, L, H, N)).astype(F32)
    ct = r.standard_normal((B, L, H, P)).astype(F32)

    def ref(xs, a, k, q):
        def per_head(xh, ah, Bh, Ch):
            return ref_ssd(xh[:, :, None], ah[..., None], Bh, Ch)[0][:, :, 0]
        return jax.vmap(per_head, in_axes=(2, 2, 2, 2), out_axes=2)(
            xs, a, k, q)

    hold_vjp(port_vjp(PX._per_head_scan, [xs, log_f, k, q], ct),
             ref_vjp(ref, [xs, log_f, k, q], ct))


def test_normaliser_vjp():
    """``num / max(|den|, 1)``: torch's ``clamp`` against ``jnp.maximum``
    with ``den`` on both sides of +-1 (never exactly at it)."""
    r = np.random.default_rng(10)
    num = r.standard_normal((64, 16)).astype(F32)
    den = (r.uniform(0.5, 1.5, (64, 1)) * r.choice([-1, 1], (64, 1))
           ).astype(F32)
    den[np.abs(den) == 1.0] = 1.25
    ct = r.standard_normal((64, 16)).astype(F32)
    hold_vjp(port_vjp(lambda n, d: n / torch.clamp(d.abs(), min=1.0),
                      [num, den], ct),
             ref_vjp(lambda n, d: n / jnp.maximum(jnp.abs(d), 1.0),
                     [num, den], ct))


def test_rms_norm_and_silu_gate_vjp(model):
    """The block's output gate ``y * silu(z)`` and its ``rms_norm``."""
    cfg, rc, mod, tree = (model["cfg"], model["ref_cfg"], model["m_mod"],
                          model["m_tree"])
    r = np.random.default_rng(11)
    shape = (2, 32, cfg.n_heads * cfg.head_dim_)
    y, z = (r.standard_normal(shape).astype(F32) for _ in range(2))
    ct = r.standard_normal(shape).astype(F32)
    got = port_vjp(lambda y, z: rms_norm(y * F.silu(z), mod.core.norm.scale,
                                         cfg.norm_eps), [y, z], ct,
                   [mod.core.norm.scale])
    want = ref_vjp(lambda y, z, p: ref_rms_norm(p, y * jax.nn.silu(z),
                                                rc.norm_eps), [y, z], ct,
                   tree["core"]["norm"])
    hold_vjp(got, want)
