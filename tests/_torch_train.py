"""Training helpers shared by the port's train-step tests (CPU, f32,
reduced sizes).

:class:`TrainCase` holds one reduced config in both packages: the
reference's weights (``init_decoder`` / ``init_encdec`` on
``PRNGKey(0)``) carried into the port by ``params_from_jax``, and
``steps`` batches from the reference's ``TokenPipeline`` (the port's gives
the same, tests/test_torch_train_ckpt.py; whisper gets
numpy-seeded ``frames`` and the pipeline's tokens as ``dec_tokens``;
qwen2-vl numpy-seeded ``embeddings`` and M-RoPE ``positions``).
``run_ref`` runs the reference's jitted ``train_step`` (and its jitted
gradients of ``loss_fn`` before the first step), ``run_port`` the port's
``make_train_step`` on the CPU, each from its own copy of the weights.
Test modules import ``torch_one_thread`` (an autouse fixture).

Bounds (``hold_step``), each argued from f32 rounding in another order:

* loss and ce within 1e-5 relative;
* every gradient within ``GRAD_TOL`` = 1e-4 of its tensor's ``max|g|``
  (xlstm: ``XLSTM_GRAD_TOL``, tests/test_torch_train_xlstm_f64.py);
* ``grad_norm`` within 1e-5 relative (xlstm: its gradient bound) and
  ``lr`` within 1e-6 relative (the jitted reference divides by a
  constant through its f32 reciprocal);
* ``mu`` within the gradient bound of its ``max|mu|`` and ``nu`` within
  twice it of its ``max|nu|`` (a square doubles a relative error);
  ``step`` equal;
* each updated parameter within ``lr * (UPDATE_TOL + du)`` of the
  reference's, ``lr`` the step's.  A first Adam step moves a weight by ``lr * (u(g) +
  weight_decay * p)`` with ``u(g) = g / (|g| + eps)``, ``g`` the
  gradient as the step used it, clipped and compressed (after one step
  ``mu = (1 - b1) g``).  ``du = |u(g_port) - u(g_ref)|`` is what the
  two gradients' gap moves: about 0 where ``|g| >> eps``, a share of
  the step where ``|g|`` is near ``eps``, and up to 2 only where the
  two signs differ.  UPDATE_TOL is the share of a step that the
  arithmetic's own rounding can move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.train import optim as RO
from repro.train import step as RS
from repro_torch.models import params_from_jax
from repro_torch.models.convert import tree_of
from repro_torch.train import optim as PO
from repro_torch.train import step as PS

from _torch_lm import configs

B, S = 2, 32
GRAD_TOL = 1e-4
# xlstm: twice the reference's own f32 gradients' largest gap from their
# f64 values, as measured (tests/_torch_xlstm_f64.py over two batches:
# 1.66e-4); tests/test_torch_train_xlstm_f64.py holds that reading at
# F64_GAP_HEADROOM times it, room for another CPU's or BLAS's rounding
XLSTM_F64_GAP = 1.66e-4
F64_GAP_HEADROOM = 1.1
XLSTM_GRAD_TOL = 2 * XLSTM_F64_GAP
UPDATE_TOL = 1e-2
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """Run a module's torch ops on one thread.  At these sizes a thread
    pool buys nothing, and under several test workers on a few cores its
    threads wait on each other (a 9 s training-loop test took 113 s)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def batch_for(cfg, step, seed=0):
    """The step's batch (numpy), from the reference's ``TokenPipeline``
    and numpy seeds; the port's pipeline gives the same tokens (held in
    tests/test_torch_train_ckpt.py)."""
    toks = RefPipeline(vocab=cfg.vocab_size, batch=B, seq_len=S,
                       seed=seed).batch_at(step)
    rng = np.random.default_rng([seed, step])
    if cfg.encoder_decoder:
        return {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
                    np.float32),
                "dec_tokens": toks["tokens"], "labels": toks["labels"]}
    if cfg.frontend == "vision":
        pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None, None],
                              (3, B, S)).copy()
        return {"embeddings": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32), "positions": pos,
                "labels": toks["labels"]}
    return dict(toks)


class TrainCase:
    """One reduced config in both packages and ``steps`` batches."""

    def __init__(self, arch, steps=1, compress_grads=False, **changes):
        self.arch = arch
        self.ref_cfg, self.cfg = configs(arch, **changes)
        init = RE.init_encdec if self.ref_cfg.encoder_decoder \
            else RT.init_decoder
        self.tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                                  self.ref_cfg))
        self.batches = [batch_for(self.cfg, i) for i in range(steps)]
        self.compress = compress_grads
        self.ref_opt = RO.AdamWConfig(**OPT)
        self.opt = PO.AdamWConfig(**OPT)

    def run_ref(self):
        """The reference: gradients at the first batch, each step's metrics
        (floats), and (params, OptState) after the first step as numpy."""
        model, step = RS.make_train_step(self.ref_cfg, self.ref_opt,
                                         compress_grads=self.compress)
        params = jax.tree.map(jnp.asarray, self.tree)
        b0 = {k: jnp.asarray(v) for k, v in self.batches[0].items()}
        grads = jax.jit(jax.grad(lambda p: RS.loss_fn(
            model, p, b0, self.ref_cfg)[0]))(params)
        opt_state = RO.init_opt(params)
        jit_step = jax.jit(step)
        out = dict(grads=jax.tree.map(np.asarray, grads), metrics=[])
        for b in self.batches:
            params, opt_state, m = jit_step(
                params, opt_state, {k: jnp.asarray(v) for k, v in b.items()})
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if len(out["metrics"]) == 1:
                out.update(params=jax.tree.map(np.asarray, params),
                           mu=jax.tree.map(np.asarray, opt_state.mu),
                           nu=jax.tree.map(np.asarray, opt_state.nu),
                           step=int(opt_state.step))
        return out

    def run_port(self):
        """The port, as :meth:`run_ref`; trees in the reference's layout."""
        params = params_from_jax(self.cfg, self.tree, device="cpu")
        model, step = PS.make_train_step(self.cfg, self.opt,
                                         compress_grads=self.compress,
                                         device="cpu")
        b0 = {k: torch.from_numpy(v) for k, v in self.batches[0].items()}
        loss, _ = PS.loss_fn(model, params, b0, self.cfg)
        named = list(params.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        grads = tree_of({n: g for (n, _), g in zip(named, grads)})
        opt_state = PO.init_opt(params)
        out = dict(grads=grads, metrics=[])
        for b in self.batches:
            params, opt_state, m = step(params, opt_state, b)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            if len(out["metrics"]) == 1:
                out.update(params=tree_of(dict(params.named_parameters())),
                           mu=tree_of(opt_state.mu),
                           nu=tree_of(opt_state.nu),
                           step=int(opt_state.step))
        return out


class Runs:
    """``runs(arch, compress=False) -> (case, port run, reference run)``,
    each made once: over three steps for the archs in ``three``, with the
    config changes ``changes[arch]``."""

    def __init__(self, three=(), changes=None):
        self.three, self.changes, self.cache = three, changes or {}, {}

    def __call__(self, arch, compress=False):
        key = (arch, compress)
        if key not in self.cache:
            case = TrainCase(arch, steps=3 if arch in self.three else 1,
                             compress_grads=compress,
                             **self.changes.get(arch, {}))
            self.cache[key] = (case, case.run_port(), case.run_ref())
        return self.cache[key]


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def grad_gaps(got, want):
    """``{leaf path: max|got - want| / max|want|}`` over two grad trees."""
    out = {}
    for (path, w), g in zip(_leaves(want), jax.tree.leaves(got)):
        scale = max(float(np.abs(w).max()), 1e-30)
        out[jax.tree_util.keystr(path)] = float(np.abs(g - w).max()) / scale
    return out


def rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def hold_losses(got, want, tol=1e-5):
    """Each step's loss and ce within ``tol`` relative.  (After the first
    step the weights differ where an Adam step took either sign, so later
    gradient norms differ by more than the first step's.)"""
    for g, w in zip(got, want, strict=True):
        assert rel(g["loss"], w["loss"]) <= tol, (g, w)
        assert rel(g["ce"], w["ce"]) <= tol, (g, w)


def hold_metrics(got, want, norm_tol=1e-5):
    """A step's loss and ce within 1e-5 relative, grad_norm within
    ``norm_tol`` and lr within 1e-6 relative."""
    hold_losses([got], [want])
    assert rel(got["grad_norm"], want["grad_norm"]) <= norm_tol, (got, want)
    assert rel(got["lr"], want["lr"]) <= 1e-6, (got, want)


def adam_direction(mu, opt):
    """``u(g) = g / (|g| + eps)`` of a first Adam step, in f64, from its
    first moment ``mu = (1 - b1) g``."""
    g = np.asarray(mu, np.float64) / (1 - opt.b1)
    return g / (np.abs(g) + opt.eps)


def hold_step(got, want, grad_tol=GRAD_TOL, opt=PO.AdamWConfig(**OPT)):
    """One step of the port against the reference's (module docstring)."""
    hold_metrics(got["metrics"][0], want["metrics"][0],
                 norm_tol=max(1e-5, grad_tol))
    gaps = grad_gaps(got["grads"], want["grads"])
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= grad_tol, (worst, gaps[worst])
    for key, tol in (("mu", grad_tol), ("nu", 2 * grad_tol)):
        for (path, w), g in zip(_leaves(want[key]),
                                jax.tree.leaves(got[key])):
            atol = tol * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=atol,
                                       err_msg=f"{key}{path}")
    assert got["step"] == want["step"]
    lr = want["metrics"][0]["lr"]
    for (path, w), g, mw, mg in zip(
            _leaves(want["params"]), jax.tree.leaves(got["params"]),
            jax.tree.leaves(want["mu"]), jax.tree.leaves(got["mu"])):
        du = np.abs(adam_direction(mg, opt) - adam_direction(mw, opt))
        atol = lr * (UPDATE_TOL + du)
        bad = np.abs(g - w) > atol
        assert not bad.any(), (path, float(np.abs(g - w)[bad].max()))
