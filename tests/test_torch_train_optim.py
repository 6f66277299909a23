"""The port's AdamW, LR schedule and int8 gradient compression against
the reference's (CPU).

* ``lr_at`` bit for bit in f32 against the reference's ``lr_at`` over
  warmup, the cosine and past its end, for three schedules;
* ``apply_updates`` on seeded numpy trees over three steps, with the clip
  active and inactive: parameters, ``mu``, ``nu`` within 2e-6 relative,
  or 2e-6 of the tensor's largest value (the global norm sums its tensors
  in another order, so the clip differs in its last places, and XLA's
  f32 pow in the bias corrections is not torch's), ``grad_norm`` and
  ``lr`` within 1e-6 relative, ``step`` equal;
* ``compress_tree_int8`` and ``ef_compress`` (three rounds, residual
  included) bit for bit, each tensor its own leaf and with a stacked
  leaf's layers sharing one scale (``leaf_of``);
* a serve step after a train step reads the updated weights: the bf16
  copies ``models.layers.cast`` keeps are dropped when a parameter is
  written in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.distributed import compression as RC
from repro.train import optim as RO
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import compression as PC
from repro_torch.train import optim as PO
from repro_torch.train.step import make_serve_step, make_train_step

from _torch_train import torch_one_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

SCHEDULES = [dict(), dict(lr=1e-3, warmup_steps=2, total_steps=40),
             dict(lr=1e-3, warmup_steps=7, total_steps=333,
                  min_lr_ratio=0.05)]
SHAPES = {"a": {"w": (16, 24), "b": (24,)}, "c": (3, 5, 7), "d": (1,)}


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("sched", range(len(SCHEDULES)))
def test_lr_at_bit_equal(sched):
    kw = SCHEDULES[sched]
    ref_cfg, cfg = RO.AdamWConfig(**kw), PO.AdamWConfig(**kw)
    steps = range(0, cfg.total_steps + 20)
    want = np.array([np.asarray(RO.lr_at(jnp.int32(s), ref_cfg))
                     for s in steps])
    got = np.array([PO.lr_at(s, cfg).numpy() for s in steps])
    assert got.dtype == np.float32
    assert np.array_equal(bits(got), bits(want))
    # an int32 tensor step gives the same
    assert bits(PO.lr_at(torch.tensor(5, dtype=torch.int32), cfg)) == \
        bits(want[5])


class Tree(nn.Module):
    """A module whose parameter names are the tree's paths (``a.w``)."""

    def __init__(self, tree):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                setattr(self, k, Tree(v))
            else:
                setattr(self, k, nn.Parameter(torch.from_numpy(v.copy())))


def _named(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _tree(shapes, rng, scale=1.0):
    return {k: _tree(v, rng, scale) if isinstance(v, dict)
            else (scale * rng.standard_normal(v)).astype(np.float32)
            for k, v in shapes.items()}


@pytest.mark.parametrize("grad_scale,clipped", [(1.0, True), (0.01, False)])
def test_apply_updates(grad_scale, clipped):
    rng = np.random.default_rng(3)
    params = _tree(SHAPES, rng)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20)
    ref_cfg, cfg = RO.AdamWConfig(**kw), PO.AdamWConfig(**kw)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = RO.init_opt(ref_p)
    mod = Tree(params)
    state = PO.init_opt(mod)
    for _ in range(3):
        grads = _tree(SHAPES, rng, grad_scale)
        ref_p, ref_s, rm = RO.apply_updates(ref_p, jax.tree.map(
            jnp.asarray, grads), ref_s, ref_cfg)
        mod, state, m = PO.apply_updates(
            mod, {n: torch.from_numpy(g) for n, g in _named(grads)}, state,
            cfg)
        assert (float(rm["grad_norm"]) > 1.0) == clipped
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        assert int(state.step) == int(ref_s.step)
        for name, want in _named(jax.tree.map(np.asarray, ref_p)):
            np.testing.assert_allclose(
                dict(mod.named_parameters())[name].detach().numpy(), want,
                rtol=2e-6, atol=2e-6 * np.abs(want).max(), err_msg=name)
        for key in ("mu", "nu"):
            for name, want in _named(jax.tree.map(
                    np.asarray, getattr(ref_s, key))):
                np.testing.assert_allclose(getattr(state, key)[name].numpy(),
                                           want, rtol=2e-6,
                                           atol=2e-6 * np.abs(want).max(),
                                           err_msg=f"{key} {name}")


def _grads(rng):
    g = _tree(SHAPES, rng, 1e-3)
    g["a"]["b"][3] = 0.0
    g["d"][0] = 0.0  # an all-zero tensor: the scale's 1e-12 floor
    return g


def test_compress_tree_int8_bit_equal():
    g = _grads(np.random.default_rng(5))
    want = dict(_named(jax.tree.map(np.asarray, RC.compress_tree_int8(
        jax.tree.map(jnp.asarray, g)))))
    got = PC.compress_tree_int8({n: torch.from_numpy(a)
                                 for n, a in _named(g)})
    for n, w in want.items():
        assert np.array_equal(bits(got[n]), bits(w)), n


def test_compress_stacked_leaf_shares_its_scale():
    """A stacked leaf ``(layers, ...)`` is one tensor to the reference:
    the port's per-layer tensors of it, grouped by ``leaf_of``, share its
    scale and come out equal bit for bit."""
    rng = np.random.default_rng(6)
    stacked = (1e-3 * rng.standard_normal((4, 8, 9))).astype(np.float32)
    stacked[2] *= 50.0                   # one layer holds the leaf's max
    want = np.asarray(RC.compress_tree_int8({"w": jnp.asarray(stacked)})["w"])
    layers = {f"{i}.w": torch.from_numpy(stacked[i]) for i in range(4)}
    got = PC.compress_tree_int8(layers, leaf_of=lambda n: n.split(".")[1])
    for i in range(4):
        assert np.array_equal(bits(got[f"{i}.w"]), bits(want[i]))
    alone = PC.compress_tree_int8(layers)
    assert not np.array_equal(bits(alone["0.w"]), bits(want[0]))


def test_ef_compress_bit_equal():
    rng = np.random.default_rng(7)
    g0 = _grads(rng)
    ref_state = RC.ef_init(jax.tree.map(jnp.asarray, g0))
    comp = PC.EFCompressor({n: torch.from_numpy(a) for n, a in _named(g0)})
    for _ in range(3):
        g = _grads(rng)
        want, ref_state = RC.ef_compress(jax.tree.map(jnp.asarray, g),
                                         ref_state)
        got = comp({n: torch.from_numpy(a) for n, a in _named(g)})
        for (n, w), (_, r) in zip(
                _named(jax.tree.map(np.asarray, want)),
                _named(jax.tree.map(np.asarray, ref_state.residual))):
            assert np.array_equal(bits(got[n]), bits(w)), n
            assert np.array_equal(bits(comp.state.residual[n]), bits(r)), n


def test_serve_step_after_train_step_reads_new_weights():
    """bf16 gemma3 (reduced): decode, train one step, decode again — the
    second decode equals a decode of a fresh copy of the trained weights
    and differs from the first."""
    cfg = reduced(get_config("gemma3-1b"))
    cfg = type(cfg)(**{**cfg.__dict__, "dtype": "bfloat16"})
    model, train_step = make_train_step(
        cfg, PO.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4),
        device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, serve = make_serve_step(cfg, device="cpu")
    tok = torch.tensor([[3], [7]], dtype=torch.int32)

    def logits(p):
        cache = model.init_cache(2, 4, dtype=torch.float32)
        with torch.no_grad():
            return model.decode_step(p, cache, token=tok)[0]

    before = logits(params)
    serve(params, model.init_cache(2, 4, dtype=torch.float32),
          {"token": tok})
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    params, _, _ = train_step(params, PO.init_opt(params),
                              {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    after = logits(params)
    fresh = type(params)(cfg, device="cpu")
    fresh.load_state_dict(params.state_dict())
    assert torch.equal(after, logits(fresh))
    assert not torch.equal(after, before)
