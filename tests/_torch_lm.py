"""LM helpers shared by the port's model tests (CPU, f32, reduced sizes).

A :class:`Case` holds one reduced config in both packages: the
reference's weights (``init_decoder`` on ``PRNGKey(0)``, optionally
edited as numpy) carried into the port by ``params_from_jax``, numpy-seeded
tokens and the reference's logits over the whole sequence.  ``ref_decode``
and ``port_decode`` run each package's one-token decode from an empty f32
cache.  ``close`` is the logits tolerance: ``atol = 1e-4 * max(1,
max|want|)``, ``rtol = 1e-4``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
from repro.launch.serve import main as ref_serve_main
from repro.models import transformer as RT
import repro_torch.configs as PC
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as PT
from repro_torch.train.step import make_serve_step

SERVE_ARGS = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen", "6"]


def close(got, want, tol=1e-4):
    want = np.asarray(want)
    atol = tol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=atol)


def t(a):
    return torch.from_numpy(np.array(a))


def configs(arch, **changes):
    ref = RC.reduced(RC.get_config(arch))
    port = PC.reduced(PC.get_config(arch))
    return (dataclasses.replace(ref, **changes),
            dataclasses.replace(port, **changes))


class Case:
    """One reduced config: both packages' params, ``tokens`` (B, S) and
    the reference's logits.  ``edit(tree)`` may change the reference's
    numpy weights before both packages get them."""

    def __init__(self, arch, B=2, S=64, edit=None, **changes):
        self.ref_cfg, self.cfg = configs(arch, **changes)
        tree = jax.tree.map(np.asarray, RT.init_decoder(jax.random.PRNGKey(0),
                                                        self.ref_cfg))
        if edit is not None:
            edit(tree)
        self.tree = tree
        self.ref_params = jax.tree.map(jnp.asarray, tree)
        self.params = params_from_jax(self.cfg, tree, device="cpu")
        self.tokens = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        fn = jax.jit(lambda p, tk: RT.decoder_apply(p, self.ref_cfg,
                                                    tokens=tk))
        logits, aux = fn(self.ref_params, self.tokens)
        self.ref_logits, self.ref_aux = np.asarray(logits), float(aux)

    def apply(self):
        with torch.no_grad():
            logits, aux = PT.decoder_apply(self.params, self.cfg,
                                           tokens=t(self.tokens))
        return logits.numpy(), float(aux)


def ref_decode(c, feed):
    """The reference's decode of ``S`` tokens from an empty f32 cache: the
    first ``feed`` from ``c.tokens`` (B, S), then its own greedy tokens."""
    B, S = c.tokens.shape
    step = jax.jit(lambda p, cache, tk: RT.decoder_decode(
        p, c.ref_cfg, cache, token=tk))
    cache = RT.init_decoder_cache(B, S, c.ref_cfg, dtype=jnp.float32)
    logits, tok = [], c.tokens[:, :1]
    for i in range(S):
        out, cache = step(c.ref_params, cache, tok)
        out = np.asarray(out)
        logits.append(out[:, 0])
        tok = (c.tokens[:, i + 1:i + 2] if i + 1 < feed
               else np.argmax(out[:, -1], axis=-1)[:, None].astype(np.int32))
    return np.stack(logits, 1)


def port_decode(c, feed):
    """The port's decode, as :func:`ref_decode`."""
    B, S = c.tokens.shape
    model, _ = make_serve_step(c.cfg, device="cpu")
    cache = model.init_cache(B, S, dtype=torch.float32)
    tokens = t(c.tokens)
    logits, tok = [], tokens[:, :1]
    with torch.no_grad():
        for i in range(S):
            out, cache = model.decode_step(c.params, cache, token=tok)
            logits.append(out[:, 0].numpy())
            tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
                   else torch.argmax(out[:, -1], -1)[:, None].to(torch.int32))
    return np.stack(logits, 1)


def hold_decode(c, feed):
    """Each step's logits of the port's decode within :func:`close` of the
    reference's, and the greedy tokens equal."""
    want, got = ref_decode(c, feed), port_decode(c, feed)
    for i in range(want.shape[1]):
        close(got[:, i], want[:, i])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def hold_serve(arch):
    """The serving loop's tokens: the reference's from ``PRNGKey(0)``, the
    port's handed the same weights, twice."""
    want = np.asarray(ref_serve_main(["--arch", arch] + SERVE_ARGS))
    ref_cfg = RC.reduced(RC.get_config(arch))
    tree = jax.tree.map(np.asarray,
                        RT.init_decoder(jax.random.PRNGKey(0), ref_cfg))
    params = params_from_jax(PC.reduced(PC.get_config(arch)), tree,
                             device="cpu")
    argv = ["--arch", arch] + SERVE_ARGS + ["--device", "cpu"]
    got = serve_main(argv, params=params)
    assert got.shape == (6, 2) and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(serve_main(argv, params=params), got)
