"""Encoder-decoder helpers shared by the port's whisper tests (CPU).

:class:`Whisper` holds reduced whisper-medium in both packages: the
reference's weights (``init_encdec`` on ``PRNGKey(0)``) carried into the
port by ``params_from_jax``, and the reference's jitted encode, apply,
prefill-memory and decode (scanned and unrolled).  ``inputs(T)`` gives
numpy-seeded frames (B, T, d_model) and decoder tokens (B, S_DEC).  The
``hold_*`` checks hold one form of the port against the reference (or
its own prefill) at ``tests/_torch_lm.py::close``'s 10^-4 of the logit
scale, for a memory of ``T`` frames; ``count_blocked`` records each call
of the port's ``_sdpa_blocked``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import encdec as RE
from repro_torch.models import attention as PA
from repro_torch.models import build
from repro_torch.models import encdec as PE
from repro_torch.models import params_from_jax

from _torch_lm import close, configs, t

ARCH = "whisper-medium"
B, S_DEC, FEED = 2, 12, 6


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class Whisper:
    """Reduced whisper in both packages at ``dtype``, with the reference's
    jitted encode / apply / prefill-memory / decode."""

    def __init__(self, dtype="float32"):
        self.ref_cfg, self.cfg = configs(ARCH, dtype=dtype)
        rc = self.ref_cfg
        self.tree = np_tree(RE.init_encdec(jax.random.PRNGKey(0), rc))
        self.params = params_from_jax(self.cfg, self.tree, device="cpu")
        self.encode = jax.jit(lambda p, f: RE.encdec_encode(p, rc, f))
        self.apply = jax.jit(lambda p, f, d: RE.encdec_apply(p, rc, f, d))
        self.memory = jax.jit(lambda p, f, c: RE.encdec_prefill_memory(
            p, rc, f, c))
        self.step = jax.jit(lambda p, c, tk: RE.encdec_decode(p, rc, c, tk))
        self.step_unrolled = jax.jit(lambda p, c, tk: RE.encdec_decode(
            p, rc, c, tk, unroll=True))

    def inputs(self, T):
        rng = np.random.default_rng(T)
        frames = rng.standard_normal((B, T, self.cfg.d_model)).astype(
            np.float32)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (B, S_DEC)).astype(np.int32)
        return frames, tokens

    def ref_cache(self, frames, max_len):
        cache = RE.init_encdec_cache(B, max_len, self.ref_cfg, jnp.float32,
                                     mem_len=frames.shape[1])
        return self.memory(self.tree, frames, cache)

    def port_cache(self, frames, max_len):
        model = build(self.cfg, device="cpu")
        cache = model.init_cache(B, max_len, dtype=torch.float32,
                                 mem_len=frames.shape[1])
        return model, PE.encdec_prefill_memory(self.params, self.cfg,
                                               t(frames), cache)


def ref_decode(w, cache, tokens, feed, step):
    """Each step's logits of the reference's decode: the first ``feed``
    tokens from ``tokens``, then its own greedy tokens."""
    out, tok = [], tokens[:, :1]
    for i in range(tokens.shape[1]):
        logits, cache = step(w.tree, cache, tok)
        logits = np.asarray(logits.astype(jnp.float32))[:, 0]
        out.append(logits)
        tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
               else np.argmax(logits, -1)[:, None].astype(np.int32))
    return np.stack(out, 1)


def port_decode(w, model, cache, tokens, feed):
    """The port's decode, as :func:`ref_decode`."""
    tokens = t(tokens)
    out, tok = [], tokens[:, :1]
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            logits, cache = model.decode_step(w.params, cache, token=tok)
            out.append(logits[:, 0].float().numpy())
            tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
                   else torch.argmax(logits[:, 0], -1)[:, None].to(
                       torch.int32))
    return np.stack(out, 1)


def count_blocked(monkeypatch):
    """Record the query length of each call of the port's
    ``_sdpa_blocked`` from here on; returns the list."""
    calls, blocked = [], PA._sdpa_blocked

    def counting(*a, **kw):
        calls.append(a[0].shape[1])
        return blocked(*a, **kw)

    monkeypatch.setattr(PA, "_sdpa_blocked", counting)
    return calls


def hold_encode(w, T):
    frames, _ = w.inputs(T)
    want = w.encode(w.tree, frames)
    with torch.no_grad():
        got = PE.encdec_encode(w.params, w.cfg, t(frames))
    close(got.numpy(), want)


def hold_apply(w, T):
    frames, tokens = w.inputs(T)
    want, want_aux = w.apply(w.tree, frames, tokens)
    with torch.no_grad():
        got, aux = PE.encdec_apply(w.params, w.cfg, t(frames), t(tokens))
    assert got.shape == (B, S_DEC, w.cfg.padded_vocab)
    close(got.numpy(), want)
    assert float(aux) == float(want_aux) == 0.0 and aux.dtype == torch.float32


def hold_prefill_memory(w, T):
    frames, _ = w.inputs(T)
    want = w.ref_cache(frames, S_DEC)
    _, got = w.port_cache(frames, S_DEC)
    L = w.cfg.n_layers
    for g, r in ((got.mem_k, want.mem_k), (got.mem_v, want.mem_v)):
        assert g.shape == (L, B, T, w.cfg.n_kv_heads, w.cfg.head_dim_)
        assert g.dtype == torch.float32
        close(g.numpy(), r)
    assert [kv.length for kv in got.self_kv] == [0] * L


def hold_decode(w, T):
    """Every step's logits against the reference's scanned decode, the
    first FEED tokens fed, then greedy; the greedy tokens equal."""
    frames, tokens = w.inputs(T)
    want = ref_decode(w, w.ref_cache(frames, S_DEC), tokens, FEED, w.step)
    model, cache = w.port_cache(frames, S_DEC)
    got = port_decode(w, model, cache, tokens, FEED)
    for i in range(S_DEC):
        close(got[:, i], want[:, i])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def hold_decode_against_own_prefill(w, T):
    """The port's decode, every token fed, against its own prefill at
    every position (the reference's two forms agree for whisper)."""
    frames, tokens = w.inputs(T)
    model, cache = w.port_cache(frames, S_DEC)
    got = port_decode(w, model, cache, tokens, S_DEC)
    with torch.no_grad():
        want = model.apply(w.params, frames=t(frames),
                           dec_tokens=t(tokens))[0].numpy()
    close(got, want)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))
