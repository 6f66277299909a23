"""The port's dense decoders and serving loop against the reference (CPU).

The reference's weights (``init_decoder`` on ``PRNGKey(0)``) reach the
port through ``params_from_jax``; inputs come from numpy seeds; all in
f32 at reduced sizes.  Five configs: reduced gemma3-1b (two local/global
super-blocks), the same at 14 layers (``local_global`` x 2 then a
``local_only`` segment), granite-20b (MQA), qwen2-72b (QKV bias) and
qwen2-vl-7b (embeddings in, three position streams).

Tolerance for logits: ``atol = 1e-4 * max(1, max|logits|)``, rtol 1e-4
(the two packages sum f32 products in different orders through up to 14
layers; measured differences are below 1e-5 at a logit scale of ~4.5).
Greedy tokens and the serving loop's tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch.serve import main as ref_serve_main
from repro.models import attention as RA
from repro.models import transformer as RT
import repro_torch.configs as PC
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import attention as PA
from repro_torch.models import build, params_from_jax
from repro_torch.models import transformer as PT
from repro_torch.train.step import make_prefill_step, make_serve_step

jax.config.update("jax_platforms", "cpu")

B, S = 2, 80   # 80 tokens: past the reduced window of 64
CONFIGS = {
    "gemma3-1b": ("gemma3-1b", None),
    "gemma3-1b-14": ("gemma3-1b", 14),
    "granite-20b": ("granite-20b", None),
    "qwen2-72b": ("qwen2-72b", None),
    "qwen2-vl-7b": ("qwen2-vl-7b", None),
}
GEMMA = ["gemma3-1b", "gemma3-1b-14"]


def _configs(name):
    arch, n_layers = CONFIGS[name]
    ref = RC.reduced(RC.get_config(arch))
    port = PC.reduced(PC.get_config(arch))
    if n_layers:
        ref = dataclasses.replace(ref, n_layers=n_layers)
        port = dataclasses.replace(port, n_layers=n_layers)
    return ref, port


def _close(got, want):
    want = np.asarray(want)
    atol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol)


class Case:
    """One config: both packages' params and inputs, the reference's
    logits over the whole sequence."""

    def __init__(self, name):
        self.name = name
        self.ref_cfg, self.cfg = _configs(name)
        self.ref_params = RT.init_decoder(jax.random.PRNGKey(0), self.ref_cfg)
        self.params = params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.ref_params), device="cpu")
        rng = np.random.default_rng(1)
        if self.cfg.frontend == "vision":
            emb = rng.standard_normal(
                (B, S, self.cfg.d_model)).astype(np.float32)
            pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S))
            pos = pos + rng.integers(0, 5, (3, 1, 1)).astype(np.int32)
            self.inputs = dict(embeddings=emb, positions=pos)
        else:
            self.inputs = dict(tokens=rng.integers(
                0, self.cfg.vocab_size, (B, S)).astype(np.int32))
        self.ref_logits = self.ref_apply()

    def ref_apply(self):
        fn = jax.jit(lambda p, kw: RT.decoder_apply(p, self.ref_cfg, **kw)[0])
        return np.asarray(fn(self.ref_params, self.inputs))

    def apply(self):
        with torch.no_grad():
            logits, aux = PT.decoder_apply(
                self.params, self.cfg,
                **{k: torch.from_numpy(np.array(v))
                   for k, v in self.inputs.items()})
        assert float(aux) == 0.0
        return logits.numpy()


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    return Case(request.param)


@pytest.fixture(scope="module")
def gemma_cases():
    return {name: Case(name) for name in GEMMA}


def test_decoder_apply_logits(case):
    got = case.apply()
    assert got.shape == (B, S, case.cfg.padded_vocab)
    _close(got, case.ref_logits)


def test_segments_equal_the_reference(case):
    assert PT.segments_for(case.cfg) == RT.segments_for(case.ref_cfg)


def test_fourteen_layer_gemma_has_a_local_only_segment():
    _, cfg = _configs("gemma3-1b-14")
    assert PT.segments_for(cfg) == [("local_global", 2, 6),
                                    ("local_only", 2, 1)]


def test_prefill_step_is_the_last_position(case):
    _, prefill = make_prefill_step(case.cfg, device="cpu")
    got = prefill(case.params, {k: torch.from_numpy(np.array(v))
                                for k, v in case.inputs.items()})
    _close(got.numpy(), case.ref_logits[:, -1])


def test_blocked_path_through_the_whole_model(monkeypatch, gemma_cases):
    """80 tokens past a threshold of 32: every layer takes the blocked
    online-softmax path in both packages, windowed and global."""
    c = gemma_cases["gemma3-1b-14"]
    for mod in (RA, PA):
        monkeypatch.setattr(mod, "_BLOCK_Q", 16)
        monkeypatch.setattr(mod, "_BLOCK_KV", 24)
        monkeypatch.setattr(mod, "_BLOCK_THRESHOLD", 32)
    want = np.asarray(RT.decoder_apply(c.ref_params, c.ref_cfg,
                                       **c.inputs)[0])
    got = c.apply()
    _close(got, want)
    _close(got, c.ref_logits)


def _ref_decode(c, feed):
    """The reference's decode of ``S`` steps from an empty cache: the first
    ``feed`` tokens from the inputs, then its own greedy tokens."""
    step = jax.jit(lambda p, cache, t: RT.decoder_decode(
        p, c.ref_cfg, cache, token=t))
    cache = RT.init_decoder_cache(B, S, c.ref_cfg, dtype=jnp.float32)
    tokens = c.inputs["tokens"]
    logits, tok = [], tokens[:, :1]
    for i in range(S):
        out, cache = step(c.ref_params, cache, tok)
        out = np.asarray(out)
        logits.append(out[:, 0])
        tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
               else np.argmax(out[:, -1], axis=-1)[:, None].astype(np.int32))
    return np.stack(logits, 1)


def _decode(c, feed):
    model, serve_step = make_serve_step(c.cfg, device="cpu")
    cache = model.init_cache(B, S, dtype=torch.float32)
    tokens = torch.from_numpy(c.inputs["tokens"])
    logits, tok = [], tokens[:, :1]
    with torch.no_grad():
        for i in range(S):
            out, cache = model.decode_step(c.params, cache, token=tok)
            logits.append(out[:, 0].numpy())
            tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
                   else torch.argmax(out[:, -1], -1)[:, None].to(torch.int32))
    return np.stack(logits, 1)


@pytest.mark.parametrize("name", GEMMA)
def test_decode_through_the_ring_equals_the_reference(gemma_cases, name):
    """80 steps against local caches of 64 slots: the ring wraps.  The
    first 40 tokens come from the input, the last 40 are each package's
    own greedy tokens, which must be equal."""
    c = gemma_cases[name]
    cache = PT.init_decoder_cache(B, S, c.cfg, torch.float32, "cpu")
    ref_cache = RT.init_decoder_cache(B, S, c.ref_cfg, dtype=jnp.float32)
    assert cache[0][0]["locals"][0].k.shape == \
        ref_cache[0]["locals"].k.shape[2:] == (B, 64, 1, 16)
    assert cache[0][0]["global"].k.shape == (B, S, 1, 16)
    want, got = _ref_decode(c, feed=40), _decode(c, feed=40)
    for i in range(S):
        _close(got[:, i], want[:, i])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", GEMMA)
def test_port_decode_equals_port_apply(gemma_cases, name):
    """The port's own decode, fed the whole input, against its own
    full-sequence forward at every position (the check the card repeats
    at full width past the 512-token ring)."""
    c = gemma_cases[name]
    _close(_decode(c, feed=S), c.apply())


def test_decode_past_the_cache_raises(gemma_cases):
    c = gemma_cases["gemma3-1b"]
    model = build(c.cfg, device="cpu")
    cache = model.init_cache(B, 2, dtype=torch.float32)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    with torch.no_grad():
        for _ in range(2):
            _, cache = model.decode_step(c.params, cache, token=tok)
        with pytest.raises(IndexError):
            model.decode_step(c.params, cache, token=tok)


SERVE_ARGS = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen", "6"]


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-20b", "qwen2-vl-7b"])
def test_serving_loop_tokens_equal_the_reference(arch):
    """The reference's serving loop initialises from ``PRNGKey(0)``; the
    port's is handed the same weights through ``params_from_jax``."""
    want = ref_serve_main(["--arch", arch] + SERVE_ARGS)
    ref_cfg = RC.reduced(RC.get_config(arch))
    tree = jax.tree.map(np.asarray,
                        RT.init_decoder(jax.random.PRNGKey(0), ref_cfg))
    params = params_from_jax(PC.reduced(PC.get_config(arch)), tree,
                             device="cpu")
    argv = ["--arch", arch] + SERVE_ARGS + ["--device", "cpu"]
    got = serve_main(argv, params=params)
    assert got.shape == (6, 2) and got.dtype == np.int32
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(serve_main(argv, params=params), got)


def test_serving_loop_own_init_is_deterministic():
    argv = ["--arch", "gemma3-1b"] + SERVE_ARGS + ["--device", "cpu"]
    a, b = serve_main(argv), serve_main(argv)
    assert a.shape == (6, 2) and np.array_equal(a, b)
