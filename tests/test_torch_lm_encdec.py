"""The port's encoder-decoder (whisper) against the reference (CPU).

Reduced whisper-medium (2 encoder + 2 decoder layers, d_model 64), the
reference's weights (``init_encdec`` on ``PRNGKey(0)``) carried into the
port by ``params_from_jax``, numpy-seeded frames and decoder tokens
(``tests/_torch_encdec.py``).  Here a memory of 24 frames (the dense
path: no call reaches ``_sdpa_blocked``); the blocked path, past
``_BLOCK_THRESHOLD`` = 2048, is ``tests/test_torch_lm_encdec_blocked.py``.

Tolerance: ``tests/_torch_lm.py::close`` (10^-4 of the logit scale) in
f32, greedy and serve-driver tokens equal.  In bf16 the decode (f32
cache, the serve loop's) is held at the same 10^-4 against the
reference's ``encdec_decode(..., unroll=True)`` (its scanned decode
cannot run bf16 against an f32 cache) from the same encoder memory.  The
bf16 encoder itself is held at twice the reference's own bf16-against-f32
gap: JAX rounds bf16 otherwise than torch (its logistic, inside ``silu``,
rounds ``1 / (1 + exp(-x))`` at each step, where torch's ``silu`` rounds
once), and through two layers of bf16 re-rounding most memory values end
one bf16 unit apart, so no bound tighter than bf16's own rounding holds
the two encoders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.launch.serve import main as ref_serve_main
from repro.models import encdec as RE
from repro.models import transformer as RT
from repro.models.model import count_params as ref_count_params
from repro.models.model import model_flops as ref_model_flops
import repro_torch.configs as PC
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import build, count_params, model_flops
from repro_torch.models import encdec as PE
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as PT
from repro_torch.train.step import make_prefill_step, make_serve_step

from _torch_encdec import (ARCH, B, FEED, S_DEC, Whisper, count_blocked,
                           hold_apply, hold_decode,
                           hold_decode_against_own_prefill, hold_encode,
                           hold_prefill_memory, np_tree, port_decode,
                           ref_decode)
from _torch_lm import SERVE_ARGS, close, configs, t

jax.config.update("jax_platforms", "cpu")

FRAMES = 24


@pytest.fixture(scope="module")
def whisper():
    return Whisper()


@pytest.fixture
def blocked_calls(monkeypatch):
    return count_blocked(monkeypatch)


# -- f32 against the reference, the dense path -------------------------------

def test_encode_equals_the_reference(whisper, blocked_calls):
    hold_encode(whisper, FRAMES)
    assert not blocked_calls


def test_apply_logits_equal_the_reference(whisper, blocked_calls):
    hold_apply(whisper, FRAMES)
    assert not blocked_calls


def test_prefill_memory_equals_the_reference(whisper, blocked_calls):
    hold_prefill_memory(whisper, FRAMES)
    assert not blocked_calls


def test_decode_equals_the_reference_decode(whisper, blocked_calls):
    hold_decode(whisper, FRAMES)
    assert not blocked_calls


def test_decode_equals_the_ports_prefill(whisper, blocked_calls):
    hold_decode_against_own_prefill(whisper, FRAMES)
    assert not blocked_calls


def test_prefill_and_serve_steps_pass_the_inputs_through(whisper):
    frames, tokens = whisper.inputs(FRAMES)
    _, prefill = make_prefill_step(whisper.cfg, device="cpu")
    last = prefill(whisper.params, {"frames": t(frames),
                                    "dec_tokens": t(tokens),
                                    "labels": t(tokens)})
    want, _ = whisper.apply(whisper.tree, frames, tokens)
    close(last.numpy(), np.asarray(want)[:, -1])
    model, step = make_serve_step(whisper.cfg, device="cpu")
    _, cache = whisper.port_cache(frames, 4)
    nxt, cache = step(whisper.params, cache, {"token": t(tokens[:, :1])})
    ref_logits, _ = whisper.step(whisper.tree,
                                 whisper.ref_cache(frames, 4),
                                 tokens[:, :1])
    assert nxt.dtype == torch.int32 and nxt.shape == (B,)
    assert np.array_equal(nxt.numpy(), np.argmax(ref_logits[:, -1], -1))
    assert [kv.length for kv in cache.self_kv] == [1] * whisper.cfg.n_layers


# -- the parameters, the cache and the counts --------------------------------

def test_params_from_jax_loads_every_leaf_by_name(whisper):
    p = whisper.params
    assert isinstance(p, PE.EncDec) and p.cfg == whisper.cfg
    tree = whisper.tree
    for i in range(whisper.cfg.n_layers):
        blk = p.dec_blocks[i]
        np.testing.assert_array_equal(
            blk.cross.wk.kernel.detach().numpy(),
            tree["dec_blocks"]["cross"]["wk"]["kernel"][i])
        np.testing.assert_array_equal(
            blk.self_attn.wo.kernel.detach().numpy(),
            tree["dec_blocks"]["self_attn"]["wo"]["kernel"][i])
    np.testing.assert_array_equal(
        p.enc_blocks[1].mlp.wi_up.kernel.detach().numpy(),
        tree["enc_blocks"]["mlp"]["wi_up"]["kernel"][1])
    assert sum(x.numel() for x in p.parameters()) == count_params(
        whisper.cfg) == ref_count_params(whisper.ref_cfg)


def _with_extra_leaf(tree):
    tree = dict(tree)
    tree["enc_norm"] = dict(tree["enc_norm"], bias=np.zeros(64, np.float32))
    return tree


@pytest.mark.parametrize("case", ["decoder_tree", "encdec_tree_for_decoder",
                                  "extra_leaf", "deeper_config",
                                  "shallower_config"])
def test_params_from_jax_rejects_another_layout(whisper, case):
    if case == "decoder_tree":
        ref_cfg, _ = configs("granite-20b")
        cfg, tree = whisper.cfg, np_tree(
            RT.init_decoder(jax.random.PRNGKey(0), ref_cfg))
    elif case == "encdec_tree_for_decoder":
        cfg, tree = configs("granite-20b")[1], whisper.tree
    elif case == "extra_leaf":
        cfg, tree = whisper.cfg, _with_extra_leaf(whisper.tree)
    else:
        n = 3 if case == "deeper_config" else 1
        cfg = dataclasses.replace(whisper.cfg, n_layers=n)
        tree = whisper.tree
    with pytest.raises(ValueError, match="layout"):
        params_from_jax(cfg, tree, device="cpu")


def test_each_module_refuses_the_other_family(whisper):
    with pytest.raises(ValueError, match="EncDec"):
        PT.Decoder(whisper.cfg)
    with pytest.raises(ValueError, match="EncDec"):
        PT.init_decoder_cache(B, 8, whisper.cfg, torch.float32, "cpu")
    with pytest.raises(ValueError, match="Decoder"):
        PE.EncDec(configs("granite-20b")[1])


def test_init_cache_shapes_and_mem_len(whisper):
    cfg = whisper.cfg
    model = build(cfg, device="cpu")
    hd, kv, L = cfg.head_dim_, cfg.n_kv_heads, cfg.n_layers
    c = model.init_cache(3, 10, dtype=torch.float32)
    assert c.mem_k.shape == c.mem_v.shape == (L, 3, 10, kv, hd)
    c = model.init_cache(3, 10, dtype=torch.bfloat16, mem_len=7)
    assert c.mem_k.shape == (L, 3, 7, kv, hd)
    assert c.mem_k.dtype == c.mem_v.dtype == torch.bfloat16
    assert len(c.self_kv) == L
    for layer in c.self_kv:
        assert layer.k.shape == (3, 10, kv, hd) and layer.length == 0
        assert layer.k.dtype == torch.bfloat16
    ref = RE.init_encdec_cache(3, 10, whisper.ref_cfg, jnp.bfloat16,
                               mem_len=7)
    assert tuple(ref.mem_k.shape) == tuple(c.mem_k.shape)
    assert tuple(ref.self_kv.k.shape[1:]) == tuple(c.self_kv[0].k.shape)


def test_own_init_is_seeded_and_shaped(whisper):
    model = build(whisper.cfg, device="cpu")
    a, b = model.init(0), model.init(0)
    for (name, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), name
    assert not torch.equal(a.embed.table, model.init(1).embed.table)
    assert not a.enc_norm.scale.detach().any()
    assert a.dec_blocks[0].cross.wq.bias is None
    assert [n for n, _ in a.named_parameters()] == \
        [n for n, _ in whisper.params.named_parameters()]


def test_cross_projections_have_no_bias_with_qkv_bias():
    ref_cfg, cfg = configs(ARCH, qkv_bias=True)
    tree = np_tree(RE.init_encdec(jax.random.PRNGKey(0), ref_cfg))
    assert "bias" not in tree["dec_blocks"]["cross"]["wq"]
    p = params_from_jax(cfg, tree, device="cpu")
    assert p.dec_blocks[0].self_attn.wq.bias is not None
    assert p.dec_blocks[0].cross.wq.bias is None
    frames = np.random.default_rng(3).standard_normal(
        (B, 8, cfg.d_model)).astype(np.float32)
    tokens = np.arange(2 * 5, dtype=np.int32).reshape(B, 5)
    want = RE.encdec_apply(tree, ref_cfg, frames, tokens)[0]
    with torch.no_grad():
        got = PE.encdec_apply(p, cfg, t(frames), t(tokens))[0]
    close(got.numpy(), want)


def test_whisper_medium_counts_its_published_size():
    cfg = PC.get_config(ARCH)
    assert count_params(cfg) == ref_count_params(RC.get_config(ARCH)) \
        == 959_309_824
    assert PE.dec_len_for(4096) == RE.dec_len_for(4096) == 1024
    assert PE.dec_len_for(3) == RE.dec_len_for(3) == 1


@pytest.mark.parametrize("shape", list(RC.SHAPES))
def test_model_flops_equal_the_reference(shape):
    """Train and prefill count the decoder's tokens (seq / 4)."""
    got = model_flops(PC.get_config(ARCH), PC.SHAPES[shape])
    assert got == ref_model_flops(RC.get_config(ARCH), RC.SHAPES[shape])


# -- the serving loop --------------------------------------------------------

def test_serving_loop_tokens_equal_the_reference():
    """The reference's loop (frames the first draw of ``default_rng(0)``,
    a memory of ``--prompt-len`` frames, token 0 first) against the port's
    handed the same weights, twice."""
    want = np.asarray(ref_serve_main(["--arch", ARCH] + SERVE_ARGS))
    ref_cfg, cfg = configs(ARCH)
    tree = np_tree(RE.init_encdec(jax.random.PRNGKey(0), ref_cfg))
    params = params_from_jax(cfg, tree, device="cpu")
    argv = ["--arch", ARCH] + SERVE_ARGS + ["--device", "cpu"]
    got = serve_main(argv, params=params)
    assert got.shape == (6, 2) and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(serve_main(argv, params=params), got)


def test_serving_loop_own_init_is_deterministic():
    argv = ["--arch", ARCH] + SERVE_ARGS + ["--device", "cpu"]
    a, b = serve_main(argv), serve_main(argv)
    assert a.shape == (6, 2) and np.array_equal(a, b)
    assert ((a >= 0) & (a < PC.reduced(PC.get_config(ARCH)).vocab_size)).all()


# -- bf16 --------------------------------------------------------------------

@pytest.fixture(scope="module")
def whisper16():
    return Whisper("bfloat16")


def test_bf16_decode_equals_the_unrolled_reference(whisper16):
    """The bf16 config with the serve loop's f32 cache: both decodes start
    from the reference's memory, the reference's unrolled (its scan
    refuses the bf16 carry turning f32 at the first attention layer)."""
    w = whisper16
    frames, tokens = w.inputs(FRAMES)
    ref_cache = w.ref_cache(frames, S_DEC)
    want = ref_decode(w, ref_cache, tokens, FEED, w.step_unrolled)
    model = build(w.cfg, device="cpu")
    cache = model.init_cache(B, S_DEC, dtype=torch.float32,
                             mem_len=frames.shape[1])._replace(
        mem_k=t(ref_cache.mem_k), mem_v=t(ref_cache.mem_v))
    got = port_decode(w, model, cache, tokens, FEED)
    for i in range(S_DEC):
        close(got[:, i], want[:, i])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_bf16_encoder_within_the_references_own_bf16_gap(whisper, whisper16):
    """The bf16 prefill memory, and the decode from each package's own
    memory (every token fed), within twice the reference's own
    bf16-against-f32 gap of the reference's bf16: two bf16 roundings of
    one f32 model, each that far from it."""
    w, w32 = whisper16, whisper
    frames, tokens = w.inputs(FRAMES)
    ref16, ref32 = w.ref_cache(frames, S_DEC), w32.ref_cache(frames, S_DEC)
    model, got = w.port_cache(frames, S_DEC)
    for g, a, b in ((got.mem_k, ref16.mem_k, ref32.mem_k),
                    (got.mem_v, ref16.mem_v, ref32.mem_v)):
        gap = float(np.abs(np.asarray(a) - np.asarray(b)).max())
        assert float((g - t(a)).abs().max()) <= 2 * gap
    want = ref_decode(w, ref16, tokens, S_DEC, w.step_unrolled)
    want32 = ref_decode(w32, ref32, tokens, S_DEC, w32.step)
    port = port_decode(w, model, got, tokens, S_DEC)
    gap = float(np.abs(want - want32).max())
    assert float(np.abs(port - want).max()) <= 2 * gap
