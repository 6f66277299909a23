"""The port's LM layers and configs against the reference (CPU, f32).

Inputs come from numpy seeds; the reference's weights from its own
initialisers.  Tolerances: rtol = atol = 1e-5 for norms, MLP, RoPE /
M-RoPE and attention (f32 products summed in another order); ``embed``
and the masks exactly; parameter counts (total and active) exactly for
the ten configs.  Also the device rule (the entry points default to
CUDA and raise without a card).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models.model import count_params as ref_count_params
import repro_torch.configs as PC
from repro_torch.models import attention as PA
from repro_torch.models import build, count_params, model_flops
from repro_torch.models import layers as PL

jax.config.update("jax_platforms", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
F32 = np.float32
DENSE = ["gemma3-1b", "granite-20b", "minitron-4b", "qwen2-72b",
         "qwen2-vl-7b"]
DECODER_ONLY = DENSE + ["zamba2-2.7b", "xlstm-1.3b", "llama4-scout-17b-a16e",
                        "olmoe-1b-7b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- configs ---------------------------------------------------------------

@pytest.mark.parametrize("arch", RC.ARCH_IDS)
def test_config_equals_the_reference(arch):
    ref, port = RC.get_config(arch), PC.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PC.reduced(port)) == \
        dataclasses.asdict(RC.reduced(ref))
    assert port.head_dim_ == ref.head_dim_
    assert port.padded_vocab == ref.padded_vocab
    for shape in RC.SHAPES:
        assert PC.shape_applicable(arch, shape) == \
            RC.shape_applicable(arch, shape)


def test_registry_and_shapes_equal_the_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert PC.LONG_CONTEXT_ARCHS == RC.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    with pytest.raises(ValueError, match="unknown arch"):
        PC.get_config("gpt-5")


@pytest.mark.parametrize("arch", DECODER_ONLY + ["whisper-medium"])
def test_count_params_equals_the_reference(arch):
    """Both count without allocating: the reference by ``eval_shape``, the
    port on the meta device; the active count (the experts' k/E share for
    MoE) too."""
    cfg, ref = PC.get_config(arch), RC.get_config(arch)
    assert count_params(cfg) == ref_count_params(ref)
    assert cfg.param_count() == count_params(cfg)
    assert cfg.active_param_count() == ref_count_params(ref,
                                                        active_only=True)


def test_gemma3_1b_has_its_published_size_and_flops():
    cfg = PC.get_config("gemma3-1b")
    assert count_params(cfg) == 999_812_736
    decode = PC.SHAPES["decode_32k"]
    assert model_flops(cfg, decode) == 2.0 * 999_812_736 * decode.global_batch
    train = PC.SHAPES["train_4k"]
    assert model_flops(cfg, train) == \
        6.0 * 999_812_736 * train.global_batch * train.seq_len


# -- layers ----------------------------------------------------------------

@pytest.mark.parametrize("shape,eps", [((2, 80, 64), 1e-5),
                                       ((3, 1, 1152), 1e-6)])
def test_rms_norm(shape, eps):
    r = np.random.default_rng(0)
    x = (3 * r.standard_normal(shape)).astype(F32)
    scale = (0.1 * r.standard_normal(shape[-1])).astype(F32)
    want = RL.rms_norm({"scale": scale}, x, eps)
    got = PL.rms_norm(_t(x), _t(scale), eps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 80, 64), (4, 7, 96)])
def test_layer_norm(shape):
    r = np.random.default_rng(1)
    x = (2 * r.standard_normal(shape) + 0.5).astype(F32)
    scale = r.standard_normal(shape[-1]).astype(F32)
    bias = r.standard_normal(shape[-1]).astype(F32)
    want = RL.layer_norm({"scale": scale, "bias": bias}, x)
    got = PL.layer_norm(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("d_model,d_ff", [(64, 128), (48, 200)])
def test_mlp(d_model, d_ff):
    p = _np_tree(RL.init_mlp(jax.random.PRNGKey(3), d_model, d_ff))
    x = np.random.default_rng(2).standard_normal((2, 80, d_model)).astype(F32)
    want = RL.mlp(p, x)
    got = PL.mlp(_t(x), _t(p["wi_gate"]["kernel"]), _t(p["wi_up"]["kernel"]),
                 _t(p["wo"]["kernel"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mod = PL.MLP(d_model, d_ff)
    with torch.no_grad():
        for name in ("wi_gate", "wi_up", "wo"):
            getattr(mod, name).kernel.copy_(_t(p[name]["kernel"]))
        np.testing.assert_allclose(mod(_t(x)).numpy(), np.asarray(want), **TOL)


def test_embed_is_exact():
    r = np.random.default_rng(4)
    table = r.standard_normal((256, 64)).astype(F32)
    tokens = r.integers(0, 256, (2, 80)).astype(np.int32)
    want = np.asarray(RL.embed({"table": table}, tokens))
    for dtype in (torch.int32, torch.int64):
        got = PL.embed(_t(table), _t(tokens).to(dtype))
        assert np.array_equal(got.numpy(), want)
    x = r.standard_normal((2, 5, 64)).astype(F32)
    np.testing.assert_allclose(
        PL.unembed(_t(table), _t(x)).numpy(),
        np.asarray(RL.unembed({"table": table}, x)), **TOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 80, 4, 16)).astype(F32)
    pos = np.stack([np.arange(80), np.arange(80) + 500]).astype(np.int32)
    want = RL.rope(x, pos, theta)
    got = PL.rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mrope_three_position_streams():
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 80, 4, 16)).astype(F32)
    pos3 = r.integers(0, 600, (3, 2, 80)).astype(np.int32)
    want = RL.mrope(x, pos3, 1e6, (4, 2, 2))
    got = PL.mrope(_t(x), _t(pos3), 1e6, (4, 2, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="cover head_dim/2"):
        PL.mrope(_t(x), _t(pos3), 1e6, (4, 2, 1))


# -- attention -------------------------------------------------------------

def _cfg(kv):
    return dataclasses.replace(PC.reduced(PC.get_config("gemma3-1b")),
                               n_kv_heads=kv)


def _qkv(kv, S=80, T=80, seed=7):
    r = np.random.default_rng(seed)
    q = r.standard_normal((2, S, 4, 16)).astype(F32)
    k = r.standard_normal((2, T, kv, 16)).astype(F32)
    v = r.standard_normal((2, T, kv, 16)).astype(F32)
    return q, k, v


@pytest.mark.parametrize("kv", [1, 2, 4])
@pytest.mark.parametrize("window", [0, 24])
def test_sdpa_causal_and_windowed(kv, window):
    q, k, v = _qkv(kv)
    ref_mask = RA._causal_mask(80, 80, window)
    mask = PA._causal_mask(80, 80, window)
    assert np.array_equal(mask.numpy(), np.asarray(ref_mask))
    want = RA._sdpa(q, k, v, ref_mask, _cfg(kv))
    got = PA._sdpa(_t(q), _t(k), _t(v), mask, _cfg(kv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sdpa_fully_masked_row_is_uniform_as_in_the_reference():
    q, k, v = _qkv(1, S=3, T=8)
    mask = np.zeros((1, 1, 1, 3, 8), bool)
    mask[..., 0, :2] = True
    want = RA._sdpa(q, k, v, mask, _cfg(1))
    got = PA._sdpa(_t(q), _t(k), _t(v), _t(mask), _cfg(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _small_blocks(monkeypatch):
    for mod in (RA, PA):
        monkeypatch.setattr(mod, "_BLOCK_Q", 16)
        monkeypatch.setattr(mod, "_BLOCK_KV", 24)
        monkeypatch.setattr(mod, "_BLOCK_THRESHOLD", 32)


@pytest.mark.parametrize("window", [0, 20])
def test_blocked_attention(monkeypatch, window):
    """80 tokens past a threshold of 32 take the online-softmax path in
    both packages (blocks of 16 queries and 24 keys: padded at the end)."""
    cfg = _cfg(2)
    ref_cfg = dataclasses.replace(RC.reduced(RC.get_config("gemma3-1b")),
                                  n_kv_heads=2)
    p = _np_tree(RA.init_attention(jax.random.PRNGKey(8), ref_cfg))
    mod = PA.Attention(cfg)
    with torch.no_grad():
        for name in ("wq", "wk", "wv", "wo"):
            getattr(mod, name).kernel.copy_(_t(p[name]["kernel"]))
    x = np.random.default_rng(9).standard_normal((2, 80, 64)).astype(F32)
    pos = np.broadcast_to(np.arange(80, dtype=np.int32), (2, 80))
    unblocked = PA.attention(mod, _t(x), _t(pos), cfg, window=window)
    _small_blocks(monkeypatch)
    want = RA.attention(p, x, pos, ref_cfg, window=window)
    got = PA.attention(mod, _t(x), _t(pos), cfg, window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.detach().numpy(),
                               unblocked.detach().numpy(), **TOL)


# -- the device rule -------------------------------------------------------

def test_lm_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present here")
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import params_from_jax
    from repro_torch.models.transformer import (init_decoder,
                                                init_decoder_cache)
    from repro_torch.retrieval import RetrievalIndex
    from repro_torch.serve import init_cache, make_serve_step

    cfg = PC.reduced(PC.get_config("gemma3-1b"))
    x = np.zeros((8, 4), F32)
    for call in (lambda: build(cfg),
                 lambda: make_serve_step(cfg),
                 lambda: init_decoder(0, cfg),
                 lambda: init_decoder_cache(2, 8, cfg),
                 lambda: init_cache(2, 8, cfg),
                 lambda: params_from_jax(cfg, {}),
                 lambda: RetrievalIndex(nlist=2).build(x),
                 lambda: serve_main(["--arch", "gemma3-1b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
