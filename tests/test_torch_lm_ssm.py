"""The port's Mamba2 (SSD) layers and the zamba2 hybrid against the
reference (CPU, f32).

``ssd_chunked`` at several ``(l, chunk)``, with and without a carried
``init_state``, and its refusal of a sequence that is not a multiple of
the chunk; ``mamba_apply``; ``mamba_decode`` step by step (output, SSM
state and conv window); the hybrid super-block with a non-zero LoRA
(``lora_b`` is zero at the reference's init, which would leave the
adapter unchecked), prefill and decode; the reduced zamba2's logits, its
decode against the reference's, its own decode against its prefill over
512 tokens (two SSD chunks), the serving loop's tokens and
``count_params``.

Tolerance: ``atol = 1e-4 * max(1, max|want|)``, ``rtol = 1e-4`` (f32
products summed in another order: the reference's multi-operand einsums
are contracted pairwise here); tokens and counts exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro.models.model import count_params as ref_count_params
import repro_torch.configs as PC
from repro_torch.models import count_params
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.models.convert import _load

from _torch_lm import Case, close, configs, hold_decode, hold_serve, \
    port_decode, t

jax.config.update("jax_platforms", "cpu")

F32 = np.float32


def _ssd_inputs(b, l, h, p, n, seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, l, h, p)).astype(F32)
    a = -np.abs(0.3 * r.standard_normal((b, l, h))).astype(F32)
    B = r.standard_normal((b, l, n)).astype(F32)
    C = r.standard_normal((b, l, n)).astype(F32)
    s0 = r.standard_normal((b, h, p, n)).astype(F32)
    return x, a, B, C, s0


@pytest.mark.parametrize("l,chunk", [(64, 64), (64, 16), (96, 32), (40, 256),
                                     (512, 256)])
@pytest.mark.parametrize("carry", [False, True])
def test_ssd_chunked(l, chunk, carry):
    x, a, B, C, s0 = _ssd_inputs(2, l, 3, 8, 5, seed=l + chunk)
    init = s0 if carry else None
    want_y, want_s = RS.ssd_chunked(x, a, B, C, init_state=init, chunk=chunk)
    got_y, got_s = PS.ssd_chunked(t(x), t(a), t(B), t(C),
                                  init_state=None if init is None else t(init),
                                  chunk=chunk)
    assert got_y.shape == (2, l, 3, 8) and got_s.shape == (2, 3, 8, 5)
    close(got_y.numpy(), want_y)
    close(got_s.numpy(), want_s)


def test_ssd_chunked_refuses_a_sequence_off_the_chunk():
    x, a, B, C, _ = _ssd_inputs(1, 48, 2, 4, 3, seed=0)
    with pytest.raises(AssertionError, match="divide the SSD chunk"):
        RS.ssd_chunked(x, a, B, C, chunk=32)
    with pytest.raises(ValueError, match="divide the SSD chunk"):
        PS.ssd_chunked(t(x), t(a), t(B), t(C), chunk=32)


class Mixer:
    """One reduced zamba2 Mamba2 mixer in both packages, with ``A_log``,
    ``D`` and ``dt_bias`` drawn away from their init values."""

    def __init__(self):
        self.ref_cfg, self.cfg = configs("zamba2-2.7b")
        tree = jax.tree.map(np.asarray, RS.init_mamba(jax.random.PRNGKey(4),
                                                      self.ref_cfg))
        r = np.random.default_rng(8)
        H = self.cfg.n_ssm_heads
        tree["A_log"] = (0.5 * r.standard_normal(H)).astype(F32)
        tree["D"] = (1 + 0.3 * r.standard_normal(H)).astype(F32)
        tree["dt_bias"] = (-1 + 0.5 * r.standard_normal(H)).astype(F32)
        self.tree = tree
        self.mod = PS.Mamba(self.cfg)
        with torch.no_grad():
            assert _load(self.mod, tree) == sum(
                v.size for v in jax.tree.leaves(tree))
        self.u = r.standard_normal((2, 48, self.cfg.d_model)).astype(F32)


@pytest.fixture(scope="module")
def mixer():
    return Mixer()


def test_mamba_apply(mixer):
    want = RS.mamba_apply(mixer.tree, mixer.u, mixer.ref_cfg)
    with torch.no_grad():
        got = PS.mamba_apply(mixer.mod, t(mixer.u), mixer.cfg)
    close(got.numpy(), want)


def test_mamba_decode_step_by_step(mixer):
    ref_cache = RS.init_mamba_cache(2, mixer.ref_cfg)
    cache = PS.init_mamba_cache(2, mixer.cfg, device="cpu")
    assert cache.state.dtype == cache.conv.dtype == torch.float32
    step = jax.jit(lambda p, u, c: RS.mamba_decode(p, u, c, mixer.ref_cfg))
    for i in range(mixer.u.shape[1]):
        u = mixer.u[:, i:i + 1]
        want, ref_cache = step(mixer.tree, u, ref_cache)
        with torch.no_grad():
            got, cache = PS.mamba_decode(mixer.mod, t(u), cache, mixer.cfg)
        close(got.numpy(), want)
        close(cache.state.numpy(), ref_cache.state)
        close(cache.conv.numpy(), ref_cache.conv)


def test_mamba_decode_in_bf16_keeps_f32_state(mixer):
    cache = PS.init_mamba_cache(2, mixer.cfg, device="cpu")
    u = t(mixer.u[:, :1]).to(torch.bfloat16)
    with torch.no_grad():
        got, cache = PS.mamba_decode(mixer.mod, u, cache, mixer.cfg)
    assert got.dtype == torch.bfloat16
    assert cache.state.dtype == cache.conv.dtype == torch.float32


# -- the hybrid super-block and the model ----------------------------------------

def _lora_b(tree):
    seg = tree["segments"][0]
    seg["lora_b"] = (0.05 * np.random.default_rng(9).standard_normal(
        seg["lora_b"].shape)).astype(F32)


@pytest.fixture(scope="module")
def zamba():
    return Case("zamba2-2.7b", S=80, edit=_lora_b)


def test_the_shared_block_is_held_once(zamba):
    shared = [n for n, _ in zamba.params.named_parameters()
              if n.startswith("shared_attn.block.")]
    assert shared and not any("shared" in n for n, _ in
                              zamba.params.segments.named_parameters())
    assert PT.segments_for(zamba.cfg) == RT.segments_for(zamba.ref_cfg) == \
        [("mamba_hybrid", 2, 6)]


def test_hybrid_super_block_with_lora(zamba):
    """One super-block (6 Mamba2 blocks, then the shared block on the
    LoRA-adapted input), prefill and 4 decode steps, against the
    reference's with the same non-zero ``lora_b``; without the adapter
    the output moves."""
    c = zamba
    p_ref = jax.tree.map(lambda a: a[1], c.ref_params["segments"][0])
    sup = c.params.segments[0][1]
    x = np.random.default_rng(10).standard_normal((2, 32, 64)).astype(F32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want, _ = RT._apply_super("mamba_hybrid", p_ref, x, pos, c.ref_cfg,
                              c.ref_params["shared_attn"], 6)
    with torch.no_grad():
        got, aux = PT._apply_super("mamba_hybrid", sup, t(x), t(pos), c.cfg,
                                   c.params.shared)
        saved = sup.lora_b.clone()
        try:
            sup.lora_b.zero_()
            inert, _ = PT._apply_super("mamba_hybrid", sup, t(x), t(pos),
                                       c.cfg, c.params.shared)
        finally:
            sup.lora_b.copy_(saved)
    assert aux is None
    close(got.numpy(), want)
    assert float((got - inert).abs().max()) > 1e-3
    ref_cache = RT._init_super_cache("mamba_hybrid", 2, 4, c.ref_cfg, 6,
                                     jnp.float32)
    cache = PT._init_super_cache("mamba_hybrid", 2, 4, c.cfg, 6,
                                 torch.float32, torch.device("cpu"))
    for i in range(4):
        want, ref_cache = RT._decode_super(
            "mamba_hybrid", p_ref, x[:, i:i + 1], ref_cache, c.ref_cfg,
            c.ref_params["shared_attn"], 6)
        with torch.no_grad():
            got, cache = PT._decode_super("mamba_hybrid", sup,
                                          t(x[:, i:i + 1]), cache, c.cfg,
                                          c.params.shared)
        close(got.numpy(), want)


def test_zamba2_logits(zamba):
    got, aux = zamba.apply()
    assert got.shape == (2, 80, zamba.cfg.padded_vocab) and aux == 0.0
    close(got, zamba.ref_logits)


def test_zamba2_decode_equals_the_reference_decode(zamba):
    hold_decode(zamba, feed=40)


def test_zamba2_decode_equals_prefill_across_the_chunk():
    """512 tokens are two SSD chunks of 256 in the prefill; the decode's
    recurrence must agree with it at every position (the check the card
    repeats at full width)."""
    c = Case("zamba2-2.7b", B=1, S=512, edit=_lora_b)
    got = port_decode(c, feed=512)
    want, _ = c.apply()
    close(got, want)
    close(want, c.ref_logits)


def test_zamba2_serving_loop_tokens_equal_the_reference():
    hold_serve("zamba2-2.7b")


def test_zamba2_count_params_equals_the_reference():
    cfg = PC.get_config("zamba2-2.7b")
    assert count_params(cfg) == 2_346_365_088 == \
        ref_count_params(RC.get_config("zamba2-2.7b"))
    assert count_params(cfg, active_only=True) == count_params(cfg)
    reduced = PC.reduced(cfg)
    assert count_params(reduced) == \
        ref_count_params(RC.reduced(RC.get_config("zamba2-2.7b")))
