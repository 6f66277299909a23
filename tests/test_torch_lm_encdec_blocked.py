"""The port's encoder-decoder (whisper) on its blocked path (CPU).

The checks of ``tests/test_torch_lm_encdec.py`` over a memory of 2100
frames, past ``_BLOCK_THRESHOLD`` = 2048: the encoder's self-attention
and the prefill's cross-attention (S > 1) take ``_sdpa_blocked`` (each
call counted), a one-token decode's cross-attention stays dense.  Reduced
whisper-medium in f32, the reference's weights; tolerance
``tests/_torch_lm.py::close`` (10^-4 of the logit scale), greedy tokens
equal.
"""

import jax
import pytest

from _torch_encdec import (Whisper, count_blocked, hold_apply, hold_decode,
                           hold_decode_against_own_prefill, hold_encode,
                           hold_prefill_memory)

jax.config.update("jax_platforms", "cpu")

FRAMES = 2100


@pytest.fixture(scope="module")
def whisper():
    return Whisper()


@pytest.fixture
def blocked_calls(monkeypatch):
    return count_blocked(monkeypatch)


def _layers(w):
    return w.cfg.n_encoder_layers, w.cfg.n_layers


def test_encode_equals_the_reference(whisper, blocked_calls):
    hold_encode(whisper, FRAMES)
    assert blocked_calls == [FRAMES] * _layers(whisper)[0]


def test_apply_logits_equal_the_reference(whisper, blocked_calls):
    """Each encoder layer's self-attention and each decoder layer's
    cross-attention (its 12 queries against the 2100 frames) block."""
    hold_apply(whisper, FRAMES)
    enc, dec = _layers(whisper)
    assert blocked_calls == [FRAMES] * enc + [12] * dec


def test_prefill_memory_equals_the_reference(whisper, blocked_calls):
    hold_prefill_memory(whisper, FRAMES)
    assert blocked_calls == [FRAMES] * _layers(whisper)[0]


def test_decode_equals_the_reference_decode(whisper, blocked_calls):
    """The prefill's encoder blocks; none of the decode's steps does."""
    hold_decode(whisper, FRAMES)
    assert blocked_calls == [FRAMES] * _layers(whisper)[0]


def test_decode_equals_the_ports_prefill(whisper, blocked_calls):
    hold_decode_against_own_prefill(whisper, FRAMES)
    enc, dec = _layers(whisper)
    assert blocked_calls == [FRAMES] * (2 * enc) + [12] * dec
