"""Model facade: ``build(cfg) -> Model(init/apply/decode_step/init_cache)``.

The port of ``repro.models.model`` for every family: the decoder-only
ones (dense, local/global, MoE, Mamba2-hybrid, xLSTM), whose parameters
are a :class:`~.transformer.Decoder` module, and the encoder-decoder
(whisper), whose parameters are an :class:`~.encdec.EncDec`; either is
passed to ``apply`` / ``decode_step`` as the reference passes its
pytree, and trained through autograd over its parameters
(``train.step.make_train_step``).  The dry-run's input specs come with
the distributed slice (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from . import encdec as _encdec
from . import transformer as _tf

__all__ = ["Model", "build", "count_params", "model_flops"]


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]           # (seed or generator) -> params
    apply: Callable[..., Any]          # (params, **batch) -> (logits, aux)
    decode_step: Callable[..., Any]    # (params, cache, **inputs) -> (logits, cache)
    init_cache: Callable[..., Any]     # (batch, max_len, dtype) -> cache


def build(cfg: ModelConfig, device="cuda") -> Model:
    """The model of ``cfg`` on ``device`` (default ``"cuda"``; raises when
    no CUDA device is present, pass ``device="cpu"`` for the CPU)."""
    device = resolve_device(device)
    if cfg.encoder_decoder:
        def init_fn(gen=0):
            return _encdec.init_encdec(gen, cfg, device)

        def apply_fn(params, frames=None, dec_tokens=None, remat=True,
                     unroll=False, **_):
            return _encdec.encdec_apply(params, cfg, frames, dec_tokens,
                                        remat=remat, unroll=unroll)

        def decode_fn(params, cache, token=None, unroll=False, **_):
            return _encdec.encdec_decode(params, cfg, cache, token,
                                         unroll=unroll)

        def cache_fn(batch, max_len, dtype=torch.bfloat16, mem_len=None):
            return _encdec.init_encdec_cache(batch, max_len, cfg, dtype,
                                             mem_len, device)

        return Model(cfg, init_fn, apply_fn, decode_fn, cache_fn)

    def init_fn(gen=0):
        return _tf.init_decoder(gen, cfg, device)

    def apply_fn(params, tokens=None, embeddings=None, positions=None,
                 remat=True, unroll=False, **_):
        return _tf.decoder_apply(params, cfg, tokens=tokens,
                                 embeddings=embeddings, positions=positions,
                                 remat=remat, unroll=unroll)

    def decode_fn(params, cache, token=None, embedding=None, unroll=False,
                  **_):
        return _tf.decoder_decode(params, cfg, cache, token=token,
                                  embedding=embedding, unroll=unroll)

    def cache_fn(batch, max_len, dtype=torch.bfloat16, **_):
        return _tf.init_decoder_cache(batch, max_len, cfg, dtype, device)

    return Model(cfg, init_fn, apply_fn, decode_fn, cache_fn)


# ---------------------------------------------------------------------------
# parameter / FLOP accounting (for rooflines)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the parameter shapes of the model built on the
    ``meta`` device (no allocation).  ``active_only`` counts the reference's
    way: a parameter under ``moe`` with an expert axis (``shape[-3] ==
    n_experts``) counts ``k / E`` of its size."""
    module = _encdec.EncDec if cfg.encoder_decoder else _tf.Decoder
    total = expert = 0
    for name, p in module(cfg, device="meta").named_parameters():
        total += p.numel()
        if ("moe" in name.split(".") and p.dim() >= 3
                and p.shape[-3] == cfg.n_experts):
            expert += p.numel()
    if active_only and cfg.n_experts:
        total -= expert
        total += int(expert * cfg.experts_per_token / cfg.n_experts)
    return total


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N the active
    parameters for MoE."""
    n = count_params(cfg, active_only=bool(cfg.n_experts))
    if shape.kind == "decode":
        tokens = shape.global_batch  # one new token per sequence
    else:
        tokens = shape.global_batch * shape.seq_len
        if cfg.encoder_decoder:
            # decoder tokens carry the 6ND; encoder counted via its params
            tokens = shape.global_batch * _encdec.dec_len_for(shape.seq_len)
    if shape.kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens  # inference: forward only
