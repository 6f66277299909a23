"""Model facade: ``build(cfg) -> Model(init/apply/decode_step/init_cache)``.

The port of ``repro.models.model`` for every family: the decoder-only
ones (dense, local/global, MoE, Mamba2-hybrid, xLSTM), whose parameters
are a :class:`~.transformer.Decoder` module, and the encoder-decoder
(whisper), whose parameters are an :class:`~.encdec.EncDec`; either is
passed to ``apply`` / ``decode_step`` as the reference passes its
pytree, and trained through autograd over its parameters
(``train.step.make_train_step``).
``init_cache(..., mesh=)`` allocates this rank's slices of a decode
cache on a live mesh, at their local shapes only
(``distributed.sharding.ShardedCache.allocate``).  ``input_specs`` /
``decode_input_specs`` give a shape's inputs as tensors on the ``meta``
device (shapes and dtypes, no storage), the reference's
``ShapeDtypeStruct`` stand-ins, for the sharding rules
(``distributed.sharding.batch_shardings``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch
from torch import nn

from ..configs.base import ModelConfig, ShapeSpec
from ..device import resolve_device
from ..distributed.sharding import ShardedCache
from . import encdec as _encdec
from . import transformer as _tf

__all__ = ["Model", "build", "module_of", "count_params", "model_flops",
           "input_specs", "decode_input_specs"]


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]           # (seed or generator) -> params
    apply: Callable[..., Any]          # (params, **batch) -> (logits, aux)
    decode_step: Callable[..., Any]    # (params, cache, **inputs) -> (logits, cache)
    init_cache: Callable[..., Any]     # (batch, max_len, dtype[, mesh]) -> cache


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

        def cache_fn(batch, max_len, dtype=torch.bfloat16, mem_len=None,
                     mesh=None):
            if mesh is None:
                return _encdec.init_encdec_cache(batch, max_len, cfg, dtype,
                                                 mem_len, device)
            return ShardedCache.allocate(
                lambda whole: _encdec.init_encdec_cache(
                    *((batch, max_len) if whole else (1, 1)), cfg, dtype,
                    (mem_len or max_len) if whole else 1, "cpu"),
                mesh, batch, cfg.n_kv_heads, device)

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

    def cache_fn(batch, max_len, dtype=torch.bfloat16, mesh=None, **_):
        if mesh is None:
            return _tf.init_decoder_cache(batch, max_len, cfg, dtype, device)
        return ShardedCache.allocate(
            lambda whole: _tf.init_decoder_cache(
                *((batch, max_len) if whole else (1, 1)), cfg, dtype, "cpu"),
            mesh, batch, cfg.n_kv_heads, device)

    return Model(cfg, init_fn, apply_fn, decode_fn, cache_fn)


def module_of(cfg: ModelConfig, fill: Callable[[str], torch.Tensor]
              ) -> nn.Module:
    """The parameters' module of ``cfg`` (a ``Decoder`` or an ``EncDec``)
    built on the ``meta`` device, each parameter ``name`` then set to a
    ``Parameter`` of ``fill(name)`` (which shares its storage)."""
    module = (_encdec.EncDec if cfg.encoder_decoder else _tf.Decoder)(
        cfg, device="meta")
    for name, _ in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf, nn.Parameter(fill(name)))
    return module


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors: shapes and dtypes, no allocation)
# ---------------------------------------------------------------------------

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig,
                shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Inputs for train/prefill; decode uses ``decode_input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    act = getattr(torch, cfg.dtype)
    if cfg.encoder_decoder:
        Sd = _encdec.dec_len_for(S)
        return {
            "frames": _spec((B, S, cfg.d_model), act),
            "dec_tokens": _spec((B, Sd), torch.int32),
            "labels": _spec((B, Sd), torch.int32),
        }
    if cfg.frontend == "vision":
        return {
            "embeddings": _spec((B, S, cfg.d_model), act),
            "positions": _spec((3, B, S), torch.int32),
            "labels": _spec((B, S), torch.int32),
        }
    return {
        "tokens": _spec((B, S), torch.int32),
        "labels": _spec((B, S), torch.int32),
    }


def decode_input_specs(cfg: ModelConfig,
                       shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """The inputs of one decode step of ``shape``'s batch."""
    B = shape.global_batch
    if cfg.frontend == "vision" and not cfg.encoder_decoder:
        return {"embedding": _spec((B, 1, cfg.d_model),
                                   getattr(torch, cfg.dtype))}
    return {"token": _spec((B, 1), torch.int32)}


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
