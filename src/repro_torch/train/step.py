"""Train / prefill / decode step builders — the port of
``repro.train.step``.

``make_train_step``: CE loss (pad-masked, MoE-aux added), gradients by
``torch.autograd`` over the module's parameters, AdamW (``.optim``).
Gradient compression (int8, the reference's quantize-dequantize, one
scale a leaf of the reference's tree) is applied when ``compress_grads``
— see ``repro_torch.distributed.compression``.
``make_prefill_step``: forward only, returns the last position's logits.
``make_serve_step``: one greedy decode step against a KV cache.
The serving steps run without autograd.  Every step hands its inputs to
the model unchanged: ``tokens`` (or ``embeddings`` / ``positions``) and
``token`` for the decoder-only families, ``frames`` / ``dec_tokens`` and
``token`` for the encoder-decoder (whose decode cache holds the encoder
memory, from ``models.encdec.encdec_prefill_memory``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed.compression import compress_tree_int8
from ..models import build
from ..models.convert import tree_path
from .optim import AdamWConfig, OptState, apply_updates

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "loss_fn"]

_AUX_WEIGHT = 0.01


def _leaf_of(name: str):
    """The reference tree's leaf of a parameter (its keys, without the
    index on the stacked axes): the unit the int8 compression scales."""
    return tree_path(name)[0]


def loss_fn(model, params, batch: Dict[str, Any], cfg: ModelConfig,
            unroll: bool = False):
    """``(ce + _AUX_WEIGHT * aux, ce)``: the mean next-token cross-entropy
    in f32 over the labels inside ``[0, vocab_size)`` (the others are
    padding and count nothing), plus the MoE blocks' Switch loss."""
    labels = batch["labels"]
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    # remat is accepted as the reference's and changes no result: the port
    # keeps every activation (gemma3-1b at B * S = 2048 fits on 80 GB
    # without recomputation)
    logits, aux = model.apply(params, **inputs, remat=True, unroll=unroll)
    logp = F.log_softmax(logits.float(), dim=-1)
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    picked = labels.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, picked[..., None])[..., 0]
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    ce = nll.sum() / torch.clamp(mask.sum(), min=1)
    return ce + _AUX_WEIGHT * aux, ce


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    compress_grads: bool = False, unroll: bool = False,
                    device="cuda"):
    """Build ``(model, train_step)``.  ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` updates ``params`` (the
    module) and the moments in place; ``batch`` holds tensors or numpy
    arrays (moved to ``device``); ``metrics`` holds ``loss``, ``ce``,
    ``grad_norm`` and ``lr`` as f32 scalar tensors on the device (reading
    one synchronises)."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state: OptState, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        named = list(params.named_parameters())
        with torch.enable_grad():
            loss, ce = loss_fn(model, params, batch, cfg, unroll=unroll)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(named, grads)}
        if compress_grads:
            grads = compress_tree_int8(grads, _leaf_of)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics = {"loss": loss.detach(), "ce": ce.detach(), **metrics}
        return params, opt_state, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig, unroll: bool = False,
                      device="cuda"):
    """Build ``(model, prefill_step)``: a full forward pass over a prompt
    batch that returns only the last position's logits — the serving
    prefill phase."""
    model = build(cfg, device=device)

    @torch.no_grad()
    def prefill_step(params, batch):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        logits, _ = model.apply(params, **inputs, remat=False, unroll=unroll)
        return logits[:, -1, :]

    return model, prefill_step


def make_serve_step(cfg: ModelConfig, unroll: bool = False, device="cuda"):
    """Build ``(model, serve_step)``: one greedy decode step — append the
    incoming token to the KV cache, return ``(next_token, cache)``.  The
    next token is the first maximum of the logits (int32)."""
    model = build(cfg, device=device)

    @torch.no_grad()
    def serve_step(params, cache, inputs):
        logits, cache = model.decode_step(params, cache, **inputs,
                                          unroll=unroll)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)
        return next_token.to(torch.int32), cache

    return model, serve_step
