"""Prefill / decode step builders (the serving half of ``repro.train.step``).

``make_prefill_step``: forward only, returns the last position's logits.
``make_serve_step``: one greedy decode step against a KV cache.
Both run without autograd and hand their inputs to the model unchanged:
``tokens`` (or ``embeddings`` / ``positions``) and ``token`` for the
decoder-only families, ``frames`` / ``dec_tokens`` and ``token`` for the
encoder-decoder (whose decode cache holds the encoder memory, from
``models.encdec.encdec_prefill_memory``).  ``loss_fn`` and
``make_train_step`` come with the optimizer in the training slice
(ROADMAP.md, queue 1).
"""

from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import build

__all__ = ["make_prefill_step", "make_serve_step"]


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
