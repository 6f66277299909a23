"""Train / prefill / decode step builders — the port of
``repro.train.step``.

``make_train_step``: CE loss (pad-masked, MoE-aux added), gradients by
``torch.autograd`` over the module's parameters, AdamW (``.optim``).
Gradient compression (int8, the reference's quantize-dequantize, one
scale a leaf of the reference's tree) is applied when ``compress_grads``
— see ``repro_torch.distributed.compression``.
On a mesh (``mesh=``) ``make_train_step`` builds the sharded step, which
computes the reference's ``train_step`` jitted under its
``param_shardings`` / ``batch_shardings``.  Each rank holds its shards of the parameters and of
``mu`` / ``nu`` (``distributed.sharding.Sharded``, placed by
``checkpoint.reshard``).  A step gathers every parameter whole into a
working module (one on each rank), splits the batch over the data axes
by ``batch_shardings`` (where the rules shard the sequence instead, the
batch is computed whole on every data rank), forms the loss from global
sums (the NLL sum and the label count ``psum``-ed over the data axes,
MoE layers routing over the whole batch: ``models.moe.split_tokens``),
``psum``-s the gradients over the data axes and no other, applies the
int8 compression to the reduced gradient where asked, and clips by the
global norm and updates each rank's own slices.  Not done: the ranks of
the "model" axis compute the same thing twice, the whole parameter set
is gathered on each rank for the step, no compute is split over the
model axis (the reference's GSPMD-partitioned matmuls and
``_constrain_heads_or_seq``), and in MoE layers each data rank runs the
expert matmuls over the whole batch's ``(E, C, d)`` buffer, of which it
fills only its own slots, so splitting the batch saves no expert
compute: ROADMAP.md, queue 1.
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
from ..distributed import compat
from ..distributed.compression import compress_tree_int8
from ..distributed.sharding import (Sharded, batch_shardings, dp_axes,
                                    local_slice)
from ..models import build
from ..models.convert import tree_path
from ..models.encdec import EncDec
from ..models.moe import TokenSplit, split_tokens
from ..models.transformer import Decoder
from .optim import AdamWConfig, OptState, apply_updates

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "loss_fn", "sharded_loss_and_grads"]

_AUX_WEIGHT = 0.01


def _leaf_of(name: str):
    """The reference tree's leaf of a parameter (its keys, without the
    index on the stacked axes): the unit the int8 compression scales."""
    return tree_path(name)[0]


def _loss_sums(model, params, batch: Dict[str, Any], cfg: ModelConfig,
               unroll: bool = False):
    """``(nll, mask, aux)``: the per-label f32 NLL (0 at padding), the
    mask of the labels that count and the MoE blocks' Switch loss."""
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
    return nll, mask, aux


def loss_fn(model, params, batch: Dict[str, Any], cfg: ModelConfig,
            unroll: bool = False):
    """``(ce + _AUX_WEIGHT * aux, ce)``: the mean next-token cross-entropy
    in f32 over the labels inside ``[0, vocab_size)`` (the others are
    padding and count nothing), plus the MoE blocks' Switch loss."""
    nll, mask, aux = _loss_sums(model, params, batch, cfg, unroll)
    ce = nll.sum() / torch.clamp(mask.sum(), min=1)
    return ce + _AUX_WEIGHT * aux, ce


def _grads(loss, named):
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, grads)}


def _gather_whole(params: Sharded, module: torch.nn.Module) -> None:
    """Write every parameter of ``module`` whole from this rank's shards
    ``params`` (a collective: every rank of the mesh calls it)."""
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(params.whole(n))


def sharded_loss_and_grads(model, module, batch: Dict[str, torch.Tensor],
                           cfg: ModelConfig, mesh, unroll: bool = False):
    """``(loss, ce, grads)`` of the global ``batch`` on a mesh: the
    reference's loss over the whole batch and its whole gradients (the
    same on every rank), from this rank's slice of the batch where
    ``batch_shardings`` splits it over the data axes, else from the whole
    batch (module docstring).  ``module`` holds the whole weights."""
    named = list(module.named_parameters())
    dp = dp_axes(mesh)
    specs = batch_shardings(batch, mesh)
    split = specs["labels"][:1] == (dp,)
    if not split:
        with torch.enable_grad():
            loss, ce = loss_fn(model, module, batch, cfg, unroll=unroll)
            grads = _grads(loss, named)
        return loss.detach(), ce.detach(), grads
    group = mesh.group(dp)
    local = {k: local_slice(v, specs[k], mesh) for k, v in batch.items()}
    labels = local["labels"]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    count = torch.clamp(compat.psum(mask.sum(), group), min=1)
    ts = TokenSplit(n=mesh.axis_size(dp), index=mesh.index(dp),
                    gather=lambda c: compat.all_gather(c[None], group))
    with torch.enable_grad(), split_tokens(ts):
        nll, _, aux = _loss_sums(model, module, local, cfg, unroll)
        nll_sum = nll.sum()
        grads = _grads(nll_sum / count + _AUX_WEIGHT * aux, named)
    for n in grads:     # one tensor at a time: one extra in memory
        grads[n] = compat.psum(grads[n], group)
    ce = compat.psum(nll_sum.detach(), group) / count
    loss = ce + _AUX_WEIGHT * compat.psum(aux.detach(), group)
    return loss, ce, grads


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    compress_grads: bool = False, unroll: bool = False,
                    device="cuda", mesh=None):
    """Build ``(model, train_step)``.  ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` updates ``params`` (the
    module) and the moments in place; ``batch`` holds tensors or numpy
    arrays (moved to ``device``); ``metrics`` holds ``loss``, ``ce``,
    ``grad_norm`` and ``lr`` as f32 scalar tensors on the device (reading
    one synchronises).  On a live ``mesh`` ``params`` is this rank's ``Sharded`` parameters and ``batch``
    the global batch, the same on every rank (module docstring)."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    opt_cfg = opt_cfg or AdamWConfig()
    work = []

    def train_step(params, opt_state: OptState, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if mesh is None:
            named = list(params.named_parameters())
            with torch.enable_grad():
                loss, ce = loss_fn(model, params, batch, cfg, unroll=unroll)
                grads = _grads(loss, named)
            loss, ce = loss.detach(), ce.detach()
        else:
            if not work:
                work.append((EncDec if cfg.encoder_decoder else Decoder)(
                    cfg, device=dev))
            _gather_whole(params, work[0])
            loss, ce, grads = sharded_loss_and_grads(model, work[0], batch,
                                                     cfg, mesh, unroll)
        if compress_grads:
            grads = compress_tree_int8(grads, _leaf_of)
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics = {"loss": loss, "ce": ce, **metrics}
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
