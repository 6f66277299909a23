"""Train / prefill / decode step builders — the port of
``repro.train.step``.

``make_train_step``: CE loss (pad-masked, MoE-aux added), gradients by
``torch.autograd`` over the module's parameters, AdamW (``.optim``).
Gradient compression (int8, the reference's quantize-dequantize, one
scale a leaf of the reference's tree) is applied when ``compress_grads``
— see ``repro_torch.distributed.compression``.
On a mesh (``mesh=``) ``make_train_step`` builds the sharded step, which
computes the reference's ``train_step`` jitted under its
``param_shardings`` / ``batch_shardings``.  Each rank holds its shards of
the parameters and of ``mu`` / ``nu`` (``distributed.sharding.Sharded``,
placed by ``checkpoint.reshard``).  A step fills a working module of
this rank's local shapes (:func:`working_module`, :func:`gather_working`):
each leaf that ``sharding.compute_split`` marks ``SPLIT`` is gathered
over the data axes only and stays this rank's model shard, every other
leaf is gathered whole.  The ranks of the "model" axis then split the
compute as the reference's GSPMD-partitioned step does
(``distributed.tp``): attention on this rank's heads (``wq``
column-parallel, ``wo`` row-parallel; K/V on its KV heads, or from the
whole gathered ``wk`` / ``wv`` whose gradients are summed over "model"),
else on its block of the query sequence with K/V gathered
(``attention._constrain_heads_or_seq``); the dense MLP, MoE's shared
expert and zamba2's LoRA column- then row-parallel; each rank's ``E /
tp`` experts of an MoE layer; the embedding and the tied logits
vocab-parallel, the loss a vocab-parallel log-softmax (:func:`
_vocab_parallel_nll`).  The batch splits over the data axes by
``batch_shardings`` (where the rules shard the sequence instead, the
batch is computed whole on every data rank); the loss comes from global
sums (the NLL sum and the label count ``psum``-ed over the data axes,
MoE layers routing over the whole batch: ``models.moe.split_tokens``);
each gradient is taken back to its parameter's model layout and
``psum``-ed over the data axes; the int8 compression applies to the
reduced gradient where asked (each leaf's scale the ``pmax`` over
"model" of its shards'), and AdamW clips by the global norm (the model
ranks' squares ``psum``-ed, a leaf left whole counted once) and updates
each rank's own slices.  On a model axis of one rank nothing is split
and the step is the data-parallel one, bit for bit.  Not split:
zamba2's Mamba2 and xlstm's mLSTM / sLSTM mixers, whose packed
projections do not line up with a contiguous model shard (computed whole
on every model rank);
each data rank still runs its MoE experts over an ``(E / tp, C, d)``
buffer sized by the whole batch; the weights are gathered for the whole
step, not layer by layer: ROADMAP.md, queue 1.
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
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import compat
from ..distributed import tp as _tp
from ..distributed.compression import compress_tree_int8
from ..distributed.sharding import (GATHER, SPLIT, Sharded, axis_size,
                                    batch_shardings, compute_split, dp_axes,
                                    local_slice, only_model, unshard,
                                    without_model)
from ..models import build
from ..models.convert import tree_path
from ..models.encdec import EncDec
from ..models.moe import TokenSplit, split_tokens
from ..models.transformer import Decoder
from .optim import AdamWConfig, OptState, apply_updates

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "loss_fn", "sharded_loss_and_grads", "working_module",
           "gather_working"]

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
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    vocab = _tp.axis_for(cfg.padded_vocab)
    if vocab is None:
        logp = F.log_softmax(logits.float(), dim=-1)
        picked = labels.clamp(0, logits.shape[-1] - 1).long()
        nll = -torch.gather(logp, -1, picked[..., None])[..., 0]
    else:
        nll = _vocab_parallel_nll(logits.float(), labels, vocab)
    nll = torch.where(mask, nll, torch.zeros_like(nll))
    return nll, mask, aux


def _vocab_parallel_nll(logits, labels, axis):
    """The NLL of ``labels`` from this rank's logits ``(..., V / tp)`` (its
    block of the vocabulary): the max and the sum of exponentials over the
    whole vocabulary from each rank's (``pmax``, ``reduce``), the picked
    logit from the rank that holds it (``reduce``)."""
    n = logits.shape[-1]
    m = compat.pmax(logits.detach().amax(dim=-1), axis.group, axis=_tp.AXIS)
    z = logits - m[..., None]
    sumexp = _tp.reduce(torch.exp(z).sum(dim=-1), axis)
    local = labels.clamp(0, n * axis.size - 1).long() - axis.index * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(z, -1, torch.where(
        inside, local, torch.zeros_like(local))[..., None])[..., 0]
    picked = _tp.reduce(torch.where(inside, picked, torch.zeros_like(picked)),
                        axis)
    return torch.log(sumexp) - picked


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


def working_module(cfg: ModelConfig, params: Sharded, device) -> nn.Module:
    """The module a rank computes the sharded step with: the model's
    parameters at this rank's local shapes, a model shard where
    ``compute_split`` says ``SPLIT`` (whole over the data axes), else the
    whole tensor; filled by :func:`gather_working` (storage only:
    ``torch.empty``)."""
    split = compute_split(params.specs, cfg, params.mesh)
    module = (EncDec if cfg.encoder_decoder else Decoder)(cfg, device="meta")
    for name, _ in list(module.named_parameters()):
        shape = list(params.shapes[name])
        if split[name] == SPLIT:
            for dim, axes in enumerate(only_model(params.specs[name])):
                if axes:
                    shape[dim] //= params.mesh.axis_size(axes)
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner), leaf,
                nn.Parameter(torch.empty(shape, device=device)))
    return module


def gather_working(params: Sharded, module: nn.Module) -> None:
    """Fill the working ``module`` from this rank's shards ``params``: a
    ``SPLIT`` leaf gathered over the data axes only, every other leaf
    whole (a collective: every rank of the mesh calls it)."""
    split = compute_split(params.specs, module.cfg, params.mesh)
    with torch.no_grad():
        for n, p in module.named_parameters():
            if split[n] == SPLIT:
                p.copy_(unshard(params[n], without_model(params.specs[n]),
                                params.mesh))
            else:
                p.copy_(params.whole(n))


def sharded_loss_and_grads(model, params: Sharded, module,
                           batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                           unroll: bool = False):
    """``(loss, ce, grads)`` of the global ``batch`` on ``params.mesh``: the
    reference's loss over the whole batch and its gradients, from this
    rank's slice of the batch where ``batch_shardings`` splits it over
    the data axes, else from the whole batch, with the compute split over
    the "model" axis (module docstring).  ``module`` is the working module
    (:func:`working_module`, filled by :func:`gather_working`).  Each
    gradient is in the layout its parameter is stored in over "model"
    (this rank's model shard, or whole where the rules leave it whole)
    and whole over the data axes, the same on every data rank."""
    mesh = params.mesh
    split = compute_split(params.specs, cfg, mesh)
    axis = _tp.ModelAxis.of(mesh) if axis_size(mesh, _tp.AXIS) > 1 else None
    named = list(module.named_parameters())
    dp = dp_axes(mesh)
    specs = batch_shardings(batch, mesh)

    def stored(grads):
        # a leaf gathered whole over "model" back to this rank's shard
        return {n: local_slice(g, only_model(params.specs[n]), mesh)
                .contiguous() if split[n] == GATHER else g
                for n, g in grads.items()}

    with _tp.split_model(axis):
        if specs["labels"][:1] != (dp,):
            with torch.enable_grad():
                loss, ce = loss_fn(model, module, batch, cfg, unroll=unroll)
                grads = _grads(loss, named)
            return loss.detach(), ce.detach(), stored(grads)
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
            grads = stored(_grads(nll_sum / count + _AUX_WEIGHT * aux,
                                  named))
    for n in grads:     # one tensor at a time: one extra in memory
        grads[n] = compat.psum(grads[n], group)
    ce = compat.psum(nll_sum.detach(), group) / count
    loss = ce + _AUX_WEIGHT * compat.psum(aux.detach(), group)
    return loss, ce, grads


def _model_pmax(mesh):
    """The max over the "model" axis, for the int8 scales of gradients
    held as model shards; None where the axis has one rank."""
    if axis_size(mesh, _tp.AXIS) == 1:
        return None
    group = mesh.group(_tp.AXIS)
    return lambda t: compat.pmax(t, group, axis=_tp.AXIS)


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
                work.append(working_module(cfg, params, dev))
            gather_working(params, work[0])
            loss, ce, grads = sharded_loss_and_grads(model, params, work[0],
                                                     batch, cfg, unroll)
        if compress_grads:
            grads = compress_tree_int8(
                grads, _leaf_of,
                None if mesh is None else _model_pmax(mesh))
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
