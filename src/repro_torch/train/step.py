"""Train / prefill / decode step builders — the port of
``repro.train.step``.

``make_train_step``: CE loss (pad-masked, MoE-aux added), each
super-block's activations recomputed in the backward pass under
``cfg.remat_policy`` (``models.remat``; on a mesh the recomputed blocks
issue their collectives again), gradients by ``torch.autograd`` over the
module's parameters, AdamW (``.optim``).
Gradient compression (int8, the reference's quantize-dequantize, one
scale a leaf of the reference's tree) is applied when ``compress_grads``
— see ``repro_torch.distributed.compression``.
On a mesh (``mesh=``) ``make_train_step`` builds the sharded step, which
computes the reference's ``train_step`` jitted under its
``param_shardings`` / ``batch_shardings``.  Each rank holds its shards of
the parameters and of ``mu`` / ``nu`` (``distributed.sharding.Sharded``,
placed by ``checkpoint.reshard``).  The weights are gathered layer by
layer, as the reference's FSDP rules have GSPMD gather them
(``distributed.fsdp``): each super-block gathers its own leaves inside
its call, and again where the backward pass recomputes it, and its
gradients are reduced back to this rank's shards inside the block's
backward pass; the leaves outside the super-blocks (the embedding, the
final norm, zamba2's shared block, whisper's encoder norm) are gathered
once, at their use.  A leaf that ``sharding.compute_split`` marks
``SPLIT`` is gathered over the data axes only and stays this rank's
model shard, every other leaf is gathered whole.  The ranks of the
"model" axis then split the compute as the reference's GSPMD-partitioned
step does (``distributed.tp``): attention on this rank's heads (``wq``
column-parallel, ``wo`` row-parallel; K/V on its KV heads, or from the
whole gathered ``wk`` / ``wv`` whose gradients are summed over "model"),
else on its block of the query sequence with K/V gathered
(``attention._constrain_heads_or_seq``); the dense MLP, MoE's shared
expert and zamba2's LoRA column- then row-parallel; each rank's ``E /
tp`` experts of an MoE layer; the Mamba2, mLSTM and sLSTM mixers on
this rank's ``H / tp`` heads where their head count divides the axis
(the head-aligned leaves this rank's model shards, the packed
projections gathered whole and its heads' columns selected:
``sharding.compute_split``'s ``SELECT``), the xLSTM's on head groups
where the axis is a multiple of its heads (``models.xlstm``), else
whole; the embedding and
the tied logits vocab-parallel, the loss a vocab-parallel log-softmax
(:func:`_vocab_parallel_nll`).  The batch splits over the data axes by
``batch_shardings`` (where the rules shard the sequence instead, the
batch is computed whole on every data rank); the loss comes from global
sums (the NLL sum and the label count ``psum``-ed over the data axes,
MoE layers routing over the whole batch: ``models.moe.split_tokens``);
each gradient comes out as this rank's shard of its parameter's, at its
stored local shape (reduce-scattered over the data axes that shard it,
``psum``-ed over the others); the int8 compression applies to it where
asked (each leaf's scale the ``pmax`` of its shards' over the mesh), and
AdamW clips by the global norm (each rank's squares ``psum``-ed over the
axes that split them, a replicated shard counted once) and updates each
rank's own slices.  On a model axis of one rank nothing is split; on a
(1, 1) mesh the step is the one-process step, bit for bit.  Each data
rank still runs its MoE experts over an ``(E / tp, C, d)`` buffer sized
by the whole batch: ROADMAP.md, queue 1.
``make_prefill_step``: forward only, returns the last position's logits.
``make_serve_step``: one greedy decode step against a KV cache.
The serving steps run without autograd.  Every step hands its inputs to
the model unchanged: ``tokens`` (or ``embeddings`` / ``positions``) and
``token`` for the decoder-only families, ``frames`` / ``dec_tokens`` and
``token`` for the encoder-decoder (whose decode cache holds the encoder
memory, from ``models.encdec.encdec_prefill_memory``).
On a mesh (``mesh=``) the serving steps compute the reference's
``prefill_step`` and ``serve_step`` jitted under ``param_shardings`` /
``batch_shardings`` / ``cache_shardings``, with the train step's
machinery but for one thing: each holds a working module of this rank's
model shards, whole over the data axes (:func:`working_module`, filled
by :func:`gather_working`), gathered at its first call and again only
for another ``params`` or after the step's ``regather()``, not layer by
layer (ROADMAP.md, queue 1); the batch split over the data axes by
``batch_shardings`` (computed whole where the rules shard the sequence
instead), MoE layers routing over the whole
batch, and the model axis splitting attention, the MLPs, the experts,
the vocabulary and (in the prefill) the mixers as in training.  The
prefill (:func:`sharded_prefill`) returns the last position's logits
whole, ``(B, V)`` on every rank,
gathered from the vocab-parallel logits and the data ranks.  The decode
(:func:`sharded_decode`) takes this rank's slices of the cache
(``distributed.sharding.ShardedCache``, from ``Model.init_cache(...,
mesh=)`` or ``ShardedCache.place``) and the global inputs; its
attention splits as the cache's spec says: KV heads on "model" (this
rank's KV heads and the query heads that read them), or the sequence on
"model" / ("data", "model") (this rank's block of slots, written by the
rank that holds the new token's slot and read by flash-decoding over the
group).  The decode's working module holds each Mamba2, mLSTM and
sLSTM weight at its stored model shard (``compute_split(...,
mixers=False)``: the dimension its spec puts "model" on, whatever the
heads; whole where the rules leave it whole): each model rank computes
every projection on its own shard, moves the projections' outputs to
the layout of its slice of each state (updated where the rules store
it, on ``N`` / ``K`` / channels) and reduces the readouts and the
row-split output projections over "model" (``models.ssm``,
``models.xlstm``); no state and no mixer weight crosses the model axis.
The greedy
pick (:func:`greedy_pick`) reduces ``(max, index)`` pairs over the model
ranks rather than gathering ``(B, V)``: ``B * tp`` pairs instead of
``B * V`` logits (gemma3's vocabulary is 262,144), and exact, since a max
is a comparison: each rank's first maximum, then the first rank that
reaches the global max, which is the lowest vocabulary index that does
(the reference's ``argmax``).  On a (1, 1) mesh each step is the
one-process step bit for bit.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import compat
from ..distributed import tp as _tp
from ..distributed.compression import compress_tree_int8
from ..distributed.fsdp import LayerGather, gathering
from ..distributed.sharding import (SPLIT, Sharded, ShardedCache,
                                    axis_size, batch_shardings,
                                    compute_split, dp_axes, local_slice,
                                    only_model, unshard, without_model)
from ..models import build, module_of
from ..models.convert import tree_path
from ..models.moe import TokenSplit, split_tokens
from .optim import AdamWConfig, OptState, apply_updates

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "loss_fn", "sharded_loss_and_grads", "working_module",
           "gather_working", "sharded_prefill",
           "sharded_decode", "sharded_prefill_memory", "whole_logits",
           "greedy_pick"]

_AUX_WEIGHT = 0.01


def _leaf_of(name: str):
    """The reference tree's leaf of a parameter (its keys, without the
    index on the stacked axes): the unit the int8 compression scales."""
    return tree_path(name)[0]


def _loss_sums(model, params, batch: Dict[str, Any], cfg: ModelConfig,
               unroll: bool = False, remat: bool = True):
    """``(nll, mask, aux)``: the per-label f32 NLL (0 at padding), the
    mask of the labels that count and the MoE blocks' Switch loss; each
    super-block recomputed in the backward pass under
    ``cfg.remat_policy`` where ``remat`` (``models.remat``)."""
    labels = batch["labels"]
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    logits, aux = model.apply(params, **inputs, remat=remat, unroll=unroll)
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
            unroll: bool = False, remat: bool = True):
    """``(ce + _AUX_WEIGHT * aux, ce)``: the mean next-token cross-entropy
    in f32 over the labels inside ``[0, vocab_size)`` (the others are
    padding and count nothing), plus the MoE blocks' Switch loss.
    ``remat`` recomputes each super-block in the backward pass under
    ``cfg.remat_policy``, as the reference's loss always does; False
    keeps every activation."""
    nll, mask, aux = _loss_sums(model, params, batch, cfg, unroll, remat)
    ce = nll.sum() / torch.clamp(mask.sum(), min=1)
    return ce + _AUX_WEIGHT * aux, ce


def _grads(loss, named):
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named, grads)}


def working_module(cfg: ModelConfig, params: Sharded, device,
                   mixers: bool = True) -> nn.Module:
    """The module a rank computes the sharded serving steps with: the
    model's parameters at this rank's local shapes, a model shard where
    ``compute_split`` says ``SPLIT`` (whole over the data axes), else the
    whole tensor; filled by :func:`gather_working` (storage only:
    ``torch.empty``).  ``mixers`` False is the decode's: every Mamba2
    and xLSTM mixer leaf at its stored model shard (``compute_split``)."""
    split = compute_split(params.specs, cfg, params.mesh, mixers)

    def empty(name):
        shape = list(params.shapes[name])
        if split[name] == SPLIT:
            for dim, axes in enumerate(only_model(params.specs[name])):
                if axes:
                    shape[dim] //= params.mesh.axis_size(axes)
        return torch.empty(shape, device=device)

    return module_of(cfg, empty)


def gather_working(params: Sharded, module: nn.Module,
                   mixers: bool = True) -> None:
    """Fill the working ``module`` (of :func:`working_module` with the same
    ``mixers``) from this rank's shards ``params``: a ``SPLIT`` leaf
    gathered over the data axes only, every other leaf whole (a
    collective: every rank of the mesh calls it)."""
    split = compute_split(params.specs, module.cfg, params.mesh, mixers)
    with torch.no_grad(), compat.counted_apart("working_gather"):
        for n, p in module.named_parameters():
            if split[n] == SPLIT:
                p.copy_(unshard(params[n], without_model(params.specs[n]),
                                params.mesh))
            else:
                p.copy_(params.whole(n))


def sharded_loss_and_grads(model, params: Sharded,
                           batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                           unroll: bool = False, remat: bool = True):
    """``(loss, ce, grads)`` of the global ``batch`` on ``params.mesh``: the
    reference's loss over the whole batch and its gradients, from this
    rank's slice of the batch where ``batch_shardings`` splits it over
    the data axes, else from the whole batch, with the compute split over
    the "model" axis and each block's weights gathered inside its own
    call (module docstring).  Each gradient is this rank's shard of its
    parameter's, at the parameter's stored local shape, summed over the
    data ranks inside the backward pass."""
    mesh = params.mesh
    axis = _tp.ModelAxis.of(mesh) if axis_size(mesh, _tp.AXIS) > 1 else None
    dp = dp_axes(mesh)
    specs = batch_shardings(batch, mesh)
    split = specs["labels"][:1] == (dp,)
    plan = LayerGather(module_of(cfg, lambda n: params[n].detach()), params,
                       reduce=split)
    named = list(plan.module.named_parameters())
    with _tp.split_model(axis), gathering(plan):
        if not split:
            with torch.enable_grad():
                loss, ce = loss_fn(model, plan.module, batch, cfg,
                                   unroll=unroll, remat=remat)
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
            nll, _, aux = _loss_sums(model, plan.module, local, cfg, unroll,
                                     remat)
            nll_sum = nll.sum()
            grads = _grads(nll_sum / count + _AUX_WEIGHT * aux, named)
    ce = compat.psum(nll_sum.detach(), group) / count
    loss = ce + _AUX_WEIGHT * compat.psum(aux.detach(), group)
    return loss, ce, grads


def _mesh_pmax(mesh):
    """The max over the whole mesh, for the int8 scales of gradients held
    as shards (a rank holding a replica of a shard adds nothing to a
    max); None on a mesh of one rank."""
    if mesh.size == 1:
        return None
    group = mesh.group(mesh.axis_names)
    return lambda t: compat.pmax(t, group)


def _keeper(cfg: ModelConfig, device, mixers: bool = True):
    """``keep(params) -> module``: a serving step's working module
    (:func:`working_module`, the mixers split where ``mixers``), built at
    its first call and held by the step; filled from ``params``
    (:func:`gather_working`, a collective: every rank calls it alike) at
    the first call, for another ``params`` than the last call's, and
    after ``keep.regather()``; ``keep.held()`` is the module (None before
    the first call)."""
    held = []                           # [params it was filled from, module]

    def keep(params: Sharded) -> nn.Module:
        if not held:
            held[:] = [None, working_module(cfg, params, device, mixers)]
        if held[0] is not params:
            gather_working(params, held[1], mixers)
            held[0] = params
        return held[1]

    def stale() -> None:
        if held:
            held[0] = None

    keep.regather = stale
    keep.held = lambda: held[1] if held else None
    return keep


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    compress_grads: bool = False, unroll: bool = False,
                    device="cuda", mesh=None, remat: bool = True):
    """Build ``(model, train_step)``.  ``train_step(params, opt_state,
    batch) -> (params, opt_state, metrics)`` updates ``params`` (the
    module) and the moments in place; ``batch`` holds tensors or numpy
    arrays (moved to ``device``); ``metrics`` holds ``loss``, ``ce``,
    ``grad_norm`` and ``lr`` as f32 scalar tensors on the device (reading
    one synchronises).  On a live ``mesh`` ``params`` is this rank's ``Sharded`` parameters and ``batch``
    the global batch, the same on every rank (module docstring).
    ``remat`` (the reference's loss always recomputes) recomputes each
    super-block in the backward pass under ``cfg.remat_policy``; False
    keeps every activation."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(params, opt_state: OptState, batch):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if mesh is None:
            named = list(params.named_parameters())
            with torch.enable_grad():
                loss, ce = loss_fn(model, params, batch, cfg, unroll=unroll,
                                   remat=remat)
                grads = _grads(loss, named)
            loss, ce = loss.detach(), ce.detach()
        else:
            loss, ce, grads = sharded_loss_and_grads(
                model, params, batch, cfg, unroll, remat)
        if compress_grads:
            grads = compress_tree_int8(
                grads, _leaf_of,
                None if mesh is None else _mesh_pmax(mesh))
        params, opt_state, metrics = apply_updates(params, grads, opt_state,
                                                   opt_cfg)
        metrics = {"loss": loss, "ce": ce, **metrics}
        return params, opt_state, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig, unroll: bool = False,
                      device="cuda", mesh=None):
    """Build ``(model, prefill_step)``: a full forward pass over a prompt
    batch that returns only the last position's logits — the serving
    prefill phase.  On a live ``mesh``, ``prefill_step(params, batch)``
    takes this rank's ``Sharded`` parameters and the global batch, the
    same on every rank, and returns the whole ``(B, V)`` logits on every
    rank (:func:`sharded_prefill`).  Its working module is gathered at
    the first call and for another ``params``; a caller that changes
    ``params`` in place calls ``prefill_step.regather()`` first;
    ``prefill_step.held()`` is the working module."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    keep = _keeper(cfg, dev)

    @torch.no_grad()
    def prefill_step(params, batch):
        inputs = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                  if k != "labels"}
        if mesh is not None:
            return sharded_prefill(model, params, keep(params), inputs,
                                   unroll)
        logits, _ = model.apply(params, **inputs, remat=False, unroll=unroll)
        return logits[:, -1, :]

    prefill_step.regather, prefill_step.held = keep.regather, keep.held
    return model, prefill_step


def make_serve_step(cfg: ModelConfig, unroll: bool = False, device="cuda",
                    mesh=None):
    """Build ``(model, serve_step)``: one greedy decode step — append the
    incoming token to the KV cache, return ``(next_token, cache)``.  The
    next token is the first maximum of the logits (int32).  On a live
    ``mesh``, ``serve_step(params, cache, inputs)`` takes this rank's
    ``Sharded`` parameters, this rank's ``ShardedCache`` and the global
    inputs, and returns the ``(B,)`` next tokens on every rank with the
    new ``ShardedCache`` (:func:`sharded_decode`, :func:`greedy_pick`);
    its working module is kept as ``make_prefill_step``'s is
    (``serve_step.regather()``, ``serve_step.held()``), with every
    Mamba2 and xLSTM mixer leaf at its stored model shard."""
    dev = resolve_device(device)
    model = build(cfg, device=dev)
    keep = _keeper(cfg, dev, mixers=False)

    @torch.no_grad()
    def serve_step(params, cache, inputs):
        if mesh is not None:
            inputs = {k: torch.as_tensor(v, device=dev)
                      for k, v in inputs.items()}
            logits, cache = sharded_decode(model, params, keep(params), cache,
                                           inputs, unroll)
            return greedy_pick(logits, mesh, cache.batch,
                               cfg.padded_vocab), cache
        logits, cache = model.decode_step(params, cache, **inputs,
                                          unroll=unroll)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)
        return next_token.to(torch.int32), cache

    serve_step.regather, serve_step.held = keep.regather, keep.held
    return model, serve_step


# ---------------------------------------------------------------------------
# the serving steps on a mesh
# ---------------------------------------------------------------------------

def _main_input(inputs) -> str:
    for k in ("tokens", "embeddings", "frames", "token", "embedding"):
        if k in inputs:
            return k
    raise ValueError(f"no model input among {sorted(inputs)}")


def _batch_split(inputs, mesh):
    """``(inputs, split)``: this rank's slice of the global ``inputs`` and
    the ``TokenSplit`` of the data axes where ``batch_shardings`` splits
    the batch over them, else the whole inputs and None."""
    dp = dp_axes(mesh)
    specs = batch_shardings(inputs, mesh)
    if specs[_main_input(inputs)][:1] != (dp,):
        return inputs, None
    group = mesh.group(dp)
    return ({k: local_slice(v, specs[k], mesh) for k, v in inputs.items()},
            TokenSplit(n=mesh.axis_size(dp), index=mesh.index(dp),
                       gather=lambda c: compat.all_gather(c[None], group)))


def _model_axis(mesh) -> Optional[_tp.ModelAxis]:
    return _tp.ModelAxis.of(mesh) if axis_size(mesh, _tp.AXIS) > 1 else None


@torch.no_grad()
def sharded_prefill(model, params: Sharded, work: nn.Module, inputs,
                    unroll: bool = False):
    """The last position's logits of the global ``inputs`` (no labels),
    whole ``(B, V)`` on every rank, from this rank's ``params`` and their
    working module ``work`` (module docstring)."""
    cfg, mesh = model.cfg, params.mesh
    B = inputs[_main_input(inputs)].shape[0]
    local, split = _batch_split(inputs, mesh)
    with _tp.split_model(_model_axis(mesh)), split_tokens(split):
        logits, _ = model.apply(work, **local, remat=False, unroll=unroll)
    return whole_logits(logits[:, -1], mesh, B, cfg.padded_vocab)


@torch.no_grad()
def sharded_decode(model, params: Sharded, work: nn.Module,
                   cache: ShardedCache, inputs, unroll: bool = False):
    """One decode step of the global ``inputs`` on this rank's slices
    ``cache``, with the working module ``work`` of this rank's ``params``
    -> ``(logits, cache)``: this rank's last-position logits,
    ``(B_l, V_l)`` (its data slice of the batch where the rules split it,
    its block of the vocabulary where the model axis splits it: see
    :func:`whole_logits`, :func:`greedy_pick`), and the new
    ``ShardedCache`` (module docstring)."""
    mesh = params.mesh
    local, split = _batch_split(inputs, mesh)
    with _tp.split_model(_model_axis(mesh)), split_tokens(split):
        logits, cache = model.decode_step(work, cache, **local,
                                          unroll=unroll)
    return logits[:, -1], cache


@torch.no_grad()
def sharded_prefill_memory(model, params: Sharded, cache: ShardedCache,
                           frames):
    """The encoder-decoder's memory for the global ``frames`` filled into
    this rank's slices of ``cache`` (``models.encdec.encdec_prefill_memory``
    on a mesh) -> the new ``ShardedCache``.  Once a request batch: it
    gathers a working module of its own for the call (a collective)."""
    from ..models.encdec import encdec_prefill_memory

    cfg, mesh = model.cfg, params.mesh
    work = working_module(cfg, params, mesh.device)
    gather_working(params, work)
    local, _ = _batch_split({"frames": torch.as_tensor(
        frames, device=mesh.device)}, mesh)
    with _tp.split_model(_model_axis(mesh)):
        return encdec_prefill_memory(work, cfg, local["frames"], cache)


def whole_logits(logits, mesh, batch: int, vocab: int):
    """``(batch, vocab)``: this rank's ``(B_l, V_l)`` logits gathered over
    the model axis where ``V_l`` is its block of the ``vocab`` (padded)
    columns, and over the data axes where ``B_l`` is its slice of the
    ``batch`` rows (a collective: every rank calls it)."""
    if logits.shape[-1] < vocab:
        logits = compat.all_gather(logits.contiguous(),
                                   mesh.group(_tp.AXIS), dim=-1,
                                   axis=_tp.AXIS)
    if logits.shape[0] < batch:
        logits = compat.all_gather(logits.contiguous(),
                                   mesh.group(dp_axes(mesh)), dim=0)
    return logits


def greedy_pick(logits, mesh, batch: int, vocab: int):
    """The ``(batch,)`` int32 first maximum of each row of the whole
    logits, on every rank, from this rank's ``(B_l, V_l)`` logits (as in
    :func:`whole_logits`): each rank's first maximum and its index, the
    ``(max, index)`` pairs gathered over the model axis, the first rank
    whose max is the greatest (the lowest vocabulary index that reaches
    it: the model ranks hold contiguous blocks in rank order), then the
    data slices gathered (module docstring)."""
    idx = torch.argmax(logits, dim=-1)
    n = logits.shape[-1]
    if n < vocab:
        group = mesh.group(_tp.AXIS)
        best = torch.gather(logits, -1, idx[:, None])
        idx = idx[:, None] + mesh.index(_tp.AXIS) * n
        best = compat.all_gather(best.contiguous(), group, dim=1,
                                 axis=_tp.AXIS)
        idx = compat.all_gather(idx.contiguous(), group, dim=1,
                                axis=_tp.AXIS)
        idx = torch.gather(idx, 1, torch.argmax(best, dim=1)[:, None])[:, 0]
    if idx.shape[0] < batch:
        idx = compat.all_gather(idx.contiguous(), mesh.group(dp_axes(mesh)),
                                dim=0)
    return idx.to(torch.int32)
