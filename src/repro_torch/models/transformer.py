"""Decoder-stack assembly for the decoder-only families.

The port of ``repro.models.transformer``.  Layer stacks are grouped into
*segments* of identical repeating "super-blocks", as in the reference::

    gemma3-1b   [(5 local + 1 global) x 4, local x 2]
    zamba2-2.7b [(6 mamba + shared attn) x 9]   (shared weights + LoRA)
    xlstm-1.3b  [(5 mLSTM + 1 sLSTM) x 8]
    moe archs   [moe-block x L]
    dense       [block x L]

The reference scans stacked params with ``lax.scan``; here a
:class:`Decoder` module holds each segment as a list of super-blocks and
loops over them in the reference's layer order (``unroll=`` is
accepted and changes no result).  With ``remat`` (the default, as the
reference's) and grad enabled, each super-block runs through
``models.remat.remat_call`` under ``cfg.remat_policy``, the unit the
reference's ``jax.checkpoint`` wraps: its activations are recomputed in
the backward pass (``"full"``) or all but its products with no batch
dimensions (``"dots"``); the hybrid's shared attention block is
recomputed inside each super-block it is handed to, and an MoE block's
Switch loss comes out of the block.  zamba2's shared
attention block is held once, by the :class:`Decoder`
(``shared_attn.block``), and handed to each hybrid super-block, as the
reference hands ``shared``.  Decode threads a cache per super-block
through the same loop: a KV cache for attention (a windowed layer's is a
ring of ``min(max_len, window)`` slots), the f32 recurrent state of a
Mamba2, mLSTM or sLSTM layer.  On a mesh the decode takes this rank's
slices of the cache (``distributed.sharding.ShardedCache``) and walks
their specs beside them: attention splits as its cache's spec says
(``attention.decode_attention``); a recurrent state is stored as the
rules shard it (on ``N`` / ``K`` / channels, not by head) and its mixer
computes whole on every model rank in the decode, so the step gathers
the state over "model", runs the mixer and keeps its own slice.  The
full-sequence forms (training, prefill) split the Mamba2, mLSTM and
sLSTM mixers by head over the model axis where their heads divide it
(``ssm``, ``xlstm``).

The encoder-decoder family (whisper) is :class:`~.encdec.EncDec`.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import fsdp as _fsdp
from ..distributed import tp as _tp
from ..distributed.sharding import (ShardedCache, local_slice, only_model,
                                    unshard)
from .attention import (
    Attention,
    KVCache,
    attention,
    decode_attention,
    init_cache,
)
from .layers import MLP, Embedding, RMSNorm, _he, cast, embed, mlp_apply, \
    rms_norm, unembed, vocab_axis
from .moe import MoE, moe_apply
from .remat import remat_call
from .ssm import Mamba, init_mamba_cache, mamba_apply, mamba_decode
from .xlstm import (
    MLstm,
    SLstm,
    init_mlstm_cache,
    init_slstm_cache,
    mlstm_apply,
    mlstm_decode,
    slstm_apply,
    slstm_decode,
)

__all__ = ["segments_for", "Decoder", "DenseBlock", "LocalGlobal",
           "MoEBlock", "MambaBlock", "MambaHybrid", "XLstmBlock",
           "XLstmSuper", "init_decoder",
           "decoder_apply", "decoder_decode", "init_decoder_cache"]

_LORA_RANK = 128


def _encdec_refused(cfg: ModelConfig) -> ValueError:
    return ValueError(f"{cfg.name} is an encoder-decoder: its parameters "
                      "are an encdec.EncDec")


# ---------------------------------------------------------------------------
# segment layout
# ---------------------------------------------------------------------------

def segments_for(cfg: ModelConfig) -> List[Tuple[str, int, int]]:
    """[(super_block_kind, n_iterations, layers_per_super), ...]."""
    if cfg.family in ("dense",) and cfg.local_global_ratio:
        per = cfg.local_global_ratio + 1
        n_super = cfg.n_layers // per
        rem = cfg.n_layers - n_super * per
        segs = [("local_global", n_super, per)]
        if rem:
            segs.append(("local_only", rem, 1))
        return segs
    if cfg.family == "hybrid":
        per = cfg.hybrid_attn_every
        assert cfg.n_layers % per == 0
        return [("mamba_hybrid", cfg.n_layers // per, per)]
    if cfg.family == "ssm" and cfg.mlstm_slstm_pattern:
        per = cfg.mlstm_slstm_pattern + 1
        assert cfg.n_layers % per == 0
        return [("xlstm_super", cfg.n_layers // per, per)]
    if cfg.family == "moe":
        return [("moe_block", cfg.n_layers, 1)]
    return [("dense_block", cfg.n_layers, 1)]


# ---------------------------------------------------------------------------
# blocks and super-blocks
# ---------------------------------------------------------------------------

def _init_all(gen: torch.Generator, *modules) -> None:
    for m in modules:
        m.init_(gen)


class DenseBlock(nn.Module):
    """Pre-norm attention + SwiGLU MLP, residual around each."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, self.ln1, self.attn, self.ln2, self.mlp)


class LocalGlobal(nn.Module):
    """gemma3's super-block: ``per - 1`` windowed blocks, then one global."""

    def __init__(self, cfg, per: int, device=None):
        super().__init__()
        self.locals = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(per - 1))
        self.global_ = DenseBlock(cfg, device)

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, *self.locals, self.global_)


class MoEBlock(nn.Module):
    """Pre-norm attention + a mixture of experts, residual around each."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.moe = MoE(cfg, device=device)

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, self.ln1, self.attn, self.ln2, self.moe)


class MambaBlock(nn.Module):
    """Pre-norm Mamba2 mixer, residual around it."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device)
        self.mixer = Mamba(cfg, device=device)

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, self.ln, self.mixer)


class XLstmBlock(nn.Module):
    """Pre-norm xLSTM cell (an :class:`MLstm` or :class:`SLstm`),
    residual around it."""

    def __init__(self, cfg, core: nn.Module, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, device=device)
        self.core = core

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, self.ln, self.core)


class MambaHybrid(nn.Module):
    """zamba2's super-block: ``per`` Mamba2 blocks, then the shared
    attention block (held by the :class:`Decoder`, not here) on an input
    adapted by this super-block's LoRA ``lora_a @ lora_b`` (rank 128;
    ``lora_b`` is zero at init, as in the reference)."""

    def __init__(self, cfg, per: int, device=None):
        super().__init__()
        self.mambas = nn.ModuleList(MambaBlock(cfg, device)
                                    for _ in range(per))
        self.lora_a = nn.Parameter(torch.empty(cfg.d_model, _LORA_RANK,
                                               device=device))
        self.lora_b = nn.Parameter(torch.zeros(_LORA_RANK, cfg.d_model,
                                               device=device))

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, *self.mambas)
        _he(gen, self.lora_a, self.lora_a.shape[0])
        with torch.no_grad():
            self.lora_b.zero_()


class XLstmSuper(nn.Module):
    """xlstm's super-block: ``per - 1`` mLSTM blocks, then one sLSTM."""

    def __init__(self, cfg, per: int, device=None):
        super().__init__()
        self.mlstms = nn.ModuleList(XLstmBlock(cfg, MLstm(cfg, device), device)
                                    for _ in range(per - 1))
        self.slstm = XLstmBlock(cfg, SLstm(cfg, device), device)

    def init_(self, gen: torch.Generator) -> None:
        _init_all(gen, *self.mlstms, self.slstm)


def _make_super(kind: str, cfg, per: int, device) -> nn.Module:
    if kind in ("dense_block", "local_only"):
        return DenseBlock(cfg, device)
    if kind == "local_global":
        return LocalGlobal(cfg, per, device)
    if kind == "moe_block":
        return MoEBlock(cfg, device)
    if kind == "mamba_hybrid":
        return MambaHybrid(cfg, per, device)
    if kind == "xlstm_super":
        return XLstmSuper(cfg, per, device)
    raise ValueError(kind)


def _dense_block(params: DenseBlock, x, positions, cfg, window: int = 0,
                 causal: bool = True):
    h = x + attention(params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps),
                      positions, cfg, causal=causal, window=window)
    return h + mlp_apply(params.mlp, rms_norm(h, params.ln2.scale,
                                              cfg.norm_eps), cfg.d_ff)


def _dense_block_decode(params: DenseBlock, x, cache: KVCache, cfg,
                        window: int = 0, spec=None, mesh=None):
    a, cache = decode_attention(
        params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps), cache, cfg,
        window=window, spec=spec, mesh=mesh)
    h = x + a
    return h + mlp_apply(params.mlp, rms_norm(h, params.ln2.scale,
                                              cfg.norm_eps), cfg.d_ff), cache


def _moe_block(params: MoEBlock, x, positions, cfg):
    h = x + attention(params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps),
                      positions, cfg)
    y, aux = moe_apply(params.moe, rms_norm(h, params.ln2.scale,
                                            cfg.norm_eps), cfg)
    return h + y, aux


def _moe_block_decode(params: MoEBlock, x, cache: KVCache, cfg, spec=None,
                      mesh=None):
    a, cache = decode_attention(
        params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps), cache, cfg,
        spec=spec, mesh=mesh)
    h = x + a
    y, _ = moe_apply(params.moe, rms_norm(h, params.ln2.scale, cfg.norm_eps),
                     cfg)
    return h + y, cache


def _lora(params: MambaHybrid, x):
    """The shared block's input adapter ``(x @ lora_a) @ lora_b``; under a
    model axis that splits the rank, ``lora_a`` column- and ``lora_b``
    row-parallel."""
    axis = _tp.axis_for(_LORA_RANK)
    if axis is None:
        return (x @ cast(params.lora_a, x.dtype)) @ cast(params.lora_b,
                                                         x.dtype)
    _tp.check_local(params.lora_a, 1, _LORA_RANK, axis, "lora_a")
    y = (_tp.copy(x, axis) @ cast(params.lora_a, x.dtype)) @ cast(
        params.lora_b, x.dtype)
    return _tp.reduce(y, axis)


def _apply_super(kind, params, x, positions, cfg, shared=None):
    """Forward one super-block; returns (x, aux_loss or None).  In the
    sharded train step its weights are gathered here, inside the block
    that ``remat_call`` recomputes (``distributed.fsdp``)."""
    params = _fsdp.gathered(params)
    if kind in ("dense_block", "local_only"):
        w = cfg.sliding_window if (
            kind == "local_only"
            or (kind == "dense_block" and cfg.sliding_window
                and not cfg.local_global_ratio)) else 0
        return _dense_block(params, x, positions, cfg, window=w), None
    if kind == "moe_block":
        return _moe_block(params, x, positions, cfg)
    if kind == "local_global":
        for p in params.locals:
            x = _dense_block(p, x, positions, cfg, window=cfg.sliding_window)
        return _dense_block(params.global_, x, positions, cfg, window=0), None
    if kind == "mamba_hybrid":
        axis = _tp.axis_for(cfg.n_ssm_heads)
        for p in params.mambas:
            x = x + mamba_apply(p.mixer, rms_norm(x, p.ln.scale, cfg.norm_eps),
                                cfg, axis)
        # shared attention block with per-use LoRA input adaptation
        return _dense_block(shared, x + _lora(params, x), positions,
                            cfg), None
    if kind == "xlstm_super":
        axis = _tp.axis_for(cfg.n_heads)
        for p in params.mlstms:
            x = x + mlstm_apply(p.core, rms_norm(x, p.ln.scale, cfg.norm_eps),
                                cfg, axis)
        p = params.slstm
        return x + slstm_apply(p.core, rms_norm(x, p.ln.scale, cfg.norm_eps),
                               cfg, axis), None
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# full decoder
# ---------------------------------------------------------------------------

class Decoder(nn.Module):
    """The decoder's parameters: ``embed`` (tied logits head), one list of
    super-blocks per segment of :func:`segments_for`, for the hybrid
    family the one ``shared_attn.block``, ``final_norm``.  ``forward`` is
    :func:`decoder_apply` under the module's own config."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_decoder:
            raise _encdec_refused(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device=device)
        self.segments = nn.ModuleList(
            nn.ModuleList(_make_super(kind, cfg, per, device)
                          for _ in range(n_iter))
            for kind, n_iter, per in segments_for(cfg))
        self.shared_attn = nn.ModuleDict(
            {"block": DenseBlock(cfg, device)}) \
            if cfg.family == "hybrid" else None
        self.final_norm = RMSNorm(cfg.d_model, device=device)

    @property
    def shared(self):
        """The shared attention block (hybrid family), else None."""
        return None if self.shared_attn is None else self.shared_attn["block"]

    def init_(self, gen: torch.Generator) -> None:
        """Fill every weight from ``gen`` (He-normal kernels and tables,
        zero norm scales and biases, zero ``lora_b``), in layer order."""
        self.embed.init_(gen)
        for seg in self.segments:
            for sup in seg:
                sup.init_(gen)
        if self.shared is not None:
            self.shared.init_(gen)
        self.final_norm.init_(gen)

    def forward(self, tokens=None, embeddings=None, positions=None):
        return decoder_apply(self, self.cfg, tokens=tokens,
                             embeddings=embeddings, positions=positions)


def init_decoder(gen, cfg: ModelConfig, device="cuda") -> Decoder:
    """A :class:`Decoder` on ``device`` initialised from ``gen`` (a
    ``torch.Generator`` on that device, or an int seed for one)."""
    device = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    params = Decoder(cfg, device=device)
    params.init_(gen)
    return params


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def decoder_apply(params: Decoder, cfg: ModelConfig, tokens=None,
                  embeddings=None, positions=None, remat: bool = True,
                  unroll: bool = False):
    """Forward pass -> (logits (B,S,V), aux_loss): the MoE blocks' Switch
    losses summed over layers (0 for the other families).  Under a model
    axis (``distributed.tp``: the sharded steps) the blocks split their
    compute, the embedding is vocab-parallel and the
    logits are this rank's ``(B, S, V / tp)``; the Mamba2 and xLSTM
    mixers run this rank's heads where their head count divides the
    axis, else whole on every model rank.  In the sharded train step
    ``params`` holds this rank's shards: the modules outside the
    super-blocks (the embedding, the shared block, the final norm) are
    gathered here, once each, and each super-block's inside its own call
    (``distributed.fsdp``).  ``remat`` recomputes each super-block in the
    backward pass under ``cfg.remat_policy`` (module docstring)."""
    table = _fsdp.gathered(params.embed).table
    shared = None if params.shared is None else _fsdp.gathered(params.shared)
    vocab = vocab_axis(table, cfg.padded_vocab)
    if embeddings is None:
        x = embed(table, tokens, vocab).to(_dtype(cfg))
        B, S = tokens.shape
    else:
        x = embeddings.to(_dtype(cfg))
        B, S = embeddings.shape[:2]
    if positions is None:
        base = torch.arange(S, device=x.device)[None].expand(B, S)
        positions = (base[None].expand(3, B, S)
                     if cfg.mrope_sections is not None else base)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (kind, _, _), seg in zip(segments_for(cfg), params.segments):
        for p in seg:
            if remat:
                x, aux = remat_call(cfg, _apply_super, kind, p, x, positions,
                                    cfg, shared)
            else:
                x, aux = _apply_super(kind, p, x, positions, cfg, shared)
            if aux is not None:
                aux_total = aux_total + aux
    x = rms_norm(x, _fsdp.gathered(params.final_norm).scale, cfg.norm_eps)
    logits = unembed(table, x, vocab)
    return logits, aux_total


# -- decode -------------------------------------------------------------------

def _init_super_cache(kind, batch, max_len, cfg, per, dtype, device):
    if kind in ("dense_block", "local_only", "moe_block"):
        w = cfg.sliding_window if kind == "local_only" else 0
        eff = min(max_len, w) if w else max_len
        return init_cache(batch, eff, cfg, dtype, device)
    if kind == "local_global":
        w = min(max_len, cfg.sliding_window)
        return {
            "locals": [init_cache(batch, w, cfg, dtype, device)
                       for _ in range(per - 1)],
            "global": init_cache(batch, max_len, cfg, dtype, device),
        }
    # the recurrent states are f32 whatever ``dtype`` the KV caches take
    if kind == "mamba_hybrid":
        return {
            "mambas": [init_mamba_cache(batch, cfg, device=device)
                       for _ in range(per)],
            "attn": init_cache(batch, max_len, cfg, dtype, device),
        }
    if kind == "xlstm_super":
        return {
            "mlstms": [init_mlstm_cache(batch, cfg, device=device)
                       for _ in range(per - 1)],
            "slstm": init_slstm_cache(batch, cfg, device=device),
        }
    raise ValueError(kind)


def init_decoder_cache(batch: int, max_len: int, cfg: ModelConfig,
                       dtype=torch.bfloat16, device="cuda") -> List[Any]:
    """One cache per super-block, per segment: a :class:`KVCache` for a
    block, ``{"locals": [...], "global": ...}`` for a local/global one,
    ``{"mambas": [MambaCache...], "attn": KVCache}`` for a hybrid one and
    ``{"mlstms": [MLstmCache...], "slstm": SLstmCache}`` for an xLSTM
    one."""
    device = resolve_device(device)
    if cfg.encoder_decoder:
        raise _encdec_refused(cfg)
    return [[_init_super_cache(kind, batch, max_len, cfg, per, dtype, device)
             for _ in range(n_iter)]
            for kind, n_iter, per in segments_for(cfg)]


def _no_specs(cache):
    """A spec tree of ``cache``'s structure with None at every cache (the
    one-process decode)."""
    if isinstance(cache, list):
        return [_no_specs(c) for c in cache]
    if isinstance(cache, dict):
        return {k: _no_specs(v) for k, v in cache.items()}
    return None


def _recurrent(step, state, spec, mesh):
    """``step(whole_state) -> (y, new_state)`` on this rank's slice of a
    recurrent ``state`` laid out by ``spec``: the state gathered over
    "model" (its batch stays this rank's), the mixer run whole, this
    rank's slice of the new state kept."""
    if spec is None:
        return step(state)
    whole = type(state)(*(unshard(t, only_model(s), mesh)
                          for t, s in zip(state, spec)))
    y, new = step(whole)
    return y, type(new)(*(
        local_slice(t, only_model(s), mesh).clone(
            memory_format=torch.contiguous_format)
        for t, s in zip(new, spec)))


def _decode_super(kind, params, x, cache, cfg, shared=None, spec=None,
                  mesh=None):
    if spec is None:
        spec = _no_specs(cache)
    if kind in ("dense_block", "local_only"):
        w = cfg.sliding_window if kind == "local_only" else 0
        return _dense_block_decode(params, x, cache, cfg, window=w,
                                   spec=spec, mesh=mesh)
    if kind == "moe_block":
        return _moe_block_decode(params, x, cache, cfg, spec, mesh)
    if kind == "local_global":
        lc = []
        for p, c, s in zip(params.locals, cache["locals"], spec["locals"]):
            x, c = _dense_block_decode(p, x, c, cfg, window=cfg.sliding_window,
                                       spec=s, mesh=mesh)
            lc.append(c)
        x, gc = _dense_block_decode(params.global_, x, cache["global"], cfg,
                                    spec=spec["global"], mesh=mesh)
        return x, {"locals": lc, "global": gc}
    if kind == "mamba_hybrid":
        mc = []
        for p, c, s in zip(params.mambas, cache["mambas"], spec["mambas"]):
            h = rms_norm(x, p.ln.scale, cfg.norm_eps)
            y, c = _recurrent(lambda st, p=p, h=h: mamba_decode(
                p.mixer, h, st, cfg), c, s, mesh)
            x = x + y
            mc.append(c)
        x, ac = _dense_block_decode(shared, x + _lora(params, x),
                                    cache["attn"], cfg, spec=spec["attn"],
                                    mesh=mesh)
        return x, {"mambas": mc, "attn": ac}
    if kind == "xlstm_super":
        mc = []
        for p, c, s in zip(params.mlstms, cache["mlstms"], spec["mlstms"]):
            h = rms_norm(x, p.ln.scale, cfg.norm_eps)
            y, c = _recurrent(lambda st, p=p, h=h: mlstm_decode(
                p.core, h, st, cfg), c, s, mesh)
            x = x + y
            mc.append(c)
        p = params.slstm
        h = rms_norm(x, p.ln.scale, cfg.norm_eps)
        y, sc = _recurrent(lambda st: slstm_decode(p.core, h, st, cfg),
                           cache["slstm"], spec["slstm"], mesh)
        return x + y, {"mlstms": mc, "slstm": sc}
    raise ValueError(kind)


def decoder_decode(params: Decoder, cfg: ModelConfig, cache, token=None,
                   embedding=None, unroll: bool = False):
    """One-token decode step -> (logits (B,1,V), new_cache).  A KV cache's
    tensors are written in place and its length advances in the new
    cache; the recurrent states are new tensors.  Given a
    ``ShardedCache`` (this rank's slices, under a model axis: the sharded
    serving step's working module) the step runs on them (module
    docstring) and returns a new ``ShardedCache``; the embedding and the
    tied logits are vocab-parallel where the model axis splits the
    vocabulary, so the logits are this rank's ``(B, 1, V / tp)``."""
    sharded = isinstance(cache, ShardedCache)
    tree, specs, mesh = ((cache.local, cache.specs, cache.mesh) if sharded
                         else (cache, _no_specs(cache), None))
    vocab = vocab_axis(params.embed.table, cfg.padded_vocab)
    if embedding is None:
        x = embed(params.embed.table, token, vocab).to(_dtype(cfg))
    else:
        x = embedding.to(_dtype(cfg))
    new_segs = []
    for (kind, _, _), seg, seg_cache, seg_spec in zip(
            segments_for(cfg), params.segments, tree, specs):
        new_cache = []
        for p, c, s in zip(seg, seg_cache, seg_spec):
            x, c = _decode_super(kind, p, x, c, cfg, params.shared, s, mesh)
            new_cache.append(c)
        new_segs.append(new_cache)
    x = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = unembed(params.embed.table, x, vocab)
    return logits, cache.like(new_segs) if sharded else new_segs
