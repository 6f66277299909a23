"""Decoder-stack assembly: the dense decoder families.

The port of ``repro.models.transformer``.  Layer stacks are grouped into
*segments* of identical repeating "super-blocks", as in the reference::

    gemma3-1b   [(5 local + 1 global) x 4, local x 2]
    dense       [block x L]

The reference scans stacked params with ``lax.scan``; here a
:class:`Decoder` module holds each segment as a list of super-blocks and
loops over them in the reference's layer order (``unroll=`` and
``remat=`` are accepted and change no result).  Decode threads a cache
per super-block through the same loop; a windowed layer's cache is a ring
of ``min(max_len, window)`` slots.

The MoE, Mamba2-hybrid and xLSTM super-blocks (``moe_block``,
``mamba_hybrid``, ``xlstm_super``) are not ported yet and raise
``NotImplementedError`` (ROADMAP.md, queue 1).
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from .attention import (
    Attention,
    KVCache,
    attention,
    decode_attention,
    init_cache,
)
from .layers import MLP, Embedding, RMSNorm, embed, rms_norm, unembed

__all__ = ["segments_for", "Decoder", "DenseBlock", "LocalGlobal",
           "init_decoder", "decoder_apply", "decoder_decode",
           "init_decoder_cache"]


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"super-block {kind!r} is not ported to repro_torch yet (ROADMAP.md, "
        "queue 1: the MoE, Mamba2-hybrid, xLSTM and encoder-decoder "
        "families come in later slices)")


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

class DenseBlock(nn.Module):
    """Pre-norm attention + SwiGLU MLP, residual around each."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.ln1, self.attn, self.ln2, self.mlp):
            m.init_(gen)


class LocalGlobal(nn.Module):
    """gemma3's super-block: ``per - 1`` windowed blocks, then one global."""

    def __init__(self, cfg, per: int, device=None):
        super().__init__()
        self.locals = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(per - 1))
        self.global_ = DenseBlock(cfg, device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (*self.locals, self.global_):
            m.init_(gen)


def _make_super(kind: str, cfg, per: int, device) -> nn.Module:
    if kind in ("dense_block", "local_only"):
        return DenseBlock(cfg, device)
    if kind == "local_global":
        return LocalGlobal(cfg, per, device)
    raise _not_ported(kind)


def _dense_block(params: DenseBlock, x, positions, cfg, window: int = 0):
    h = x + attention(params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps),
                      positions, cfg, window=window)
    return h + params.mlp(rms_norm(h, params.ln2.scale, cfg.norm_eps))


def _dense_block_decode(params: DenseBlock, x, cache: KVCache, cfg,
                        window: int = 0):
    a, cache = decode_attention(
        params.attn, rms_norm(x, params.ln1.scale, cfg.norm_eps), cache, cfg,
        window=window)
    h = x + a
    return h + params.mlp(rms_norm(h, params.ln2.scale, cfg.norm_eps)), cache


def _apply_super(kind, params, x, positions, cfg):
    """Forward one super-block."""
    if kind in ("dense_block", "local_only"):
        w = cfg.sliding_window if (
            kind == "local_only"
            or (kind == "dense_block" and cfg.sliding_window
                and not cfg.local_global_ratio)) else 0
        return _dense_block(params, x, positions, cfg, window=w)
    if kind == "local_global":
        for p in params.locals:
            x = _dense_block(p, x, positions, cfg, window=cfg.sliding_window)
        return _dense_block(params.global_, x, positions, cfg, window=0)
    raise _not_ported(kind)


# ---------------------------------------------------------------------------
# full decoder
# ---------------------------------------------------------------------------

class Decoder(nn.Module):
    """The decoder's parameters: ``embed`` (tied logits head), one list of
    super-blocks per segment of :func:`segments_for`, ``final_norm``.
    ``forward`` is :func:`decoder_apply` under the module's own config."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.encoder_decoder:
            raise _not_ported("encdec")
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device=device)
        self.segments = nn.ModuleList(
            nn.ModuleList(_make_super(kind, cfg, per, device)
                          for _ in range(n_iter))
            for kind, n_iter, per in segments_for(cfg))
        self.final_norm = RMSNorm(cfg.d_model, device=device)

    def init_(self, gen: torch.Generator) -> None:
        """Fill every weight from ``gen`` (He-normal kernels and tables,
        zero norm scales and biases), in layer order."""
        self.embed.init_(gen)
        for seg in self.segments:
            for sup in seg:
                sup.init_(gen)
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
    """Forward pass -> (logits (B,S,V), aux_loss)."""
    if embeddings is None:
        x = embed(params.embed.table, tokens).to(_dtype(cfg))
        B, S = tokens.shape
    else:
        x = embeddings.to(_dtype(cfg))
        B, S = embeddings.shape[:2]
    if positions is None:
        base = torch.arange(S, device=x.device)[None].expand(B, S)
        positions = (base[None].expand(3, B, S)
                     if cfg.mrope_sections is not None else base)
    for (kind, _, _), seg in zip(segments_for(cfg), params.segments):
        for p in seg:
            x = _apply_super(kind, p, x, positions, cfg)
    x = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = unembed(params.embed.table, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# -- decode -------------------------------------------------------------------

def _init_super_cache(kind, batch, max_len, cfg, per, dtype, device):
    if kind in ("dense_block", "local_only"):
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
    raise _not_ported(kind)


def init_decoder_cache(batch: int, max_len: int, cfg: ModelConfig,
                       dtype=torch.bfloat16, device="cuda") -> List[Any]:
    """One cache per super-block, per segment: a :class:`KVCache` for a
    block, ``{"locals": [...], "global": ...}`` for a local/global one."""
    device = resolve_device(device)
    return [[_init_super_cache(kind, batch, max_len, cfg, per, dtype, device)
             for _ in range(n_iter)]
            for kind, n_iter, per in segments_for(cfg)]


def _decode_super(kind, params, x, cache, cfg):
    if kind in ("dense_block", "local_only"):
        w = cfg.sliding_window if kind == "local_only" else 0
        return _dense_block_decode(params, x, cache, cfg, window=w)
    if kind == "local_global":
        lc = []
        for p, c in zip(params.locals, cache["locals"]):
            x, c = _dense_block_decode(p, x, c, cfg, window=cfg.sliding_window)
            lc.append(c)
        x, gc = _dense_block_decode(params.global_, x, cache["global"], cfg)
        return x, {"locals": lc, "global": gc}
    raise _not_ported(kind)


def decoder_decode(params: Decoder, cfg: ModelConfig, cache, token=None,
                   embedding=None, unroll: bool = False):
    """One-token decode step -> (logits (B,1,V), new_cache).  The cache's
    tensors are written in place; the lengths advance in the new cache."""
    if embedding is None:
        x = embed(params.embed.table, token).to(_dtype(cfg))
    else:
        x = embedding.to(_dtype(cfg))
    new_segs = []
    for (kind, _, _), seg, seg_cache in zip(segments_for(cfg),
                                            params.segments, cache):
        new_cache = []
        for p, c in zip(seg, seg_cache):
            x, c = _decode_super(kind, p, x, c, cfg)
            new_cache.append(c)
        new_segs.append(new_cache)
    x = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    logits = unembed(params.embed.table, x)
    return logits, new_segs
