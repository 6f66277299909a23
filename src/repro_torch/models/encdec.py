"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port of ``repro.models.encdec``.  As in the reference, the conv frame
frontend is a stub: the encoder takes precomputed frame embeddings
``(B, S_enc, d_model)``.  The encoder is a bidirectional transformer
(RoPE on positions ``arange(S_enc)``); each decoder layer adds a
cross-attention over the encoder memory (no RoPE, no bias).  Decode keeps
(a) one self-attention :class:`KVCache` per decoder layer and (b) the
projected memory keys and values of every layer, computed once by
:func:`encdec_prefill_memory`.

Parameters are an :class:`EncDec` module whose names are the reference
tree's keys (``enc_blocks.<i>.attn.wq.kernel``,
``dec_blocks.<i>.cross.wk.kernel``, ...), so ``params_from_jax`` loads
``init_encdec``'s tree by name.  The reference scans its stacked layers;
here they are a list looped over in order (``unroll=`` is accepted and
changes no result).  With ``remat`` and grad enabled each encoder block
and each decoder block (self-attention, cross-attention over the memory,
MLP) runs through ``models.remat.remat_call`` under
``cfg.remat_policy``, as the reference checkpoints its encoder and
decoder bodies; in the sharded train step each block gathers its own
weights inside that call (``distributed.fsdp``).

On a mesh (``distributed.sharding.ShardedCache``, the sharded serving
steps) :func:`encdec_prefill_memory` runs the encoder split over the
current model axis and keeps this rank's slice of each layer's memory
keys and values as the cache's spec lays them out, and
:func:`encdec_decode` runs the self- and cross-attention on this rank's
slices (``attention.decode_attention``, ``attention.cross_decode``).
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..distributed import fsdp as _fsdp
from ..distributed import tp as _tp
from ..distributed.sharding import ShardedCache, local_slice
from . import attention as _attn
from .remat import remat_call
from .attention import (
    Attention,
    KVCache,
    attention,
    cross_attention,
    cross_decode,
    decode_attention,
    init_cache,
)
from .layers import (MLP, Dense, Embedding, RMSNorm, dense, embed,
                     mlp_apply, rms_norm, unembed, vocab_axis)
from .transformer import DenseBlock, _dense_block, _dtype

__all__ = ["EncDec", "EncDecCache", "init_encdec", "encdec_apply",
           "encdec_encode", "encdec_decode", "init_encdec_cache",
           "encdec_prefill_memory", "dec_len_for"]


def dec_len_for(seq_len: int) -> int:
    """Decoder length for training shapes: seq/4 (frames >> tokens)."""
    return max(1, seq_len // 4)


class Cross(nn.Module):
    """The cross-attention's ``wq``, ``wk``, ``wv``, ``wo``: no bias,
    whatever ``cfg.qkv_bias`` says."""

    def __init__(self, cfg, device=None):
        super().__init__()
        hd = cfg.head_dim_
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, device=device)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd, device=device)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd, device=device)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init_(gen)


class DecBlock(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the memory and
    SwiGLU MLP, residual around each."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device=device)
        self.self_attn = Attention(cfg, device=device)
        self.ln_x = RMSNorm(cfg.d_model, device=device)
        self.cross = Cross(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.ln1, self.self_attn, self.ln_x, self.cross, self.ln2,
                  self.mlp):
            m.init_(gen)


class EncDec(nn.Module):
    """The encoder-decoder's parameters: ``embed`` (tied logits head),
    ``enc_blocks`` (:class:`DenseBlock`), ``enc_norm``, ``dec_blocks``
    (:class:`DecBlock`), ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if not cfg.encoder_decoder:
            raise ValueError(f"{cfg.name} is decoder-only: its parameters "
                             "are a transformer.Decoder")
        self.cfg = cfg
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device=device)
        self.enc_blocks = nn.ModuleList(DenseBlock(cfg, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, device=device)
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device=device)

    def init_(self, gen: torch.Generator) -> None:
        """Fill every weight from ``gen`` (He-normal kernels and table, zero
        norm scales and biases), in layer order."""
        for m in (self.embed, *self.enc_blocks, self.enc_norm,
                  *self.dec_blocks, self.final_norm):
            m.init_(gen)


def init_encdec(gen, cfg: ModelConfig, device="cuda") -> EncDec:
    """An :class:`EncDec` on ``device`` initialised from ``gen`` (a
    ``torch.Generator`` on that device, or an int seed for one)."""
    device = resolve_device(device)
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device).manual_seed(int(gen))
    params = EncDec(cfg, device=device)
    params.init_(gen)
    return params


def _cross_kv(params: Cross, memory, cfg):
    B, T, _ = memory.shape
    hd = cfg.head_dim_
    k = params.wk(memory).reshape(B, T, cfg.n_kv_heads, hd)
    v = params.wv(memory).reshape(B, T, cfg.n_kv_heads, hd)
    return k, v


def _cross_attend(params: Cross, x, mem_k, mem_v, cfg):
    """x (B, S, d) against the memory's keys/values (B, T, KV, hd); the
    blocked path where the memory is past the threshold and S > 1."""
    B, S, _ = x.shape
    q = params.wq(x).reshape(B, S, cfg.n_heads, cfg.head_dim_)
    if mem_k.shape[1] > _attn._BLOCK_THRESHOLD and S > 1:
        out = _attn._sdpa_blocked(q, mem_k, mem_v, cfg, causal=False)
    else:
        out = _attn._sdpa(q, mem_k, mem_v, None, cfg)
    return params.wo(out.reshape(B, S, -1))


def _positions(B: int, S: int, device):
    return torch.arange(S, device=device)[None].expand(B, S)


def encdec_encode(params: EncDec, cfg: ModelConfig, frames,
                  remat: bool = True, unroll: bool = False):
    """frames (B, S_enc, d_model) -> encoder memory, in ``cfg.dtype``."""
    B, S, _ = frames.shape
    x = frames.to(_dtype(cfg))
    positions = _positions(B, S, x.device)
    for p in params.enc_blocks:
        if remat:
            x = remat_call(cfg, _enc_block, p, x, positions, cfg)
        else:
            x = _enc_block(p, x, positions, cfg)
    return rms_norm(x, _fsdp.gathered(params.enc_norm).scale, cfg.norm_eps)


def _enc_block(p, x, positions, cfg):
    return _dense_block(_fsdp.gathered(p), x, positions, cfg, causal=False)


def _dec_block(p, x, memory, positions, cfg):
    p = _fsdp.gathered(p)
    x = x + attention(p.self_attn, rms_norm(x, p.ln1.scale, cfg.norm_eps),
                      positions, cfg, causal=True)
    h = rms_norm(x, p.ln_x.scale, cfg.norm_eps)
    c = cross_attention(p.cross, h, memory, cfg)
    if c is None:
        mk, mv = _cross_kv(p.cross, memory, cfg)
        c = _cross_attend(p.cross, h, mk, mv, cfg)
    x = x + c
    return x + mlp_apply(p.mlp, rms_norm(x, p.ln2.scale, cfg.norm_eps),
                         cfg.d_ff)


def encdec_apply(params: EncDec, cfg: ModelConfig, frames, dec_tokens,
                 remat: bool = True, unroll: bool = False):
    """Training/prefill forward -> (logits (B, S_dec, V), aux 0).  Under a
    model axis (``distributed.tp``: the sharded steps) every block splits
    as the decoder's do, and the logits are this rank's ``V / tp`` of the
    padded vocabulary.  In the sharded train step the modules outside the
    blocks are gathered at their use, once each, and each block's inside
    its own call (``distributed.fsdp``)."""
    memory = encdec_encode(params, cfg, frames, remat=remat)
    B, S = dec_tokens.shape
    table = _fsdp.gathered(params.embed).table
    vocab = vocab_axis(table, cfg.padded_vocab)
    x = embed(table, dec_tokens, vocab).to(_dtype(cfg))
    positions = _positions(B, S, x.device)
    for p in params.dec_blocks:
        if remat:
            x = remat_call(cfg, _dec_block, p, x, memory, positions, cfg)
        else:
            x = _dec_block(p, x, memory, positions, cfg)
    x = rms_norm(x, _fsdp.gathered(params.final_norm).scale, cfg.norm_eps)
    logits = unembed(table, x, vocab)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


class EncDecCache(NamedTuple):
    self_kv: List[KVCache]   # one per decoder layer
    mem_k: torch.Tensor      # (L, B, T, KV, hd) projected encoder memory
    mem_v: torch.Tensor


def init_encdec_cache(batch: int, max_len: int, cfg: ModelConfig,
                      dtype=torch.bfloat16, mem_len: int | None = None,
                      device="cuda") -> EncDecCache:
    """Zero-filled caches: ``max_len`` self-attention slots a decoder
    layer, ``mem_len`` (``max_len`` when None) memory positions."""
    device = resolve_device(device)
    mem_len = mem_len or max_len
    shape = (cfg.n_layers, batch, mem_len, cfg.n_kv_heads, cfg.head_dim_)
    return EncDecCache(
        self_kv=[init_cache(batch, max_len, cfg, dtype, device)
                 for _ in range(cfg.n_layers)],
        mem_k=torch.zeros(shape, dtype=dtype, device=device),
        mem_v=torch.zeros(shape, dtype=dtype, device=device))


def _memory_spec(spec):
    """The per-layer spec of the stacked memory's ``spec``; raises where
    the rules shard its layer axis (a batch equal to the layer count, the
    reference's fault: ROADMAP.md §3)."""
    if spec[0]:
        raise ValueError(f"the cache's spec {spec} shards the memory's layer "
                         "axis")
    return spec[1:]


@torch.no_grad()
def encdec_prefill_memory(params: EncDec, cfg: ModelConfig, frames,
                          cache: EncDecCache) -> EncDecCache:
    """Run the encoder once (in ``cfg.dtype``) and stash each decoder
    layer's projected memory keys/values, cast to the cache's dtype after
    the projection, as the reference does.  With a ``ShardedCache``
    (``frames`` this rank's batch where the cache's spec splits the
    batch, under the current model axis) the encoder's blocks split over
    the model axis and each layer keeps this rank's slice of its keys
    and values; a new ``ShardedCache`` is returned."""
    memory = encdec_encode(params, cfg, frames, remat=False)
    B, T, _ = memory.shape
    if isinstance(cache, ShardedCache):
        return cache.like(_mesh_memory(params, cfg, memory, cache))
    shape = (cfg.n_layers, B, T, cfg.n_kv_heads, cfg.head_dim_)
    mk = torch.empty(shape, dtype=cache.mem_k.dtype, device=memory.device)
    mv = torch.empty(shape, dtype=cache.mem_v.dtype, device=memory.device)
    for i, p in enumerate(params.dec_blocks):
        k, v = _cross_kv(p.cross, memory, cfg)
        mk[i], mv[i] = k, v
    return cache._replace(mem_k=mk, mem_v=mv)


def _mesh_memory(params: EncDec, cfg, memory, cache: ShardedCache):
    """This rank's slices of every layer's memory keys and values: the
    cross ``wk`` / ``wv`` give this rank's KV heads where the model axis
    splits them (gathered where the spec keeps the heads whole), then the
    spec's block of positions."""
    B, T, _ = memory.shape
    spec = _memory_spec(cache.specs.mem_k)
    at = (None, spec[1], None, None)
    axis = _tp.current()
    ks, vs = [], []
    for p in params.dec_blocks:
        k = dense(memory, p.cross.wk.kernel).reshape(B, T, -1, cfg.head_dim_)
        v = dense(memory, p.cross.wv.kernel).reshape(B, T, -1, cfg.head_dim_)
        if not spec[2] and k.shape[2] != cfg.n_kv_heads:
            k, v = _tp.gather(k, axis, 2), _tp.gather(v, axis, 2)
        ks.append(local_slice(k, at, cache.mesh))
        vs.append(local_slice(v, at, cache.mesh))
    local = cache.local
    mk = torch.stack(ks).to(local.mem_k.dtype)
    mv = torch.stack(vs).to(local.mem_v.dtype)
    if mk.shape != local.mem_k.shape:
        raise ValueError(f"memory of {tuple(mk.shape)} against this rank's "
                         f"cache slice of {tuple(local.mem_k.shape)}")
    return local._replace(mem_k=mk, mem_v=mv)


def encdec_decode(params: EncDec, cfg: ModelConfig, cache: EncDecCache,
                  token, unroll: bool = False):
    """One decoder token step against the cached self-KV and encoder
    memory -> (logits (B, 1, V), new cache).  The self-attention caches
    are written in place; their lengths advance in the new cache.  Given
    a ``ShardedCache`` the step runs on this rank's slices (module
    docstring) and the logits are this rank's block of the vocabulary
    where the model axis splits it."""
    sharded = isinstance(cache, ShardedCache)
    tree, mesh = (cache.local, cache.mesh) if sharded else (cache, None)
    self_specs = cache.specs.self_kv if sharded else [None] * len(
        tree.self_kv)
    mem_spec = _memory_spec(cache.specs.mem_k) if sharded else (None,) * 4
    vocab = vocab_axis(params.embed.table, cfg.padded_vocab)
    x = embed(params.embed.table, token, vocab).to(_dtype(cfg))
    new_kv = []
    for i, (p, kv, s) in enumerate(zip(params.dec_blocks, tree.self_kv,
                                       self_specs)):
        a, kv = decode_attention(
            p.self_attn, rms_norm(x, p.ln1.scale, cfg.norm_eps), kv, cfg,
            spec=s, mesh=mesh)
        x = x + a
        h = rms_norm(x, p.ln_x.scale, cfg.norm_eps)
        x = x + cross_decode(p.cross, h, tree.mem_k[i], tree.mem_v[i], cfg,
                             mem_spec, mesh)
        x = x + mlp_apply(p.mlp, rms_norm(x, p.ln2.scale, cfg.norm_eps),
                          cfg.d_ff)
        new_kv.append(kv)
    x = rms_norm(x, params.final_norm.scale, cfg.norm_eps)
    tree = tree._replace(self_kv=new_kv)
    return (unembed(params.embed.table, x, vocab),
            cache.like(tree) if sharded else tree)
