"""GQA attention with RoPE/M-RoPE, sliding windows, and KV caches.

The port of ``repro.models.attention``.  Entry points:

  * :func:`attention`        — full-sequence (training / prefill), causal
                               or not, optional sliding window;
  * :func:`decode_attention` — one-step decode against a (batch, S, kv, hd)
                               cache;
  * :func:`init_cache`       — a zero-filled :class:`KVCache`.

Shapes: q (B, S, H, D); k/v (B, S, KV, D) with H % KV == 0 (GQA groups).
Scores and softmax in f32, masked with ``finfo(float32).min`` (not
``-inf``, so a fully masked row is uniform, as in the reference), the
probabilities cast to the dtype of the products.  Plain tensor ops: the
reference has no attention kernel, and these keep its rounding points.

Mixed dtypes promote as in JAX: a bf16 query against an f32 cache scores
in f32 (``torch.promote_types``), which is what the reference's serving
loop does with its f32 cache.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import tp as _tp
from ..distributed.sharding import attention_split
from .layers import Dense, dense, mrope, rope

__all__ = [
    "Attention",
    "attention",
    "cross_attention",
    "decode_attention",
    "init_cache",
    "KVCache",
]

_NEG = torch.finfo(torch.float32).min


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S_max, KV, D)
    v: torch.Tensor     # (B, S_max, KV, D)
    length: int         # tokens already cached (the same for every row)


class Attention(nn.Module):
    """The projections ``wq``, ``wk``, ``wv`` (bias with ``qkv_bias``) and
    ``wo``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        hd = cfg.head_dim_
        self.wq = Dense(cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias,
                        device=device)
        self.wk = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        device=device)
        self.wv = Dense(cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                        device=device)
        self.wo = Dense(cfg.n_heads * hd, cfg.d_model, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.init_(gen)


def _project_qkv(params: Attention, x, cfg):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    q = params.wq(x).reshape(B, S, cfg.n_heads, hd)
    k = params.wk(x).reshape(B, S, cfg.n_kv_heads, hd)
    v = params.wv(x).reshape(B, S, cfg.n_kv_heads, hd)
    return q, k, v


def _apply_rope(q, k, positions, cfg):
    if cfg.mrope_sections is not None:
        # positions: (3, B, S)
        q = mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k


def _sdpa(q, k, v, mask, cfg):
    """q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D); GQA via head grouping."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    dt = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, S, KV, G, D).to(dt)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(dt)).float()
    scores = scores / math.sqrt(D)
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(dt), v.to(dt))
    return out.reshape(B, S, H, D)


_BLOCK_Q = 1024
_BLOCK_KV = 1024
_BLOCK_THRESHOLD = 2048  # sequences beyond this use the blocked path


def _sdpa_blocked(q, k, v, cfg, causal: bool, window: int = 0,
                  q_offset=None):
    """Flash-style blocked attention: online softmax over KV chunks inside a
    loop over Q chunks — never materializes the (S, T) score matrix; live
    scores are capped at (B, H, BLOCK_Q, BLOCK_KV).  The queries sit at
    positions ``q_offset + arange(S)`` (default ``T - S``: a suffix)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    bq = min(_BLOCK_Q, S)
    bkv = min(_BLOCK_KV, T)
    nq, nkv = -(-S // bq), -(-T // bkv)
    pad_q, pad_kv = nq * bq - S, nkv * bkv - T
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_kv))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_kv))
    # causal alignment: prefill-style q suffixes, or this rank's part of the
    # query sequence
    q_off = T - S if q_offset is None else q_offset
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = qp[:, qi * bq:(qi + 1) * bq].reshape(B, bq, KV, G, D)
        qpos = qi * bq + torch.arange(bq, device=dev) + q_off    # (bq,)
        acc = torch.zeros((B, KV, G, bq, D), dtype=q.dtype, device=dev)
        m = torch.full((B, KV, G, bq), _NEG, device=dev)
        l = torch.zeros((B, KV, G, bq), device=dev)
        for kj in range(nkv):
            kblk = kp[:, kj * bkv:(kj + 1) * bkv]
            vblk = vp[:, kj * bkv:(kj + 1) * bkv]
            kpos = kj * bkv + torch.arange(bkv, device=dev)      # (bkv,)
            s = torch.einsum("bqkgd,btkd->bkgqt", qblk, kblk).float()
            s = s / math.sqrt(D)
            m_ok = (kpos[None, :] < T).expand(bq, bkv)           # kv padding
            if causal:
                m_ok = m_ok & (kpos[None, :] <= qpos[:, None])
            if window:
                m_ok = m_ok & (kpos[None, :] > qpos[:, None] - window)
            s = s.masked_fill(~m_ok, _NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * scale + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(qblk.dtype), vblk)
            acc = acc * scale[..., None].to(acc.dtype) + pv
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, bq, H, D))
    return torch.cat(outs, dim=1)[:, :S]


def _constrain_heads_or_seq(x, cfg, seq_axis: int = 1):
    """The reference's sharding constraint on attention activations (heads
    on the "model" axis where their count divides it, else the query
    sequence), as a split under a current model axis
    (``distributed.tp``): where the sequence splits
    (``sharding.attention_split``), this rank's block of ``x`` along
    ``seq_axis``, its gradient gathered back; else ``x``.  Where heads
    split, a rank's heads come from its columns of ``wq``
    (:func:`_split_attention`), so no activation is cut here."""
    axis = _tp.current()
    mode = attention_split(cfg, axis.size if axis else 1, x.shape[seq_axis])
    return _tp.scatter(x, axis, seq_axis) if mode == "seq" else x


def _causal_mask(S: int, T: int, window: int = 0, device=None,
                 q_offset=None):
    """(1,1,1,S,T) boolean mask; the queries at ``q_offset + arange(S)``,
    by default ``T - S``: T >= S, aligned at the end (prefill)."""
    off = T - S if q_offset is None else q_offset
    qi = torch.arange(S, device=device)[:, None] + off
    ki = torch.arange(T, device=device)[None, :]
    m = ki <= qi
    if window:
        m &= ki > qi - window
    return m[None, None, None]


def _local_kv(k, v, H: int, KV: int, axis):
    """The KV heads that this rank's ``H / tp`` query heads read, from all
    ``KV`` of them ((B, T, KV, D)), grouped so that ``_sdpa``'s GQA
    grouping pairs each query head with its own KV head."""
    n = H // axis.size
    a, G = axis.index * n, H // KV
    if n % G == 0:                      # whole groups
        return k[:, :, a // G:(a + n) // G], v[:, :, a // G:(a + n) // G]
    if G % n == 0:                      # inside one group
        j = a // G
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.arange(a, a + n, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]


def _weight(d: Dense, axis, whole: bool):
    """``d``'s kernel and bias; a whole weight that this rank uses for its
    part of the work only enters by ``copy`` (its gradient summed over
    the model ranks)."""
    if not whole:
        return d.kernel, d.bias
    return (_tp.copy(d.kernel, axis),
            None if d.bias is None else _tp.copy(d.bias, axis))


def _split_attention(params, x, positions, cfg, causal, window, axis, mode,
                     memory=None, blocked=False):
    """Attention split over the model ``axis``: by ``mode`` ``"heads"``
    (``wq`` column-parallel, ``wo`` row-parallel; K/V on this rank's KV
    heads where they divide the axis, else from the whole gathered ``wk``
    / ``wv`` and the KV heads its query heads read) or ``"seq"`` (this
    rank's block of the query sequence against the whole K/V, the weights
    whole).  ``memory`` (cross-attention) gives K/V instead of ``x``, and
    no RoPE."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    tp = axis.size
    T = (x if memory is None else memory).shape[1]
    if mode == "heads":
        xq = _tp.copy(x, axis)
        src = xq if memory is None else _tp.copy(memory, axis)
        wq, bq = _weight(params.wq, axis, False)
        _tp.check_local(wq, 1, H * hd, axis, "attention wq")
        q = dense(xq, wq, bq).reshape(B, S, H // tp, hd)
        kv_whole = KV % tp != 0
        wk, bk = _weight(params.wk, axis, kv_whole)
        wv, bv = _weight(params.wv, axis, kv_whole)
        if not kv_whole:
            _tp.check_local(wk, 1, KV * hd, axis, "attention wk")
        kvl = KV if kv_whole else KV // tp
        k = dense(src, wk, bk).reshape(B, T, kvl, hd)
        v = dense(src, wv, bv).reshape(B, T, kvl, hd)
        if kv_whole:
            k, v = _local_kv(k, v, H, KV, axis)
        q_pos, lo, Sq = positions, 0, S
    else:
        Sq = axis.part(S)
        lo = axis.index * Sq
        xq = _constrain_heads_or_seq(x, cfg)
        wq, bq = _weight(params.wq, axis, True)
        wk, bk = _weight(params.wk, axis, True)
        wv, bv = _weight(params.wv, axis, True)
        q = dense(xq, wq, bq).reshape(B, Sq, H, hd)
        kv_src = xq if memory is None else _tp.copy(memory, axis)
        k = dense(kv_src, wk, bk).reshape(B, kv_src.shape[1], KV, hd)
        v = dense(kv_src, wv, bv).reshape(B, kv_src.shape[1], KV, hd)
        q_pos = None if positions is None else positions[..., lo:lo + Sq]
    if memory is None:
        q, k = _apply_rope(q, k, q_pos, cfg)
        if mode == "seq":       # this rank's K/V block, gathered whole
            k = _tp.copy(_tp.gather(k, axis, 1), axis)
            v = _tp.copy(_tp.gather(v, axis, 1), axis)
    if blocked:
        out = _sdpa_blocked(q, k, v, cfg, causal=causal, window=window,
                            q_offset=lo + (T - S))
    else:
        mask = _causal_mask(Sq, T, window, x.device, lo + (T - S)) \
            if causal else None
        out = _sdpa(q, k, v, mask, cfg)
    wo, _ = _weight(params.wo, axis, mode == "seq")
    y = dense(out.reshape(B, Sq, -1), wo)
    if mode == "heads":
        return _tp.reduce(y, axis)
    return _tp.gather(y, axis, 1)


def attention(params: Attention, x, positions, cfg, causal: bool = True,
              window: int = 0) -> torch.Tensor:
    """Full-sequence attention (training / prefill); split over the current
    model axis (``distributed.tp``) by heads or the query sequence
    (:func:`_split_attention`) where ``sharding.attention_split`` says
    so."""
    B, S, _ = x.shape
    axis = _tp.current()
    mode = attention_split(cfg, axis.size if axis else 1, S)
    if mode is not None:
        return _split_attention(params, x, positions, cfg, causal, window,
                                axis, mode, blocked=S > _BLOCK_THRESHOLD)
    q, k, v = _project_qkv(params, x, cfg)
    q, k = _apply_rope(q, k, positions, cfg)
    if S > _BLOCK_THRESHOLD:
        out = _sdpa_blocked(q, k, v, cfg, causal=causal, window=window)
    else:
        mask = _causal_mask(S, S, window, x.device) if causal else None
        out = _sdpa(q, k, v, mask, cfg)
    return params.wo(out.reshape(B, S, -1))


def cross_attention(params, x, memory, cfg):
    """Cross-attention of ``x`` (B, S, d) over ``memory`` (B, T, d), no
    RoPE, split over the current model axis as :func:`attention` splits
    (the encoder-decoder's training forward); None where nothing splits,
    and the caller computes it whole."""
    S = x.shape[1]
    axis = _tp.current()
    mode = attention_split(cfg, axis.size if axis else 1, S)
    if mode is None:
        return None
    return _split_attention(params, x, None, cfg, False, 0, axis, mode,
                            memory=memory,
                            blocked=memory.shape[1] > _BLOCK_THRESHOLD
                            and S > 1)


def init_cache(batch: int, max_len: int, cfg, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    """Zero-filled :class:`KVCache` sized for ``batch`` sequences of up to
    ``max_len`` tokens under ``cfg``'s KV-head/head-dim layout."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    device = resolve_device(device)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def decode_attention(params: Attention, x, cache: KVCache, cfg,
                     window: int = 0):
    """One-token decode: x (B, 1, d); returns (y, new_cache).

    The cache holds ``length`` valid tokens; the new token is written at
    ``length`` (or at ``length % window`` ring position for windowed
    layers, which keeps the cache O(window) for gemma3-style local
    attention).  The cache's tensors are written in place.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError("decode_attention is one token at a time")
    q, k, v = _project_qkv(params, x, cfg)
    pos = torch.full((B, 1), cache.length, dtype=torch.int32,
                     device=x.device)
    if cfg.mrope_sections is not None:
        q, k = _apply_rope(q, k, pos[None].expand(3, B, 1), cfg)
    else:
        q, k = _apply_rope(q, k, pos, cfg)
    T = cache.k.shape[1]
    slot = cache.length % max(1, window) if window else cache.length
    cache.k[:, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[:, slot] = v[:, 0].to(cache.v.dtype)
    # valid-position mask: positions < length+1 (ring buffers are always
    # full once length >= window, and slots beyond are masked before that)
    ki = torch.arange(T, device=x.device)[None, None, None, None, :]
    valid = ki <= min(cache.length, T - 1)
    out = _sdpa(q, cache.k, cache.v, valid, cfg)
    y = params.wo(out.reshape(B, 1, -1))
    return y, KVCache(k=cache.k, v=cache.v, length=cache.length + 1)
