"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, strictly recurrent) — Beck et al., arXiv:2405.04517.

The port of ``repro.models.xlstm``.  mLSTM is linear attention with
data-dependent exponential gating:

    C_t = f_t C_{t-1} + i_t (v_t k_t^T);   n_t = f_t n_{t-1} + i_t k_t
    y_t = (C_t q_t) / max(|n_t . q_t|, 1)

Its full-sequence form (:func:`mlstm_apply`) runs the SSD scan of
:mod:`.ssm` on each head on its own (the reference ``vmap``s over heads;
here the heads are folded into the scan's batch axis), with the
normaliser riding along as a constant-1 channel appended to v.  Its
decode (:func:`mlstm_decode`) carries the gate stabiliser ``m``, which
the full-sequence form has not: the two disagree in the reference, and
each is held against its own counterpart.  sLSTM has no parallel form:
:func:`slstm_apply` is a loop over time, as the reference's ``lax.scan``.
``h`` is carried in the activations' dtype (f32 in a decode cache), ``c,
n, m`` in f32.

Under a model axis (``distributed.tp``: the sharded train step and the
mesh prefill) each full-sequence form runs this rank's ``H / tp`` heads
where they divide it.  mLSTM: ``wq``, ``wk``, ``wv``, ``wz`` and
``w_gates`` (laid out ``(H, 2)``, so a contiguous shard holds whole
heads' gates) column-parallel, the norm over the ranks' parts, ``wo``
row-parallel.  sLSTM: ``wx`` and its bias are whole and the rank selects
its heads' columns of each of the ``z|i|f|o`` blocks
(:func:`slstm_wx_spans`), and its heads' blocks of ``r``
(:func:`slstm_r_spans`); the recurrence is block-diagonal by head, so
the loop over time runs no collective.  The decodes compute whole.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..distributed import tp as _tp
from .layers import Dense, RMSNorm, _he, cast, dense, rms_norm
from .ssm import ssd_chunked

__all__ = [
    "MLstm",
    "MLstmCache",
    "SLstm",
    "SLstmCache",
    "init_mlstm_cache",
    "init_slstm_cache",
    "mlstm_apply",
    "mlstm_decode",
    "slstm_apply",
    "slstm_decode",
    "slstm_r_spans",
    "slstm_wx_spans",
]


def _log_sigmoid(x):
    return -F.softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLstmCache(NamedTuple):
    C: torch.Tensor    # (B, H, P+1, K) matrix memory (+normaliser row)
    m: torch.Tensor    # (B, H) gate stabiliser (running max of log gates)


class MLstm(nn.Module):
    """``wq``, ``wk``, ``wv``, ``w_gates`` (i, f a head, with bias), the
    output-gate branch ``wz``, ``norm`` and ``wo``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
        self.wq = Dense(d, H * hd, device=device)
        self.wk = Dense(d, H * hd, device=device)
        self.wv = Dense(d, H * hd, device=device)
        self.w_gates = Dense(d, 2 * H, bias=True, device=device)
        self.wz = Dense(d, H * hd, device=device)
        self.norm = RMSNorm(H * hd, device=device)
        self.wo = Dense(H * hd, d, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.w_gates, self.wz,
                  self.norm, self.wo):
            m.init_(gen)


def _mlstm_qkv(params: MLstm, x, cfg, H=None):
    """q, k, v and the log gates of ``H`` heads (all of them by default;
    under a model axis this rank's, from its columns)."""
    B, L, _ = x.shape
    H, hd = H or cfg.n_heads, cfg.head_dim_
    # the reference's jnp.sqrt(hd): f32, then the activations' dtype
    root = float(torch.tensor(math.sqrt(hd), dtype=torch.float32)
                 .to(x.dtype))
    q = params.wq(x).reshape(B, L, H, hd)
    k = params.wk(x).reshape(B, L, H, hd) / root
    v = params.wv(x).reshape(B, L, H, hd)
    gates = params.w_gates(x).reshape(B, L, H, 2).float()
    log_i = _log_sigmoid(gates[..., 0])
    log_f = _log_sigmoid(gates[..., 1])
    return q, k, v, log_i, log_f


def _per_head_scan(xs, log_f, k, q):
    """``ssd_chunked`` on each head on its own (the reference ``vmap``s it
    over the head axis): xs (B, L, H, P), log_f (B, L, H), k and q (B, L,
    H, N), the heads folded into the scan's batch axis; -> (B, L, H, P)."""
    B, L, H = log_f.shape

    def heads_first(t):                       # (B, L, H, ...) -> (B*H, L, ...)
        return t.transpose(1, 2).reshape(B * H, L, *t.shape[3:])

    y, _ = ssd_chunked(heads_first(xs)[:, :, None],
                       heads_first(log_f)[..., None],
                       heads_first(k), heads_first(q))
    return y[:, :, 0].reshape(B, H, L, -1).transpose(1, 2)


def _mlstm_local(params: MLstm, cfg, axis) -> int:
    """This rank's head count, after checking that the mLSTM's leaves are
    its model shards (module docstring)."""
    H, hd = cfg.n_heads, cfg.head_dim_
    for t, dim, whole, what in (
            (params.wq.kernel, 1, H * hd, "wq"),
            (params.wk.kernel, 1, H * hd, "wk"),
            (params.wv.kernel, 1, H * hd, "wv"),
            (params.wz.kernel, 1, H * hd, "wz"),
            (params.w_gates.kernel, 1, 2 * H, "w_gates"),
            (params.w_gates.bias, 0, 2 * H, "w_gates bias"),
            (params.norm.scale, 0, H * hd, "norm"),
            (params.wo.kernel, 0, H * hd, "wo")):
        _tp.check_local(t, dim, whole, axis, f"mlstm {what}")
    return axis.part(H)


def mlstm_apply(params: MLstm, x, cfg, axis=None):
    """Full-sequence mLSTM via the SSD chunked scan (per-head decays).
    With a model ``axis`` this rank runs its ``H / tp`` heads (module
    docstring): ``x`` enters by ``copy``, the output leaves by
    ``reduce``."""
    B, L, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim_
    if axis is not None:
        H = _mlstm_local(params, cfg, axis)
        x = _tp.copy(x, axis)
    q, k, v, log_i, log_f = _mlstm_qkv(params, x, cfg, H)
    # augment v with ones so the normaliser n rides along as channel hd
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    # input weighting: i_t enters multiplicatively (like dt in SSD)
    xs = v_aug * torch.exp(log_i)[..., None].to(v.dtype)
    y = _per_head_scan(xs, log_f, k, q)                       # (B,L,H,hd+1)
    num, den = y[..., :-1], y[..., -1:]
    y = num / torch.clamp(den.abs(), min=1.0)
    z = params.wz(x)
    y = y.reshape(B, L, H * hd) * F.silu(z)
    if axis is None:
        y = rms_norm(y, params.norm.scale, cfg.norm_eps)
        return params.wo(y)
    y = _tp.rms_norm(y, params.norm.scale, cfg.norm_eps, axis)
    return _tp.reduce(params.wo(y), axis)


def init_mlstm_cache(batch: int, cfg, dtype=torch.float32,
                     device="cuda") -> MLstmCache:
    device = resolve_device(device)
    H, hd = cfg.n_heads, cfg.head_dim_
    return MLstmCache(
        C=torch.zeros((batch, H, hd + 1, hd), dtype=dtype, device=device),
        m=torch.full((batch, H), -1e9, dtype=dtype, device=device))


def mlstm_decode(params: MLstm, x, cache: MLstmCache,
                 cfg) -> Tuple[torch.Tensor, MLstmCache]:
    """One-token step with the stabilised exponential gating (xLSTM eq.
    15-18): x (B, 1, d) -> (y, new_cache)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    q, k, v, log_i, log_f = _mlstm_qkv(params, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]
    log_i, log_f = log_i[:, 0], log_f[:, 0]
    m_new = torch.maximum(log_f + cache.m, log_i)
    f_eff = torch.exp(log_f + cache.m - m_new)
    i_eff = torch.exp(log_i - m_new)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    C = cache.C * f_eff[..., None, None].to(cache.C.dtype) + (
        i_eff[..., None, None].to(v.dtype) * v_aug[..., None]
        * k[..., None, :]).to(cache.C.dtype)
    y = torch.matmul(C.to(q.dtype), q[..., None])[..., 0]        # (B,H,P+1)
    num, den = y[..., :-1], y[..., -1]
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    z = params.wz(x)[:, 0]
    y = y.reshape(B, H * hd) * F.silu(z)
    y = rms_norm(y, params.norm.scale, cfg.norm_eps)
    out = params.wo(y)[:, None, :]
    return out, MLstmCache(C=C, m=m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class SLstmCache(NamedTuple):
    c: torch.Tensor    # (B, d)
    n: torch.Tensor    # (B, d)
    h: torch.Tensor    # (B, d)
    m: torch.Tensor    # (B, d) stabiliser


class SLstm(nn.Module):
    """``wx`` (x to the z, i, f, o pre-activations, with bias), the
    block-diagonal recurrent weights ``r`` ``(H, hb, 4 hb)``, ``norm`` and
    ``wo``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        hb = d // H
        self.wx = Dense(d, 4 * d, bias=True, device=device)
        self.r = nn.Parameter(torch.empty(H, hb, 4 * hb, device=device))
        self.norm = RMSNorm(d, device=device)
        self.wo = Dense(d, d, device=device)

    def init_(self, gen: torch.Generator) -> None:
        self.wx.init_(gen)
        _he(gen, self.r, self.r.shape[1])
        self.norm.init_(gen)
        self.wo.init_(gen)


def slstm_wx_spans(cfg, index: int, size: int):
    """The column spans of ``wx`` (and its bias), the reference's ``z|i|f|o``
    blocks of ``d`` each, that model rank ``index`` of ``size`` computes
    with: its heads' channels of each block, in block order."""
    d = cfg.d_model
    c = d // size
    return tuple((g * d + index * c, c) for g in range(4))


def slstm_r_spans(cfg, index: int, size: int):
    """The span of ``r``'s head dimension that model rank ``index`` of
    ``size`` computes with: its heads' recurrent blocks."""
    h = cfg.n_heads // size
    return ((index * h, h),)


def _slstm_step(r, carry, xw):
    """One step of the heads of the recurrent blocks ``r`` ``(H, hb, 4
    hb)``: the carry and ``xw`` hold those heads' channels (all of them,
    or under a model axis this rank's)."""
    c, n, h, m = carry
    B = c.shape[0]
    H, hb = r.shape[0], r.shape[1]
    d = H * hb
    hr = h.reshape(B, H, hb).transpose(0, 1)                     # (H,B,hb)
    rec = torch.bmm(hr, cast(r, h.dtype)).transpose(0, 1)        # (B,H,4hb)
    # re-lay (B,H,4,hb) -> z|i|f|o blocks of (B,d) to match wx's output
    rec = rec.reshape(B, H, 4, hb).transpose(1, 2).reshape(B, 4 * d)
    zifo = (xw + rec.to(xw.dtype)).float()
    z, i_raw, f_raw, o_raw = zifo.chunk(4, dim=-1)
    log_i = _log_sigmoid(i_raw)
    log_f = _log_sigmoid(f_raw)
    m_new = torch.maximum(log_f + m, log_i)
    i_eff = torch.exp(log_i - m_new)
    f_eff = torch.exp(log_f + m - m_new)
    c_new = f_eff * c + i_eff * torch.tanh(z)
    n_new = f_eff * n + i_eff
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new.to(h.dtype), m_new), h_new


def _slstm_local(params: SLstm, cfg, axis):
    """``(wx kernel, wx bias, r)`` of this rank's heads: its columns of the
    whole ``wx`` and blocks of the whole ``r``, after checking that the
    norm's gain and ``wo`` are its model shards."""
    d, H = cfg.d_model, cfg.n_heads
    _tp.check_local(params.norm.scale, 0, d, axis, "slstm norm")
    _tp.check_local(params.wo.kernel, 0, d, axis, "slstm wo")
    spans = slstm_wx_spans(cfg, axis.index, axis.size)
    return (_tp.select(params.wx.kernel, spans, 1, 4 * d, axis,
                       "slstm wx"),
            _tp.select(params.wx.bias, spans, 0, 4 * d, axis,
                       "slstm wx bias"),
            _tp.select(params.r, slstm_r_spans(cfg, axis.index, axis.size),
                       0, H, axis, "slstm r"))


def slstm_apply(params: SLstm, x, cfg, axis=None):
    """Strictly recurrent sLSTM over the sequence (a loop over time).  With
    a model ``axis`` this rank runs its heads (module docstring): ``x``
    enters by ``copy``, the output leaves by ``reduce``, and the loop
    runs no collective."""
    B, L, _ = x.shape
    if axis is None:
        wx, bx, r = params.wx.kernel, params.wx.bias, params.r
    else:
        x = _tp.copy(x, axis)
        wx, bx, r = _slstm_local(params, cfg, axis)
    d = r.shape[0] * r.shape[1]
    xw = dense(x, wx, bx).float()                                # (B, L, 4d)
    dev = x.device
    carry = (torch.zeros((B, d), device=dev),
             torch.zeros((B, d), device=dev),
             torch.zeros((B, d), dtype=x.dtype, device=dev),
             torch.full((B, d), -1e9, device=dev))
    hs = []
    for t in range(L):
        carry, h = _slstm_step(r, carry, xw[:, t])
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                       # (B, L, d)
    if axis is None:
        y = rms_norm(y, params.norm.scale, cfg.norm_eps)
        return params.wo(y)
    y = _tp.rms_norm(y, params.norm.scale, cfg.norm_eps, axis)
    return _tp.reduce(params.wo(y), axis)


def init_slstm_cache(batch: int, cfg, dtype=torch.float32,
                     device="cuda") -> SLstmCache:
    device = resolve_device(device)
    d = cfg.d_model
    return SLstmCache(
        c=torch.zeros((batch, d), device=device),
        n=torch.zeros((batch, d), device=device),
        h=torch.zeros((batch, d), dtype=dtype, device=device),
        m=torch.full((batch, d), -1e9, device=device))


def slstm_decode(params: SLstm, x, cache: SLstmCache,
                 cfg) -> Tuple[torch.Tensor, SLstmCache]:
    xw = params.wx(x)[:, 0].float()
    carry = (cache.c, cache.n, cache.h, cache.m)
    (c, n, h, m), h_out = _slstm_step(params.r, carry, xw)
    y = rms_norm(h_out.to(x.dtype), params.norm.scale, cfg.norm_eps)
    out = params.wo(y)[:, None, :]
    return out, SLstmCache(c=c, n=n, h=h.to(cache.h.dtype), m=m)
