"""Mamba2 (SSD) blocks for the zamba2 hybrid.

The port of ``repro.models.ssm``.  Prefill uses the chunked
state-space-duality form (:func:`ssd_chunked`: quadratic only within a
chunk, linear across chunks), decode the O(1) recurrent update on a
carried ``(H, P, N)`` state (:func:`mamba_decode`).

The reference writes the chunked scan as multi-operand einsums; here each
is contracted pairwise, in an order whose intermediates are no larger
than the reference's own ``(b, h, c, q, q)`` decay matrix or the output,
so the ``(b, h, c, q, q)``-by-``p`` product is never built.  The SSM state
and the conv window of a decode cache are f32 whatever the activations'
dtype (the reference's ``init_mamba_cache`` default); ``dt``'s softplus
is in f32, and the decode output is cast back to the activation's dtype
before ``out_proj``.

Under a model axis (``distributed.tp``: the sharded train step and the
mesh prefill) :func:`mamba_apply` runs this rank's ``H / tp`` heads:
``A_log``, ``D``, ``dt_bias``, the norm's gain and ``out_proj``'s rows
are this rank's model shards (head-major), ``in_proj`` and ``conv`` are
whole and the rank selects its heads' columns of them
(:func:`in_proj_spans`, :func:`conv_spans`: its ``z``, ``x`` and ``dt``,
and ``B`` and ``C`` whole, which every head reads); the gated norm sums
its squares over the ranks and ``out_proj`` is row-parallel.

The mesh decode (the serve step's working module: every leaf at its
stored model shard, ``sharding.compute_split(..., mixers=False)``) keeps
each state where ``cache_shardings`` stores it, the state on ``N`` and
the conv window on its channels, and computes each projection on this
rank's shard of its weight.  :func:`mamba_decode` multiplies by its
columns of ``in_proj`` and gathers the output whole (one call of ``(B,
cols / tp)``: every rank needs every head's ``x`` and ``dt`` for its
``N`` slice of the state, and its channels of ``xBC`` and ``z``); runs
the conv on its channels of the window with its channels of ``conv``,
and its heads' ``dt`` and decay from its ``dt_bias`` and ``A_log``, and
gathers both in one call (``(B, ch / tp + 2 H / tp)``); updates its
``N`` slice of the state and ``psum``-s the readout's partial sums ``(B,
H, P)``, into which each rank adds ``x * D`` of its own heads; then
normalises the gated output, which every rank now holds whole, scales
its channels by its part of the gain and multiplies its rows of
``out_proj``, whose partial products ``(B, d)`` are ``psum``-ed: four
calls a layer, none of a weight or a state.  A leaf the rules leave
whole on "model" is used whole (its call, if any, drops out); a layout
the decode does not handle raises, naming the leaf.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..distributed import tp as _tp
from .layers import Dense, RMSNorm, cast, dense, norm_dense, rms_norm

__all__ = [
    "Mamba",
    "MambaCache",
    "conv_spans",
    "in_proj_spans",
    "init_mamba_cache",
    "mamba_apply",
    "mamba_decode",
    "ssd_chunked",
]

_CONV_K = 4
_CHUNK = 256


class MambaCache(NamedTuple):
    state: torch.Tensor     # (B, H, P, N) recurrent SSM state
    conv: torch.Tensor      # (B, CONV_K-1, conv_channels) rolling window


class Mamba(nn.Module):
    """``in_proj`` (to ``[z, x, B, C, dt]``), the depthwise causal ``conv``
    kernel ``(CONV_K, d_inner + 2N)``, ``A_log``, ``D``, ``dt_bias`` (one a
    head), the gated ``norm`` and ``out_proj``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, d_in = cfg.d_model, cfg.d_inner
        H, N = cfg.n_ssm_heads, cfg.ssm_state
        self.in_proj = Dense(d, 2 * d_in + 2 * N + H, device=device)
        self.conv = Dense(_CONV_K, d_in + 2 * N, device=device)
        self.A_log = nn.Parameter(torch.zeros(H, device=device))
        self.D = nn.Parameter(torch.ones(H, device=device))
        self.dt_bias = nn.Parameter(torch.full((H,), -2.0, device=device))
        self.norm = RMSNorm(d_in, device=device)
        self.out_proj = Dense(d_in, d, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.in_proj, self.conv, self.norm, self.out_proj):
            m.init_(gen)
        with torch.no_grad():
            self.A_log.zero_()
            self.D.fill_(1.0)
            self.dt_bias.fill_(-2.0)


def _segsum(a):
    """(..., q) log-decays -> (..., q, q) lower-triangular pairwise sums."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return d.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, a, B, C, init_state=None, chunk: int = _CHUNK):
    """State-space-duality scan.

    x: (b, l, h, p)   inputs (already dt-weighted)
    a: (b, l, h)      per-step log decay (<= 0)
    B: (b, l, n)      input projection (shared across heads, G=1)
    C: (b, l, n)      output projection
    returns y (b, l, h, p), final_state (b, h, p, n)

    ``l`` must be a multiple of ``min(chunk, l)``: the sequence is not
    padded (the reference asserts the same).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    chunk = min(chunk, l)
    if l % chunk:
        raise ValueError(f"sequence must divide the SSD chunk (l = {l}, "
                         f"chunk = {chunk})")
    c = l // chunk
    dt = x.dtype
    xr = x.reshape(b, c, chunk, h, p)
    ar = a.reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b,h,c,q)
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)

    a_cum = torch.cumsum(ar, dim=-1)                             # (b,h,c,q)
    # 1. intra-chunk (attention-like): (C B^T) * L, then times x
    L = torch.exp(_segsum(ar)).to(dt)                            # (b,h,c,q,s)
    CB = torch.matmul(Cr, Br.transpose(-1, -2))                  # (b,c,q,s)
    M = CB[:, :, None] * L.permute(0, 2, 1, 3, 4)                # (b,c,h,q,s)
    Y_diag = torch.matmul(M, xr.permute(0, 1, 3, 2, 4))          # (b,c,h,q,p)
    Y_diag = Y_diag.permute(0, 1, 3, 2, 4)                       # (b,c,q,h,p)
    # 2. per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).to(dt)     # (b,h,c,q)
    xd = xr * decay_states.permute(0, 2, 3, 1)[..., None]        # (b,c,q,h,p)
    states = torch.matmul(xd.reshape(b, c, chunk, h * p).transpose(-1, -2),
                          Br).reshape(b, c, h, p, n)
    # 3. inter-chunk recurrence (one segsum over chunk decays)
    if init_state is None:
        init_state = torch.zeros((b, h, p, n), dtype=dt, device=x.device)
    chunk_decay = a_cum[..., -1]                                 # (b,h,c)
    padded = F.pad(chunk_decay, (1, 0))
    decay_chunk = torch.exp(_segsum(padded)).to(dt)              # (b,h,z,c)
    states_all = torch.cat([init_state[:, None], states], dim=1)
    # (b,h,z,c) @ (b,h,c,p*n) -> (b,z,h,p,n)
    new_states = torch.matmul(
        decay_chunk,
        states_all.permute(0, 2, 1, 3, 4).reshape(b, h, c + 1, p * n))
    new_states = new_states.reshape(b, h, c + 1, p, n).permute(0, 2, 1, 3, 4)
    prev_states, final_state = new_states[:, :-1], new_states[:, -1]
    # 4. contribution of carried state to each position
    state_decay = torch.exp(a_cum).to(dt)                        # (b,h,c,q)
    CS = torch.matmul(Cr, prev_states.reshape(b, c, h * p, n)
                      .transpose(-1, -2)).reshape(b, c, chunk, h, p)
    Y_off = CS * state_decay.permute(0, 2, 3, 1)[..., None]
    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y, final_state


def in_proj_spans(cfg, index: int, size: int):
    """The ``(start, length)`` column spans of ``in_proj`` (the reference's
    ``[z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]``) that model rank
    ``index`` of ``size`` computes with: its heads' ``z`` and ``x``
    channels, ``B`` and ``C`` whole, its heads' ``dt``."""
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    c, h = d_in // size, H // size
    return ((index * c, c), (d_in + index * c, c), (2 * d_in, 2 * N),
            (2 * d_in + 2 * N + index * h, h))


def conv_spans(cfg, index: int, size: int):
    """The channel spans of ``conv`` (``[x | B | C]``) that model rank
    ``index`` of ``size`` computes with: its heads' ``x``, ``B`` and ``C``
    whole."""
    c = cfg.d_inner // size
    return ((index * c, c), (cfg.d_inner, 2 * cfg.ssm_state))


def _heads_of(params: Mamba, cfg, axis):
    """``(in_proj kernel, conv kernel, heads)`` that this rank computes
    with: the whole mixer's, or under a model ``axis`` its heads' columns
    of the whole packed kernels, after checking that the head-aligned
    leaves are its model shards."""
    H = cfg.n_ssm_heads
    if axis is None:
        return params.in_proj.kernel, params.conv.kernel, H
    d_in, N = cfg.d_inner, cfg.ssm_state
    for t, dim, whole, what in (
            (params.A_log, 0, H, "A_log"), (params.D, 0, H, "D"),
            (params.dt_bias, 0, H, "dt_bias"),
            (params.norm.scale, 0, d_in, "norm"),
            (params.out_proj.kernel, 0, d_in, "out_proj")):
        _tp.check_local(t, dim, whole, axis, f"mamba {what}")
    w_in = _tp.select(params.in_proj.kernel,
                      in_proj_spans(cfg, axis.index, axis.size), 1,
                      2 * d_in + 2 * N + H, axis, "mamba in_proj")
    k = _tp.select(params.conv.kernel, conv_spans(cfg, axis.index,
                                                  axis.size), 1,
                   d_in + 2 * N, axis, "mamba conv")
    return w_in, k, axis.part(H)


def mamba_apply(params: Mamba, u, cfg, axis=None):
    """Full-sequence Mamba2 mixer: u (B, L, d) -> (B, L, d).  With a model
    ``axis`` (``distributed.tp``) this rank runs its ``H / tp`` heads
    (module docstring): ``u`` enters by ``copy``, the output leaves by
    ``reduce``."""
    Bb, L, _ = u.shape
    if axis is not None:
        u = _tp.copy(u, axis)
    w_in, k, H = _heads_of(params, cfg, axis)
    N, d_in = cfg.ssm_state, H * cfg.ssm_head_dim
    zxbcdt = dense(u, w_in)
    z = zxbcdt[..., :d_in]
    xBC = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * N:]
    # causal depthwise conv over (x, B, C)
    k = cast(k, xBC.dtype)                                       # (K, ch)
    pad = F.pad(xBC, (0, 0, _CONV_K - 1, 0))
    conv = sum(pad[:, i:i + L] * k[i] for i in range(_CONV_K))
    conv = F.silu(conv)
    x = conv[..., :d_in].reshape(Bb, L, H, cfg.ssm_head_dim)
    Bm = conv[..., d_in:d_in + N]
    Cm = conv[..., d_in + N:]
    dt = F.softplus(dt_raw.float() + params.dt_bias)             # (B,L,H)
    A = -torch.exp(params.A_log)                                 # (H,) < 0
    a = dt * A                                                   # log decay
    y, _ = ssd_chunked(x * dt[..., None].to(x.dtype), a, Bm, Cm)
    y = y + x * params.D.to(x.dtype)[None, None, :, None]
    y = y.reshape(Bb, L, d_in)
    if axis is None:
        y = rms_norm(y * F.silu(z), params.norm.scale, cfg.norm_eps)
        return params.out_proj(y)
    y = _tp.rms_norm(y * F.silu(z), params.norm.scale, cfg.norm_eps, axis)
    return _tp.reduce(params.out_proj(y), axis)


def init_mamba_cache(batch: int, cfg, dtype=torch.float32,
                     device="cuda") -> MambaCache:
    """Zero state and conv window (f32 by default, as the reference's)."""
    device = resolve_device(device)
    H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_ch = cfg.d_inner + 2 * N
    return MambaCache(
        state=torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        conv=torch.zeros((batch, _CONV_K - 1, conv_ch), dtype=dtype,
                         device=device))


def _mamba_layout(params: Mamba, cfg, axis, dims):
    """``{"in_proj", "conv", "heads", "norm": split}``: which of the
    mixer's leaves are this rank's model shards (``A_log``, ``D`` and
    ``dt_bias`` together as ``heads``; the gain with ``out_proj``'s rows
    as ``norm``), all False with no ``axis``; raises for a layout the
    mesh decode does not handle, naming the leaf."""
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    split = dict(
        in_proj=_tp.is_split(params.in_proj.kernel, 1,  # [z|x|B|C|dt]
                             2 * d_in + 2 * N + H, axis, "mamba in_proj"),
        conv=_tp.is_split(params.conv.kernel, 1, d_in + 2 * N, axis,
                          "mamba conv"),
        heads=_tp.is_split(params.dt_bias, 0, H, axis, "mamba dt_bias"),
        norm=_tp.is_split(params.norm.scale, 0, d_in, axis, "mamba norm"))
    for t, what in ((params.A_log, "A_log"), (params.D, "D")):
        if _tp.is_split(t, 0, H, axis, f"mamba {what}") != split["heads"]:
            raise ValueError(f"mamba {what}: {tuple(t.shape)} beside a "
                             f"dt_bias of {tuple(params.dt_bias.shape)}")
    if split["conv"] and dims["conv"] is None:
        raise ValueError(f"mamba conv: a kernel of "
                         f"{tuple(params.conv.kernel.shape)} beside a window "
                         "whole on every model rank")
    if split["heads"] and dims["state"] is None:
        raise ValueError("mamba D: split by head beside a state that is "
                         "whole on every model rank")
    return split


def mamba_decode(params: Mamba, u, cache: MambaCache, cfg, axis=None,
                 spec=None) -> Tuple[torch.Tensor, MambaCache]:
    """One-token recurrent step: u (B, 1, d) -> (y, new_cache).  With a
    model ``axis``, the cache's ``spec`` (``cache_shardings``: the state
    on ``N``, the window on its channels) and ``params`` as the serve
    step's working module holds them (each leaf this rank's model shard
    where the rules split it), ``cache`` holds this rank's slices and the
    new cache does too (module docstring); where nothing is split no
    collective runs and the step is the one-process step."""
    dims = _tp.state_dims(spec, axis, {"state": 3, "conv": 2}, "mamba")
    split = _mamba_layout(params, cfg, axis, dims)
    Bb = u.shape[0]
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    ch = d_in + 2 * N
    zxbcdt = params.in_proj(u[:, 0])                    # this rank's columns
    if split["in_proj"]:
        zxbcdt, = _tp.gather_parts([zxbcdt], axis)
    z, xBC, dt_raw = (zxbcdt[:, :d_in], zxbcdt[:, d_in:d_in + ch],
                      zxbcdt[:, d_in + ch:])
    k = params.conv.kernel
    if dims["conv"] is not None:        # this rank's channels of the window
        _tp.check_local(cache.conv, 2, ch, axis, "mamba window")
        xBC = _tp.scatter(xBC, axis, -1)
        k = k if split["conv"] else _tp.scatter(k, axis, 1)
    window = torch.cat([cache.conv, xBC[:, None, :].to(cache.conv.dtype)],
                       dim=1)
    conv = F.silu((window * cast(k, window.dtype)[None]).sum(dim=1))
    if split["heads"]:                  # this rank's heads' dt and decay
        dt_raw = _tp.scatter(dt_raw, axis, -1)
    dt = F.softplus(dt_raw.float() + params.dt_bias)
    decay = torch.exp(dt * -torch.exp(params.A_log))
    window_split = dims["conv"] is not None
    parts = [conv] * window_split + [dt, decay] * split["heads"]
    if parts:                           # one call for all of them
        got = _tp.gather_parts(parts, axis)
        conv = got[0] if window_split else conv
        dt, decay = got[-2:] if split["heads"] else (dt, decay)
    x = conv[:, :d_in].reshape(Bb, H, cfg.ssm_head_dim)
    Bm = conv[:, d_in:d_in + N]
    Cm = conv[:, d_in + N:]
    if dims["state"] is not None:       # this rank's N slice of the state
        _tp.check_local(cache.state, 3, N, axis, "mamba state")
        Bm, Cm = _tp.scatter(Bm, axis, -1), _tp.scatter(Cm, axis, -1)
    upd = (dt[..., None].to(x.dtype) * x)[..., None] * Bm[:, None, None, :]
    state = (cache.state * decay[..., None, None].to(cache.state.dtype)
             + upd.to(cache.state.dtype))
    y = torch.matmul(state.to(x.dtype), Cm[:, None, :, None])[..., 0]
    if split["heads"]:                  # x * D of this rank's heads rides
        h = H // axis.size              # in the readout's sum
        y.narrow(1, axis.index * h, h).add_(
            x.narrow(1, axis.index * h, h)
            * params.D.to(x.dtype)[None, :, None])
    if dims["state"] is not None:       # the readout's partial sums over N
        y = _tp.reduce(y, axis)
    if not split["heads"]:
        y = y + x * params.D.to(x.dtype)[None, :, None]
    out = norm_dense(y.reshape(Bb, d_in) * F.silu(z), params.norm,
                     params.out_proj, cfg.norm_eps, axis, u.dtype, "mamba")
    return out[:, None, :], MambaCache(state=state, conv=window[:, 1:])
