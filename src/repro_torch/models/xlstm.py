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
the loop over time runs no collective.

Where the axis is ``g`` times the heads (xlstm's 4 heads on tp = 8 or
16), the ``g`` ranks ``head * g ...`` of a head group run that head
(``tp.HeadGroup``).  mLSTM: each selects its head's columns of the
whole ``wq``, ``wk`` and ``w_gates`` (and bias) and computes ``q``,
``k``, the log gates and so the normaliser of its head, the same on
every rank of the group; ``v`` and ``z`` come from its own columns of
``wv`` and ``wz``, which the rules store as its part of its head's
channels (``hd / g``), so the scan runs on ``hd / g`` channels plus the
normaliser's ones channel (it is linear in ``v``); the norm over the
ranks' parts and the row-split ``wo`` take each channel once.  sLSTM:
each runs its head's recurrence whole (``r`` mixes a head's channels at
every step, so splitting it would take a collective a step), then
narrows ``h`` to its part of the head's channels before the norm and
its rows of ``wo``.  No head enters a sum over "model" more than once;
the gradient of a selected leaf sums the group's partial gradients
(``tp.select``), which by linearity is the whole one.  Held on 8 gloo
ranks by ``tests/test_torch_dist_head_group.py``,
``test_torch_dist_tp_xlstm.py`` and ``test_torch_dist_serve_recurrent.py``
on (1, 8), and on the card by ``chip_smoke.py`` phase 18 (xlstm-1.3b at
full width on (1, 8)).

The mesh decode (the serve step's working module: every leaf at its
stored model shard, ``sharding.compute_split(..., mixers=False)``) keeps
each state where ``cache_shardings`` stores it and computes each
projection on this rank's shard of its weight.  :func:`mlstm_decode`:
``C`` on ``K``, ``m`` on the heads where they divide the axis; a rank
multiplies by its columns of ``wq``, ``wk``, ``wv``, ``wz`` and
``w_gates`` and gathers the outputs with its slice of ``m`` in one call
(``(B, 4 H hd / tp + 2 H / tp + H / tp)``: ``C`` holds every head and
every row of ``v``, so ``v``, the gates and ``m`` are needed whole, and
``q`` and ``k`` on this rank's ``K`` slice), updates its ``K`` slice of
``C``, ``psum``-s the readout's partial sums ``(B, H, hd + 1)`` (the
readout is linear in ``C`` along ``K``), normalises the gated output
whole and multiplies its rows of ``wo``, whose partial products are
``psum``-ed.  :func:`slstm_decode`: ``c``, ``n``, ``h``, ``m`` on ``d``,
``r`` on each head's rows; a rank gathers the old ``h`` (``(B, d /
tp)``), multiplies its rows of ``r`` by its rows of each head's ``h``
and adds its columns of ``wx``'s output, ``psum``-s the ``z|i|f|o``
pre-activations ``(B, 4d)``, updates its channels, normalises them with
the sums of squares ``psum``-ed (``tp.rms_norm``) and multiplies its
rows of ``wo``, whose partial products are ``psum``-ed.  A leaf the
rules leave whole on "model" is used whole; a layout the decode does
not handle raises, naming the leaf.  No state and no weight crosses a
rank but ``m`` and the sLSTM's ``h``.
"""

from __future__ import annotations

import contextvars
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..distributed import tp as _tp
from .layers import (Dense, RMSNorm, _he, cast, dense, norm_dense,
                     rms_norm)
from .ssm import ssd_chunked

__all__ = [
    "MLstm",
    "MLstmCache",
    "NormaliserSides",
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


def _root(hd: int, dtype) -> float:
    """The reference's ``jnp.sqrt(hd)``: f32, then the activations'
    dtype."""
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32).to(dtype))


def _mlstm_qkv(params: MLstm, x, cfg, H=None, qk=None):
    """q, k, v and the log gates of ``H`` heads (all of them by default;
    under a model axis this rank's, from its columns of each leaf, or
    where it runs one head of a head group, q, k and the gates from
    ``qk``, that head's ``(wq, wk, w_gates, bias)``, and v from its part
    of the head's channels)."""
    B, L, _ = x.shape
    H, hd = H or cfg.n_heads, cfg.head_dim_
    wq, wk, wg, bg = qk or (params.wq.kernel, params.wk.kernel,
                            params.w_gates.kernel, params.w_gates.bias)
    q = dense(x, wq).reshape(B, L, H, hd)
    k = dense(x, wk).reshape(B, L, H, hd) / _root(hd, x.dtype)
    v = params.wv(x).reshape(B, L, H, -1)
    gates = dense(x, wg, bg).reshape(B, L, H, 2).float()
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


_SIDES = contextvars.ContextVar("mlstm_normaliser_sides", default=None)


class NormaliserSides:
    """Which side of its kink each full-sequence mLSTM readout takes, for
    a check that holds two computations of the same gradients together.

    ``num / max(|den|, 1)`` has a kink at ``|den| = 1``: the gradient
    through ``den`` is ``-num / den**2`` (with ``den``'s sign) on one side
    and 0 on the other.  Where ``den`` lies within rounding of 1, two
    computations of the same sums (f32 against f64, or f32 products in
    another order) may take different sides, and their gradients then
    differ by that jump, however closely each computes its sums.  Inside
    ``with NormaliserSides(...):`` every readout records ``|den| >= 1``
    in ``seen`` (a bool tensor on the host a layer, in the order of the
    forward pass) and, where ``pinned`` holds another run's ``seen`` of
    the same layers, takes those sides instead of its own.  In a sharded
    step on a ``("data", "model")`` ``mesh`` each readout sees a slice of
    the whole record: its data rank's sequences and, where the model
    axis splits the heads, its model rank's heads (its one head where the
    axis is a multiple of them: every rank of a head group records the
    same head, each from a scan of its own part of v's channels and the
    ones channel).  A recomputation
    (``models.remat``, which runs inside the backward pass) takes the
    side its forward took: that of the recorded layer whose ``|den|`` is
    nearest its own."""

    def __init__(self, pinned=None, mesh=None):
        self.pinned, self.mesh = pinned, mesh
        self.seen, self._mags = [], []

    def __enter__(self):
        self._token = _SIDES.set(self)
        return self

    def __exit__(self, *exc):
        _SIDES.reset(self._token)

    def side(self, den: torch.Tensor) -> torch.Tensor:
        """The side (``|den| >= 1``, on ``den``'s device) to take."""
        mag = den.detach().abs().cpu()
        if torch._C._current_autograd_node() is None:      # a forward pass
            i = len(self.seen)
            self._mags.append(mag)
            self.seen.append(mag >= 1)
        else:
            i = min((j for j, m in enumerate(self._mags)
                     if m.shape == mag.shape),
                    key=lambda j: float((self._mags[j] - mag).abs().max()))
        if self.pinned is None:
            return self.seen[i].to(den.device)
        side = self.pinned[i]
        if self.mesh is not None:
            b, h, n = den.shape[0], den.shape[2], side.shape[2]
            di = self.mesh.index("data")
            hi = 0 if h == n else _tp.heads_of(
                self.mesh.index("model"), self.mesh.axis_size("model"), n)[0]
            side = side[di * b:(di + 1) * b, :, hi:hi + h]
        return side.to(den.device)


def _normalise(num, den):
    """The mLSTM readout ``num / max(|den|, 1)``; under a
    :class:`NormaliserSides`, on the side of the kink it says."""
    sides = _SIDES.get()
    if sides is None:
        return num / torch.clamp(den.abs(), min=1.0)
    mag = den.abs()
    return num / torch.where(sides.side(den), mag, torch.ones_like(mag))


def _mlstm_local(params: MLstm, cfg, axis):
    """``(heads, qk)``: this rank's head count and, where it runs one head
    of a head group, that head's ``(wq, wk, w_gates, bias)`` selected from
    the whole leaves (None where it runs ``H / tp`` heads on its own
    columns), after checking that the other leaves are its model shards
    (module docstring)."""
    H, hd = cfg.n_heads, cfg.head_dim_
    heads = ((params.wq.kernel, 1, H * hd, "wq"),
             (params.wk.kernel, 1, H * hd, "wk"),
             (params.w_gates.kernel, 1, 2 * H, "w_gates"),
             (params.w_gates.bias, 0, 2 * H, "w_gates bias"))
    channels = ((params.wv.kernel, 1, H * hd, "wv"),
                (params.wz.kernel, 1, H * hd, "wz"),
                (params.norm.scale, 0, H * hd, "norm"),
                (params.wo.kernel, 0, H * hd, "wo"))
    if H % axis.size == 0:
        for t, dim, whole, what in heads + channels:
            _tp.check_local(t, dim, whole, axis, f"mlstm {what}")
        return axis.part(H), None
    group = axis.head_group(H)
    group.channels(hd, "mlstm")
    for t, dim, whole, what in channels:
        _tp.check_local(t, dim, whole, axis, f"mlstm {what}")
    cols, gates = ((group.head * hd, hd),), ((2 * group.head, 2),)
    return 1, tuple(
        _tp.select(t, spans, dim, whole, axis, f"mlstm {what}")
        for (t, dim, whole, what), spans in zip(heads, (cols, cols, gates,
                                                        gates)))


def mlstm_apply(params: MLstm, x, cfg, axis=None):
    """Full-sequence mLSTM via the SSD chunked scan (per-head decays).
    With a model ``axis`` this rank runs its ``H / tp`` heads, or its
    part of one head's v channels where the axis is a multiple of the
    heads (module docstring): ``x`` enters by ``copy``, the output
    leaves by ``reduce``."""
    B, L, _ = x.shape
    H, qk = cfg.n_heads, None
    if axis is not None:
        H, qk = _mlstm_local(params, cfg, axis)
        x = _tp.copy(x, axis)
    q, k, v, log_i, log_f = _mlstm_qkv(params, x, cfg, H, qk)
    # augment v with ones so the normaliser n rides along as the last
    # channel
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    # input weighting: i_t enters multiplicatively (like dt in SSD)
    xs = v_aug * torch.exp(log_i)[..., None].to(v.dtype)
    y = _per_head_scan(xs, log_f, k, q)                       # (B,L,H,P+1)
    y = _normalise(y[..., :-1], y[..., -1:])
    z = params.wz(x)
    y = y.reshape(B, L, -1) * F.silu(z)
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


def _mlstm_layout(params: MLstm, cfg, axis):
    """``{"qkvz", "gates", "norm"}``: whether ``wq`` / ``wk`` / ``wv`` /
    ``wz``, ``w_gates`` with its bias, and the norm's gain (with ``wo``'s
    rows) are this rank's model shards (all False with no ``axis``);
    raises for a layout the mesh decode does not handle, naming the
    leaf."""
    H, hd = cfg.n_heads, cfg.head_dim_
    split = dict(qkvz=_tp.is_split(params.wq.kernel, 1, H * hd, axis,
                                   "mlstm wq"),
                 gates=_tp.is_split(params.w_gates.kernel, 1, 2 * H, axis,
                                    "mlstm w_gates"),
                 norm=_tp.is_split(params.norm.scale, 0, H * hd, axis,
                                   "mlstm norm"))
    for t, dim, n, what, like in (
            (params.wk.kernel, 1, H * hd, "wk", "qkvz"),
            (params.wv.kernel, 1, H * hd, "wv", "qkvz"),
            (params.wz.kernel, 1, H * hd, "wz", "qkvz"),
            (params.w_gates.bias, 0, 2 * H, "w_gates bias", "gates")):
        if _tp.is_split(t, dim, n, axis, f"mlstm {what}") != split[like]:
            raise ValueError(f"mlstm {what}: {tuple(t.shape)} beside "
                             f"{'wq' if like == 'qkvz' else 'w_gates'} "
                             f"split {split[like]}")
    return split


def mlstm_decode(params: MLstm, x, cache: MLstmCache, cfg, axis=None,
                 spec=None) -> Tuple[torch.Tensor, MLstmCache]:
    """One-token step with the stabilised exponential gating (xLSTM eq.
    15-18): x (B, 1, d) -> (y, new_cache).  With a model ``axis``, the
    cache's ``spec`` (``cache_shardings``: ``C`` on ``K``, ``m`` on the
    heads where they divide the axis) and ``params`` as the serve step's
    working module holds them (each leaf this rank's model shard where
    the rules split it), ``cache`` holds this rank's slices and the new
    cache does too (module docstring); where nothing is split no
    collective runs and the step is the one-process step."""
    dims = _tp.state_dims(spec, axis, {"C": 3, "m": 1}, "mlstm")
    split = _mlstm_layout(params, cfg, axis)
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim_
    xs = x[:, 0]
    qkvz = [w(xs)                       # this rank's columns of each
            for w in (params.wq, params.wk, params.wv, params.wz)]
    gates = params.w_gates(xs)
    m = cache.m
    if dims["m"] is not None:           # every head's stabiliser
        _tp.check_local(m, 1, H, axis, "mlstm m")
    parts = (qkvz * split["qkvz"] + [gates] * split["gates"]
             + [m] * (dims["m"] is not None))
    if parts:                           # one call for all of them
        got = iter(_tp.gather_parts(parts, axis))
        qkvz = [next(got) for _ in qkvz] if split["qkvz"] else qkvz
        gates = next(got) if split["gates"] else gates
        m = next(got) if dims["m"] is not None else m
    q, k, v, z = qkvz
    q, v = q.reshape(B, H, hd), v.reshape(B, H, hd)
    k = k.reshape(B, H, hd) / _root(hd, x.dtype)
    gates = gates.reshape(B, H, 2).float()
    log_i, log_f = _log_sigmoid(gates[..., 0]), _log_sigmoid(gates[..., 1])
    m_new = torch.maximum(log_f + m, log_i)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(log_i - m_new)
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    qk = q
    if dims["C"] is not None:           # this rank's K slice of C
        _tp.check_local(cache.C, 3, hd, axis, "mlstm C")
        k, qk = _tp.scatter(k, axis, -1), _tp.scatter(q, axis, -1)
    C = cache.C * f_eff[..., None, None].to(cache.C.dtype) + (
        i_eff[..., None, None].to(v.dtype) * v_aug[..., None]
        * k[..., None, :]).to(cache.C.dtype)
    y = torch.matmul(C.to(q.dtype), qk[..., None])[..., 0]       # (B,H,P+1)
    if dims["C"] is not None:           # the readout's partial sums over K
        y = _tp.reduce(y, axis)
    num, den = y[..., :-1], y[..., -1]
    y = num / torch.clamp(den.abs(), min=1.0)[..., None]
    out = norm_dense(y.reshape(B, H * hd) * F.silu(z), params.norm,
                     params.wo, cfg.norm_eps, axis, what="mlstm")
    if dims["m"] is not None:
        m_new = _tp.scatter(m_new, axis, 1)
    return out[:, None, :], MLstmCache(C=C, m=m_new)


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
    hb = d // cfg.n_heads
    first, n = _tp.heads_of(index, size, cfg.n_heads)
    return tuple((g * d + first * hb, n * hb) for g in range(4))


def slstm_r_spans(cfg, index: int, size: int):
    """The span of ``r``'s head dimension that model rank ``index`` of
    ``size`` computes with: its heads' recurrent blocks."""
    return (_tp.heads_of(index, size, cfg.n_heads),)


def _slstm_rec(r, h):
    """The recurrent pre-activations ``h @ r`` of the heads of the blocks
    ``r`` ``(H, rows, 4 hb)`` from those heads' channels ``h`` ``(B, H
    rows)``, laid out as ``wx``'s ``z|i|f|o`` blocks: ``(B, 4 H hb)``.
    ``rows`` is ``hb``, or under the mesh decode this rank's rows of each
    block (the sums are then partial)."""
    B = h.shape[0]
    H, hb = r.shape[0], r.shape[2] // 4
    hr = h.reshape(B, H, r.shape[1]).transpose(0, 1)             # (H,B,rows)
    rec = torch.bmm(hr, cast(r, h.dtype)).transpose(0, 1)        # (B,H,4hb)
    # re-lay (B,H,4,hb) -> z|i|f|o blocks of (B,d) to match wx's output
    return rec.reshape(B, H, 4, hb).transpose(1, 2).reshape(B, 4 * H * hb)


def _slstm_cell(carry, zifo):
    """The cell update from the carry ``(c, n, h, m)`` and the f32
    ``z|i|f|o`` pre-activations of the same channels."""
    c, n, h, m = carry
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


def _slstm_step(r, carry, xw):
    """One step of the heads of the recurrent blocks ``r`` ``(H, hb, 4
    hb)``: the carry and ``xw`` hold those heads' channels (all of them,
    or under a model axis this rank's)."""
    rec = _slstm_rec(r, carry[2])
    return _slstm_cell(carry, (xw + rec.to(xw.dtype)).float())


def _slstm_local(params: SLstm, cfg, axis):
    """``(wx kernel, wx bias, r, part)`` of this rank's heads: its columns
    of the whole ``wx`` and blocks of the whole ``r``, after checking that
    the norm's gain and ``wo`` are its model shards; ``part``, the
    ``(start, length)`` of its channels of its head where it runs one head
    of a head group, else None."""
    d, H = cfg.d_model, cfg.n_heads
    _tp.check_local(params.norm.scale, 0, d, axis, "slstm norm")
    _tp.check_local(params.wo.kernel, 0, d, axis, "slstm wo")
    part = None if H % axis.size == 0 else axis.head_group(H).channels(
        d // H, "slstm")
    spans = slstm_wx_spans(cfg, axis.index, axis.size)
    return (_tp.select(params.wx.kernel, spans, 1, 4 * d, axis,
                       "slstm wx"),
            _tp.select(params.wx.bias, spans, 0, 4 * d, axis,
                       "slstm wx bias"),
            _tp.select(params.r, slstm_r_spans(cfg, axis.index, axis.size),
                       0, H, axis, "slstm r"),
            part)


def _slstm_loop(r, carry, xw):
    """The outputs ``h`` of the loop over the time axis of ``xw`` ``(B, L,
    4 H hb)``, the pre-activations of the heads of the recurrent blocks
    ``r`` ``(H, hb, 4 hb)``, from ``carry``."""
    hs = []
    for t in range(xw.shape[1]):
        carry, h = _slstm_step(r, carry, xw[:, t])
        hs.append(h)
    return hs


# the loop :func:`slstm_apply` runs (``launch.dryrun`` sets its own for
# the counted step)
_LOOP = contextvars.ContextVar("slstm_loop", default=_slstm_loop)


def slstm_apply(params: SLstm, x, cfg, axis=None):
    """Strictly recurrent sLSTM over the sequence (a loop over time).  With
    a model ``axis`` this rank runs its heads, or its head of a head group
    whole and keeps its part of the head's channels (module docstring):
    ``x`` enters by ``copy``, the output leaves by ``reduce``, and the
    loop runs no collective."""
    B = x.shape[0]
    part = None
    if axis is None:
        wx, bx, r = params.wx.kernel, params.wx.bias, params.r
    else:
        x = _tp.copy(x, axis)
        wx, bx, r, part = _slstm_local(params, cfg, axis)
    d = r.shape[0] * r.shape[1]
    xw = dense(x, wx, bx).float()                                # (B, L, 4d)
    dev = x.device
    carry = (torch.zeros((B, d), device=dev),
             torch.zeros((B, d), device=dev),
             torch.zeros((B, d), dtype=x.dtype, device=dev),
             torch.full((B, d), -1e9, device=dev))
    hs = _LOOP.get()(r, carry, xw)
    y = torch.stack(hs, dim=1).to(x.dtype)                       # (B, L, d)
    if axis is None:
        y = rms_norm(y, params.norm.scale, cfg.norm_eps)
        return params.wo(y)
    if part is not None:                # this rank's channels of its head
        y = y.narrow(-1, *part)
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


def _slstm_layout(params: SLstm, cfg, axis):
    """``{"wx", "r", "out"}``: whether ``wx`` with its bias (on its
    columns), ``r`` (on each head's rows) and the norm's gain with
    ``wo``'s rows are this rank's model shards (all False with no
    ``axis``); raises for a layout the mesh decode does not handle,
    naming the leaf."""
    d = cfg.d_model
    split = dict(wx=_tp.is_split(params.wx.kernel, 1, 4 * d, axis,
                                 "slstm wx"),
                 r=_tp.is_split(params.r, 1, d // cfg.n_heads, axis,
                                "slstm r"),
                 out=_tp.is_split(params.norm.scale, 0, d, axis,
                                  "slstm norm"))
    for t, n, what, like in ((params.wx.bias, 4 * d, "wx bias", "wx"),
                             (params.wo.kernel, d, "wo", "out")):
        if _tp.is_split(t, 0, n, axis, f"slstm {what}") != split[like]:
            raise ValueError(f"slstm {what}: {tuple(t.shape)} beside "
                             f"{like} split {split[like]}")
    return split


def slstm_decode(params: SLstm, x, cache: SLstmCache, cfg, axis=None,
                 spec=None) -> Tuple[torch.Tensor, SLstmCache]:
    """One-token step: x (B, 1, d) -> (y, new_cache).  With a model
    ``axis``, the cache's ``spec`` (``cache_shardings``: every state on
    ``d``) and ``params`` as the serve step's working module holds them
    (each leaf this rank's model shard where the rules split it),
    ``cache`` holds this rank's channels and the new cache does too
    (module docstring); where nothing is split no collective runs and
    the step is the one-process step."""
    dims = _tp.state_dims(spec, axis, dict.fromkeys(SLstmCache._fields, 1),
                          "slstm")
    if len(set(dims.values())) > 1:
        raise ValueError(f"slstm: c, n, h, m stored on different layouts: "
                         f"{spec}")
    split = _slstm_layout(params, cfg, axis)
    B, d, H = x.shape[0], cfg.d_model, cfg.n_heads
    h = cache.h
    if dims["c"] is not None:           # every channel's h
        _tp.check_local(cache.c, 1, d, axis, "slstm c")
        h = _tp.gather(h, axis, 1)
    hr = h.reshape(B, H, d // H)
    if split["r"]:                      # this rank's rows of each block
        hr = _tp.scatter(hr, axis, 2)
    xw = params.wx(x[:, 0]).float()
    rec = _slstm_rec(params.r, hr.reshape(B, -1)).to(xw.dtype)
    if split["r"] or split["wx"]:
        # one psum of the z|i|f|o pre-activations (B, 4d): r's rows'
        # partial sums (or rank 0's whole rec), with this rank's columns
        # of xw added in their place
        pre = rec if split["r"] or axis.index == 0 else torch.zeros_like(
            rec)
        if split["wx"]:
            c4 = xw.shape[1]
            pre.narrow(1, axis.index * c4, c4).add_(xw)
        pre = _tp.reduce(pre, axis)
        pre = pre if split["wx"] else xw + pre
    else:
        pre = xw + rec
    pre = pre.float()
    if dims["c"] is not None:           # this rank's channels of each block
        c = d // axis.size
        pre = pre.reshape(B, 4, d).narrow(2, axis.index * c, c).reshape(
            B, 4 * c)
    carry = (cache.c, cache.n, cache.h, cache.m)
    (c, n, h, m), h_out = _slstm_cell(carry, pre)
    h_out = h_out.to(x.dtype)
    if dims["c"] is not None and split["out"]:
        # the norm over the ranks' channels, wo's rows of them
        y = _tp.rms_norm(h_out, params.norm.scale, cfg.norm_eps, axis)
        out = _tp.reduce(params.wo(y), axis)
    else:
        if dims["c"] is not None:       # every channel's new h
            h_out = _tp.gather(h_out, axis, 1)
        out = norm_dense(h_out, params.norm, params.wo, cfg.norm_eps, axis,
                         what="slstm")
    return out[:, None, :], SLstmCache(c=c, n=n, h=h.to(cache.h.dtype), m=m)
