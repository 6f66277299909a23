"""Shared neural layers: norms, MLPs, embeddings, RoPE/M-RoPE.

The port of ``repro.models.layers``.  Each layer is a plain function on
tensors (weights passed in) and, where it holds weights, an ``nn.Module``
that owns them as f32 parameters in the reference's layouts: a dense
kernel is ``(d_in, d_out)`` and applied as ``x @ kernel``, an embedding
table ``(vocab, d_model)``.  Norms, RoPE and softmax compute in f32 and
cast back to the activation's dtype; ``dense`` casts its kernel to the
activation's dtype (:func:`cast`, made once per weight and kept).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp as _tp

__all__ = [
    "cast",
    "rms_norm",
    "layer_norm",
    "dense",
    "mlp",
    "mlp_apply",
    "embed",
    "unembed",
    "vocab_axis",
    "rope",
    "mrope",
    "rope_freqs",
    "RMSNorm",
    "Dense",
    "MLP",
    "Embedding",
]


def _he(gen: torch.Generator, p: torch.Tensor, in_axis_size: int) -> None:
    """Fill ``p`` with N(0, 1) / sqrt(fan-in) drawn from ``gen``."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    with torch.no_grad():
        p.normal_(generator=gen).mul_(scale)


def cast(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``.  The cast copy of a weight is made once and kept
    on the tensor until the weight changes (its version counter or storage
    moves), so a decode step reads the bf16 weights, not the f32 ones and
    a fresh cast: f32 -> bf16 rounds the same once as on every call.
    Where autograd records (grad mode, ``p.requires_grad``) the cast is a
    fresh, differentiable one."""
    if p.dtype == dtype:
        return p
    if p.requires_grad and torch.is_grad_enabled():
        return p.to(dtype)
    key = (dtype, p._version, p.data_ptr())
    kept = getattr(p, "_repro_cast", None)
    if kept is None or kept[0] != key:
        kept = (key, p.detach().to(dtype))
        p._repro_cast = kept
    return kept[1]


# -- norms -------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    """RMS norm with the ``(1 + scale)`` gain, in f32, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


class RMSNorm(nn.Module):
    """The ``(1 + scale)`` gain of :func:`rms_norm`, zero at init."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, device=device))

    def init_(self, gen: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.zero_()


# -- dense -------------------------------------------------------------------

def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor] = None):
    y = x @ cast(kernel, x.dtype)
    if bias is not None:
        y = y + cast(bias, x.dtype)
    return y


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, d_out, device=device))
        self.bias = (nn.Parameter(torch.zeros(d_out, device=device))
                     if bias else None)

    def init_(self, gen: torch.Generator) -> None:
        _he(gen, self.kernel, self.kernel.shape[0])
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return dense(x, self.kernel, self.bias)


# -- gated MLP (SwiGLU) --------------------------------------------------------

def mlp(x, wi_gate, wi_up, wo, axis=None):
    """SwiGLU; with a model ``axis`` (``distributed.tp``) the kernels are
    this rank's columns of ``wi_gate`` / ``wi_up`` and rows of ``wo``, the
    input enters by ``copy`` and the output leaves by ``reduce``."""
    if axis is not None:
        x = _tp.copy(x, axis)
    g = dense(x, wi_gate)
    u = dense(x, wi_up)
    y = dense(F.silu(g) * u, wo)
    return y if axis is None else _tp.reduce(y, axis)


def mlp_apply(params: "MLP", x, d_ff: int):
    """``params`` (an :class:`MLP` of width ``d_ff``) on ``x``: split over
    the current model axis where ``d_ff`` divides it (the sharded steps
    hand it this rank's model shards), else whole."""
    axis = _tp.axis_for(d_ff)
    if axis is not None:
        _tp.check_local(params.wi_gate.kernel, 1, d_ff, axis, "mlp.wi_gate")
    return mlp(x, params.wi_gate.kernel, params.wi_up.kernel,
               params.wo.kernel, axis)


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, device=None):
        super().__init__()
        self.wi_gate = Dense(d_model, d_ff, device=device)
        self.wi_up = Dense(d_model, d_ff, device=device)
        self.wo = Dense(d_ff, d_model, device=device)

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.wi_gate, self.wi_up, self.wo):
            m.init_(gen)

    def forward(self, x):
        return mlp(x, self.wi_gate.kernel, self.wi_up.kernel, self.wo.kernel)


# -- embeddings ----------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, axis=None):
    """Rows of ``table`` for int32 or int64 ``tokens`` of any shape.
    ``F.embedding``, whose CUDA backward sums each row's gradients in a
    fixed order; ``index_select``'s backward is an ``index_add_`` with
    float atomics, which would make a train step differ from run to run.
    With a model ``axis`` (vocab-parallel), ``table`` is this rank's
    contiguous block of rows: a token outside it looks up zeros, and the
    ranks' rows are summed (``reduce``)."""
    if axis is None:
        return F.embedding(tokens, table)
    n = table.shape[0]
    local = tokens.long() - axis.index * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                       table)
    rows = torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return _tp.reduce(rows, axis)


def vocab_axis(table: torch.Tensor, vocab: int):
    """The current model axis where it splits the ``vocab`` rows of the
    embedding (vocab-parallel), after checking that ``table`` is this
    rank's block of them; None where nothing splits."""
    axis = _tp.axis_for(vocab)
    if axis is not None:
        _tp.check_local(table, 0, vocab, axis, "embed.table")
    return axis


def unembed(table: torch.Tensor, x: torch.Tensor, axis=None):
    """Tied or separate logits projection: x @ table^T.  With a model
    ``axis``, this rank's logits ``(..., V / tp)`` from its rows of
    ``table``."""
    if axis is not None:
        x = _tp.copy(x, axis)
    return x @ cast(table, x.dtype).T


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, device=None):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, device=device))

    def init_(self, gen: torch.Generator) -> None:
        _he(gen, self.table, self.table.shape[1])


# -- rotary position embedding ---------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x, sin, cos):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs  # (..., seq, half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    return _rotate(x.float(), sin, cos).to(x.dtype)


def mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
          sections: Tuple[int, int, int]):
    """Multimodal RoPE (qwen2-vl): head_dim halves split into (t, h, w)
    sections, each rotated with its own position stream.

    x: (..., seq, heads, head_dim); positions3: (3, ..., seq).
    """
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError("mrope sections must cover head_dim/2")
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    sec_id = torch.repeat_interleave(
        torch.arange(3, device=positions3.device),
        torch.tensor(sections, device=positions3.device))
    # pick the position stream per frequency slot
    pos = positions3.index_select(0, sec_id)  # (half, ..., seq)
    pos = pos.movedim(0, -1)  # (..., seq, half)
    ang = pos.float() * freqs
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    return _rotate(x.float(), sin, cos).to(x.dtype)
