"""Tensor-parallel operators on the "model" axis.

The reference's sharded ``train_step`` is jitted under the rules'
shardings, and GSPMD partitions each matmul whose weight the rules put
on "model".  The port writes that partition out (Megatron's form): an
activation the model ranks all hold (*replicated*: the residual stream,
the norms, the loss) enters a split region through :func:`copy` and
leaves it through :func:`reduce` or :func:`gather`, so that on every
model rank the gradient of a replicated tensor is whole and the same.

* :func:`copy`: identity forward, ``psum`` over "model" backward — at a
  column-parallel input, and on a weight that a rank uses for only its
  part of the work (a gathered ``wk`` / ``wv``, whose gradient is then
  summed over the model ranks);
* :func:`reduce`: ``psum`` forward, identity backward — at a
  row-parallel output;
* :func:`gather`: ``all_gather`` along a dimension forward, this rank's
  slice backward (the gradient of the gathered tensor is whole on every
  rank);
* :func:`scatter`: this rank's slice forward, ``all_gather`` backward;
* :func:`select`: this rank's parts of a whole weight (the Mamba2 and
  sLSTM mixers' packed projections, whose segments split by head one by
  one), entered by :func:`copy`;
* :func:`rms_norm`: the RMS norm of a tensor whose normalised dimension
  the model ranks split: the sum of squares ``psum``-ed over the axis,
  forward and backward, then each rank scales its own part.

:func:`split_model` makes a :class:`ModelAxis` current for the modules'
forward passes (``models.layers``, ``attention``, ``moe``, ``ssm``,
``xlstm``, ``transformer``, ``encdec``); with none current, or one of
size 1, they compute as before, bit for bit.  Every collective goes through
``compat`` with ``axis="model"``, so ``compat.STATS`` counts it apart
from the data axes' (``model:all_reduce``, ``model:all_gather``).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple, Optional

import torch

from . import compat

__all__ = ["ModelAxis", "split_model", "current", "axis_for", "check_local",
           "copy", "reduce", "gather", "scatter", "select", "rms_norm",
           "AXIS"]

AXIS = "model"


class ModelAxis(NamedTuple):
    """The "model" axis of a live mesh as this rank sees it: its ``size``,
    this rank's ``index`` on it and its process ``group``."""
    size: int
    index: int
    group: Any

    @classmethod
    def of(cls, mesh) -> "ModelAxis":
        return cls(mesh.axis_size(AXIS), mesh.index(AXIS), mesh.group(AXIS))

    def part(self, n: int) -> int:
        """This rank's share of ``n`` items split evenly (raises where ``n``
        does not divide)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} model "
                             "ranks")
        return n // self.size


_AXIS: contextvars.ContextVar = contextvars.ContextVar("model_axis",
                                                       default=None)


@contextlib.contextmanager
def split_model(axis: Optional[ModelAxis]):
    """Split the compute inside the block over ``axis`` (module
    docstring); an axis of size 1 or None splits nothing."""
    token = _AXIS.set(axis if axis is not None and axis.size > 1 else None)
    try:
        yield axis
    finally:
        _AXIS.reset(token)


def current() -> Optional[ModelAxis]:
    """The current model axis, or None where nothing is split."""
    return _AXIS.get()


def axis_for(n: int) -> Optional[ModelAxis]:
    """The current model axis where ``n`` items (heads, columns, vocabulary
    rows, experts) split evenly over it, else None."""
    axis = _AXIS.get()
    return axis if axis is not None and n % axis.size == 0 else None


def check_local(t: torch.Tensor, dim: int, whole: int, axis: ModelAxis,
                what: str) -> torch.Tensor:
    """``t``, after checking that it is a model shard of ``whole`` items
    along ``dim``: a module whose weights are not this rank's shards
    raises, never computes whole."""
    if t.shape[dim] * axis.size != whole:
        raise ValueError(f"{what}: {tuple(t.shape)} is not a model shard of "
                         f"{whole} along dimension {dim} over "
                         f"{axis.size} ranks")
    return t


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return compat.psum(g.contiguous(), ctx.group, axis=AXIS), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return compat.psum(x.contiguous(), group, axis=AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _slice(x, dim, axis: ModelAxis):
    n = axis.part(x.shape[dim])
    return x.narrow(dim, axis.index * n, n).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return compat.all_gather(x.contiguous(), axis.group, dim=dim,
                                 axis=AXIS)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.axis), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis = dim, axis
        return _slice(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return compat.all_gather(g.contiguous(), ctx.axis.group, dim=ctx.dim,
                                 axis=AXIS), None, None


def copy(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``x`` forward; the gradient ``psum``-ed over ``axis`` backward."""
    return _Copy.apply(x, axis.group)


def reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """``psum`` of ``x`` over ``axis`` forward; identity backward."""
    return _Reduce.apply(x, axis.group)


def gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """Every model rank's ``x`` concatenated along ``dim`` forward; this
    rank's slice of the gradient backward."""
    return _Gather.apply(x, dim % x.dim(), axis)


def scatter(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` forward; the gradient
    gathered over ``axis`` backward."""
    return _Scatter.apply(x, dim % x.dim(), axis)


def select(t: torch.Tensor, spans, dim: int, whole: int, axis: ModelAxis,
           what: str) -> torch.Tensor:
    """The ``(start, length)`` ``spans`` of the whole tensor ``t`` along
    ``dim``, concatenated in order: the parts of a weight that this rank
    computes with.  ``t`` enters by :func:`copy`, so its gradient (this
    rank's parts, zero elsewhere) is summed over the model ranks.  Raises
    where ``t`` is not whole (``whole`` items along ``dim``)."""
    if t.shape[dim] != whole:
        raise ValueError(f"{what}: {tuple(t.shape)} is not whole ({whole} "
                         f"along dimension {dim}) for a selection")
    t = copy(t, axis)
    return torch.cat([t.narrow(dim, a, n) for a, n in spans], dim=dim)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             axis: ModelAxis) -> torch.Tensor:
    """``models.layers.rms_norm`` over a last dimension that the model
    ranks split: ``x`` and ``scale`` are this rank's parts of it.  Each
    rank's sum of squares is ``psum``-ed over ``axis`` (forward by
    :func:`reduce`; backward by :func:`copy`, since every rank's output
    depends on every rank's part), then each rank scales its own part."""
    xf = x.float()
    sq = xf.square().sum(dim=-1, keepdim=True)
    var = copy(reduce(sq, axis), axis) / (x.shape[-1] * axis.size)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)
