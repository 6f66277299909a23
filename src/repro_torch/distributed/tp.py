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
  one; where the axis is a multiple of the xLSTM's heads, the mLSTM's
  ``wq`` / ``wk`` / ``w_gates`` and the sLSTM's ``wx`` / ``r`` of this
  rank's head), entered by :func:`copy`;
* :func:`rms_norm`: the RMS norm of a tensor whose normalised dimension
  the model ranks split: the sum of squares ``psum``-ed over the axis,
  forward and backward, then each rank scales its own part;
* :func:`state_dims`: where the model axis splits each leaf of a
  recurrent decode state (``sharding.cache_shardings``), for the mixers
  that update their states where they are stored;
* :func:`is_split`: whether a weight is this rank's model shard or whole,
  for the mesh decode's mixers, which compute with each leaf as the
  rules store it;
* :func:`gather_parts`: several column-split activations gathered whole
  in one call.

Where the axis is ``g`` times a mixer's head count (xlstm's 4 heads on
8 or 16 ranks), :meth:`ModelAxis.head_group` gives a rank its head and
its part of that head's channels (:class:`HeadGroup`); the ``g`` ranks
of a head run it whole, and each keeps only its part of the channels
where a sum over "model" follows (``tp.rms_norm``, a row-split output
projection), so no head counts ``g`` times (``models.xlstm``).

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
from typing import Any, NamedTuple, Optional, Tuple

import torch

from . import compat

__all__ = ["ModelAxis", "HeadGroup", "heads_of", "split_model", "current", "axis_for",
           "axis_for_heads", "check_local",
           "copy", "reduce", "gather", "scatter", "select", "rms_norm",
           "state_dims", "is_split", "gather_parts", "AXIS"]

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

    def head_group(self, heads: int) -> "HeadGroup":
        """Where the axis is ``g`` times the ``heads``: this rank's head
        and its part of that head's channels (:class:`HeadGroup`); raises
        where ``heads`` does not divide the axis."""
        return HeadGroup.of(self.index, self.size, heads)


class HeadGroup(NamedTuple):
    """A rank's place where the model axis is ``g`` times a mixer's head
    count: the ``g`` consecutive ranks ``head * g ... head * g + g - 1``
    each run ``head`` whole, and rank ``part`` of them owns channel part
    ``part`` of ``g`` of it (the rules store each head's channels split
    into ``g`` contiguous slices on those ranks)."""
    head: int
    part: int
    g: int

    @classmethod
    def of(cls, index: int, size: int, heads: int) -> "HeadGroup":
        """Model rank ``index``'s place on an axis of ``size`` ranks, ``g =
        size / heads`` a head; raises where ``heads`` does not divide
        ``size``."""
        if size % heads:
            raise ValueError(f"{heads} heads do not divide {size} model "
                             "ranks")
        g = size // heads
        return cls(index // g, index % g, g)

    def channels(self, n: int, what: str) -> Tuple[int, int]:
        """``(start, length)`` of this rank's part of a head's ``n``
        channels; raises, naming ``what``, where ``g`` does not divide
        ``n``."""
        if n % self.g:
            raise ValueError(f"{what}: a head's {n} channels do not split "
                             f"over its {self.g} model ranks")
        c = n // self.g
        return self.part * c, c


def heads_of(index: int, size: int, heads: int) -> Tuple[int, int]:
    """``(first, count)``: the heads model rank ``index`` of ``size`` runs:
    ``heads / size`` of them, or where ``size`` is a multiple of the
    ``heads``, the one head of its :class:`HeadGroup`; raises where the
    heads neither split over nor divide the ranks."""
    if heads % size == 0:
        return index * (heads // size), heads // size
    if size % heads:
        raise ValueError(f"{heads} heads neither split over nor divide "
                         f"{size} model ranks")
    return HeadGroup.of(index, size, heads).head, 1


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


def axis_for_heads(heads: int) -> Optional[ModelAxis]:
    """The current model axis where ``heads`` split evenly over it or it
    is a multiple of them (each head on a :class:`HeadGroup`), else
    None."""
    axis = _AXIS.get()
    return axis if axis is not None and (
        heads % axis.size == 0 or axis.size % heads == 0) else None


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


def state_dims(spec, axis: Optional[ModelAxis], dims, what: str):
    """``{leaf: dimension}`` of a recurrent decode state laid out by
    ``spec`` (a named tuple of its leaves' specs, ``cache_shardings``'):
    the dimension along which the model axis splits each leaf, None where
    the leaf is whole on every model rank (every leaf where ``spec`` is
    None or holds no "model").  A leaf may be split only along
    ``dims[leaf]``, by "model" alone, and only under a current ``axis``:
    any other layout raises, naming the leaf and its spec."""
    out = dict.fromkeys(dims)
    if spec is None:
        return out
    for leaf, s in spec._asdict().items():
        on = [d for d, axes in enumerate(s) if axes and AXIS in (
            (axes,) if isinstance(axes, str) else axes)]
        if not on:
            continue
        if axis is None or on != [dims[leaf]] or s[on[0]] not in (
                AXIS, (AXIS,)):
            raise ValueError(f"{what} {leaf}: a state stored as {s} is not "
                             "one the mesh decode updates in place"
                             + ("" if axis else " (no model axis is current)"))
        out[leaf] = on[0]
    return out


def is_split(t: torch.Tensor, dim: int, whole: int,
             axis: Optional[ModelAxis], what: str) -> bool:
    """Whether ``t`` is this rank's model shard of ``whole`` items along
    ``dim`` (True) or the whole tensor (False); any other size, or a
    shard with no model axis current, raises, naming ``what``."""
    if t.shape[dim] == whole:
        return False
    if axis is None:
        raise ValueError(f"{what}: {tuple(t.shape)} is not whole ({whole} "
                         f"along dimension {dim}) and no model axis is "
                         "current")
    check_local(t, dim, whole, axis, what)
    return True


def gather_parts(parts, axis: ModelAxis):
    """Each of ``parts`` (``(B, n_i)`` tensors, this rank's column block
    of each) gathered whole, ``(B, tp n_i)`` in rank order, by one
    ``all_gather`` of their concatenation (in their widest dtype, each
    cast back after: exact)."""
    dtype = parts[0].dtype
    for p in parts[1:]:
        dtype = torch.promote_types(dtype, p.dtype)
    whole = gather(torch.cat([p.to(dtype) for p in parts], dim=-1)[None],
                   axis, 0)                               # (tp, B, sum n_i)
    out, at = [], 0
    for p in parts:
        n = p.shape[-1]
        out.append(whole[..., at:at + n].transpose(0, 1).reshape(
            p.shape[0], axis.size * n).to(p.dtype))
        at += n
    return out
