"""The sharded train step's weights gathered layer by layer — the
reference's FSDP partitioning, written out.

The reference's rules shard each stacked kernel ``(L, in, out)`` as
``(None, "data", "model")``: the data axes act as FSDP.  Its loss runs
each segment as a ``lax.scan`` of a ``jax.checkpoint``-ed super-block,
so GSPMD gathers one super-block's weights inside the loop body, gathers
them again when the body is recomputed in the backward pass, and reduces
their gradients back into the sharded layout there.  The port does the
same in eager code:

* :class:`_Gather`, an autograd function on one leaf: forward, this
  rank's stored shard gathered into the tensor the block computes with
  (a leaf that ``sharding.compute_split`` marks ``SPLIT`` over the data
  axes only, so it stays this rank's model shard; a ``SELECT``,
  ``GATHER`` or ``REPLICATED`` leaf whole); backward, the gradient taken
  back to the stored shard's layout: a ``SELECT`` or ``GATHER`` leaf
  sliced to its model shard (its gradient is the same on every model
  rank: ``distributed.tp``; a ``SELECT`` leaf's is summed over the model
  ranks by ``tp.select``), then
  ``compat.reduce_scatter`` over the data axes that shard it and
  ``compat.psum`` over those that do not (the data ranks computed
  different slices of the batch), or this rank's slice alone where every
  data rank computed the whole batch.  The function keeps its mesh, its
  groups and the leaf's layout in ``ctx``: on CUDA the backward runs in
  the autograd engine's thread, where the caller's context variables
  are unset.
* :class:`LayerGather`, the step's plan: this rank's shard of every
  parameter held by a module of the model's structure (:attr:`
  LayerGather.module`, from ``models.module_of``: autograd leaves that
  share the shards' storage) and :meth:`LayerGather.view`, which gives a
  module of it with its leaves gathered.
* :func:`gathered`, the models' hook, called where a module's weights
  are used: under :func:`gathering`, a block's function
  (``transformer._apply_super``; ``encdec._enc_block``, ``_dec_block``)
  calls it first on its own parameters, so the gather runs inside
  ``models.remat.remat_call`` and is recomputed with the block; the
  model's own function calls it on each module outside the blocks (the
  embedding table, also the tied logits', the final norm, zamba2's
  shared block, whisper's encoder norm) once, at its use, its gradients
  reduced once.  The block boundary is where the models call it.
  Outside :func:`gathering` it returns its argument: the one-process
  steps and the serving steps compute as before.

Under "full" and "dots" nothing gathered is kept between a block's
forward and its backward ("dots" keeps the outputs of the products, not
their weights: ``models.remat``), so a rank holds the leaves outside the
blocks and at most a block or two of gathered weights at once
(``compat.GATHERED`` counts them).  A leaf that no axis shards is used
as it is stored (its gradient still reduced over the data axes where
the batch splits over them): on a (1, 1) mesh nothing is gathered or
reduced, and the step is the one-process step bit for bit.  Every gather is counted apart in
``compat.APART["working_gather"]``; a recomputed one also in
``"recompute"``.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from . import compat
from .sharding import (SPLIT, compute_split, dp_axes, local_slice,
                       only_model, unshard, without_model)

__all__ = ["LayerGather", "gathering", "gathered"]


def _axes_of(spec) -> Tuple[str, ...]:
    return tuple(a for axes in spec if axes
                 for a in ((axes,) if isinstance(axes, str) else axes))


class _Leaf(NamedTuple):
    """How one parameter is gathered and its gradient reduced: its stored
    ``spec``, the ``layout`` it is gathered to (the spec of the tensor the
    block computes with, over the stored shard), whether it is gathered
    whole over "model" (``model``: sliced back to its model shard), the
    ``mesh``, and
    whether the data ranks computed different slices of the batch
    (``reduce``)."""
    spec: Tuple
    layout: Tuple
    model: bool
    mesh: object
    reduce: bool


def _to_stored(g: torch.Tensor, leaf: _Leaf) -> torch.Tensor:
    """The gradient ``g`` of a gathered leaf in its stored shard's layout
    (module docstring)."""
    mesh = leaf.mesh
    if leaf.model:
        g = local_slice(g, only_model(leaf.spec), mesh)
    data = without_model(leaf.spec)
    if not leaf.reduce:
        return local_slice(g, data, mesh).contiguous()
    for dim, axes in enumerate(data):
        if axes:
            g = compat.reduce_scatter(g, mesh.group(axes), dim=dim)
    rest = tuple(a for a in dp_axes(mesh) if a not in _axes_of(data)
                 and mesh.axis_size(a) > 1)
    if rest:
        g = compat.psum(g.contiguous(), mesh.group(rest))
    return g.contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, leaf: _Leaf):
        ctx.leaf = leaf
        if not _axes_of(leaf.layout):     # computed as stored, reduced
            return shard.view_as(shard)
        with compat.counted_apart("working_gather"):
            out = unshard(shard, leaf.layout, leaf.mesh)
        compat.GATHERED.gathered(out)
        return out

    @staticmethod
    def backward(ctx, g):
        return _to_stored(g, ctx.leaf), None


class LayerGather:
    """The sharded train step's plan for this rank's ``params``
    (``sharding.Sharded``): :attr:`module`, a module of the model's
    structure whose parameters are autograd leaves that share this
    rank's shards' storage (``models.module_of``: the tensors the step's
    gradients are taken with respect to), and :meth:`view` (module
    docstring).  ``reduce`` says whether the data ranks compute different
    slices of the batch, so that a gradient is summed over them."""

    def __init__(self, module: nn.Module, params, reduce: bool):
        mesh = params.mesh
        split = compute_split(params.specs, module.cfg, mesh)
        self.leaves: Dict[str, Optional[_Leaf]] = {}
        for name, _ in module.named_parameters():
            spec = params.specs[name]
            layout = without_model(spec) if split[name] == SPLIT else spec
            self.leaves[name] = _Leaf(spec, layout, split[name] != SPLIT,
                                      mesh, reduce) \
                if reduce or _axes_of(layout) else None
        self.module = module
        self._names = {id(m): f"{n}." if n else ""
                       for n, m in module.named_modules()}

    def view(self, module: nn.Module) -> nn.Module:
        """``module`` (a module of :attr:`module`'s) with every leaf of it
        gathered."""
        if id(module) not in self._names:
            raise ValueError(f"{type(module).__name__} is no module of this "
                             "step's parameters")
        return self._copy(module, self._names[id(module)])

    def _copy(self, module, prefix: str):
        new = object.__new__(type(module))
        new.__dict__.update(module.__dict__)
        # the leaves as plain attributes: a view has no parameters of its
        # own (a module hook that walks them, as MemTracker's does, finds
        # none of the gathered tensors, which are no autograd leaves)
        new.__dict__["_parameters"] = {}
        new.__dict__.update({n: self._gather(prefix + n, p)
                             for n, p in module._parameters.items()})
        new.__dict__["_modules"] = {n: self._copy(m, f"{prefix}{n}.")
                                    for n, m in module._modules.items()}
        return new

    def _gather(self, name: str, p: torch.Tensor) -> torch.Tensor:
        leaf = self.leaves[name]
        return p if leaf is None else _Gather.apply(p, leaf)


_CURRENT: contextvars.ContextVar = contextvars.ContextVar("layer_gather",
                                                          default=None)


@contextlib.contextmanager
def gathering(plan: Optional[LayerGather]):
    """Make ``plan`` the current :class:`LayerGather` inside the block (the
    sharded train step's forward and backward passes)."""
    token = _CURRENT.set(plan)
    try:
        yield plan
    finally:
        _CURRENT.reset(token)


def gathered(module: nn.Module) -> nn.Module:
    """The models' hook: ``module`` with its leaves gathered under the
    current :class:`LayerGather` (:meth:`LayerGather.view`), else
    ``module`` itself."""
    plan = _CURRENT.get()
    return module if plan is None else plan.view(module)
