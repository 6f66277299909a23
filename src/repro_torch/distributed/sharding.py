"""Divisibility-aware logical sharding rules (MaxText-style) — the port of
``repro.distributed.sharding``, and the placement of tensors by them.

Mesh axes: ``("data", "model")`` single pod, ``("pod", "data", "model")``
multi-pod; ``pod`` is an outer data-parallel axis.  All rules degrade
deterministically when a dimension does not divide the axis size — no
config ever fails to shard, it just shards less.

Parameters (leaf-name keyed):
  * 2-D kernels          (in, out)   -> (fsdp="data", tp="model")
  * "second" matrices    (wo, out_proj, lora_b, down)
                          (in, out)  -> (tp="model",  fsdp="data")
  * expert kernels       (E, in, out)-> (tp, fsdp, -) / wo: (tp, -, fsdp)
  * embedding table      (V, d)      -> (tp, fsdp)
  * biases / gains       (d,)        -> (tp) when divisible
Activations:
  * batch -> (pod, data); when batch==1 (long_500k) sequence -> data.
KV caches / recurrent states: pattern-matched on shape (cache_shardings).

A spec is a tuple with one entry a dimension, as ``PartitionSpec``'s:
None, an axis name, or a tuple of axis names (sharded over their
row-major product).  The rules read only ``mesh.shape``
(``launch.mesh.Mesh``).  :func:`param_spec` is the reference's, on the
reference's path and stacked shape; :func:`param_shardings` keys a port
parameter by its reference path (``models.convert.tree_path``) and
drops the leading stacked dimensions of the leaf the reference stacks
it into, which the rules never shard.  The port's caches are per layer
(the reference stacks them), so :func:`cache_shardings` sees each
leaf's own dimensions.

Placement on a live mesh: :func:`local_slice` is this rank's shard of a
whole tensor, :func:`unshard` gathers the whole tensor back
(``compat.all_gather`` over the axes of each sharded dimension), and
:class:`Sharded` holds this rank's shards of a set of named tensors with
their specs and whole shapes (what ``checkpoint.reshard`` returns and
the sharded train step updates).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.convert import leaf_shapes, tree_path
from . import compat

__all__ = [
    "param_spec",
    "param_shardings",
    "batch_shardings",
    "cache_shardings",
    "axis_size",
    "dp_axes",
    "local_slice",
    "unshard",
    "Sharded",
]

_SECOND_MATS = ("wo", "out_proj", "lora_b", "wd", "r")

Spec = Tuple[Any, ...]


def axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.shape else ("data",)


def _div(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_spec(path: str, shape: Tuple[int, ...], mesh,
               n_experts: int = 0) -> Spec:
    """The spec of the reference's parameter leaf at ``path`` (its keys
    joined by ``/``) of stacked ``shape``."""
    tp = axis_size(mesh, "model")
    fsdp = axis_size(mesh, "data")
    leaf = path.split("/")[-2] if path.endswith("kernel") or path.endswith("bias") \
        else path.split("/")[-1]
    is_second = any(leaf == s or leaf.endswith(s) for s in _SECOND_MATS)

    # strip stacked scan dims: leading dims that came from vmap over layers
    # are recognized by rank: rules apply to the trailing "logical" dims.
    def spec_for_logical(lshape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
        nd = len(lshape)
        if nd == 1:
            return ("model",) if _div(lshape[0], tp) else (None,)
        if nd == 2:
            a, b = lshape
            if "embed/table" in path:
                return ("model" if _div(a, tp) else None,
                        "data" if _div(b, fsdp) else None)
            if is_second:
                return ("model" if _div(a, tp) else None,
                        "data" if _div(b, fsdp) else None)
            return ("data" if _div(a, fsdp) else None,
                    "model" if _div(b, tp) else None)
        if nd == 3 and n_experts and lshape[0] == n_experts:
            e = "model" if _div(lshape[0], tp) else None
            if is_second:  # (E, ff, d)
                return (e, None, "data" if _div(lshape[2], fsdp) else None)
            return (e, "data" if _div(lshape[1], fsdp) else None, None)
        if nd == 3:
            return (None,
                    "data" if _div(lshape[1], fsdp) else None,
                    "model" if _div(lshape[2], tp) else None)
        # >=4D conv-ish / unusual: shard the last divisible dim on model
        out = [None] * nd
        for i in range(nd - 1, -1, -1):
            if _div(lshape[i], tp):
                out[i] = "model"
                break
        return tuple(out)

    # count leading stacked dims: all dims before the final 1-3 logical dims.
    # Heuristic: norms/gains are (L.., d); kernels are (L.., in, out) or
    # (L.., E, in, out).  We treat trailing `k` dims as logical where k is
    # 3 if an expert dim matches, else min(2, rank), except pure vectors.
    nd = len(shape)
    if nd == 0:
        return ()
    k = 1
    if nd >= 3 and n_experts and shape[-3] == n_experts:
        k = 3
    elif nd >= 2:
        k = 2
    # vectors stacked over layers: (L, d) — d is the logical dim
    if leaf in ("scale", "bias", "A_log", "D", "dt_bias") or (
        nd >= 1 and k == 2 and path.endswith(("scale", "bias"))
    ):
        k = 1
    if k > nd:
        k = nd
    logical = spec_for_logical(shape[nd - k:])
    return (*([None] * (nd - k)), *logical)


def _named(params) -> Dict[str, Any]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def param_shardings(params, mesh, n_experts: int = 0) -> Dict[str, Spec]:
    """``{name: spec}`` for a model's parameters (a ``Decoder`` or
    ``EncDec``, or a mapping of its parameter names to anything with a
    ``shape``: the optimizer's moments take their parameters' specs)."""
    named = _named(params)
    stacked = leaf_shapes(named)
    out = {}
    for name, t in named.items():
        keys, at = tree_path(name)
        spec = param_spec("/".join(map(str, keys)), stacked[keys], mesh,
                          n_experts)
        if any(spec[:len(at)]):
            raise ValueError(f"{name}: the rules shard a stacked dimension "
                             f"of {'/'.join(map(str, keys))}: {spec}")
        out[name] = spec[len(at):]
    return out


def batch_shardings(batch_specs: Dict[str, Any], mesh) -> Dict[str, Spec]:
    """Input specs for train/prefill batches: ``{key: spec}`` for a dict of
    tensors (or anything with a ``shape``)."""
    dp = dp_axes(mesh)
    dp_size = int(math.prod(axis_size(mesh, a) for a in dp))

    def f(name, shape):
        if name.endswith("positions") and len(shape) == 3:  # (3, B, S)
            b, s = shape[1], shape[2]
            if _div(b, dp_size):
                return (None, dp, None)
            return (None, None, dp if _div(s, dp_size) else None)
        if len(shape) >= 2:
            b, s = shape[0], shape[1]
            rest = [None] * (len(shape) - 2)
            if _div(b, dp_size):
                return (dp, None, *rest)
            if _div(s, dp_size):
                return (None, dp, *rest)
        return ()

    return {k: f(k, tuple(v.shape)) for k, v in batch_specs.items()}


def cache_shardings(cache: Any, mesh, global_batch: int,
                    n_kv_heads: int) -> Any:
    """Specs for KV caches / recurrent states (shape pattern-matched), in
    the cache's own structure (lists, dicts, named tuples); a leaf that is
    no tensor (a ``KVCache``'s ``length``) gets ``()``.

    KV leaves (..., B, T, KV, hd): batch->dp when divisible; KV->model when
    divisible else T->model (sequence-sharded decode); long-context batch=1
    shards T over (data[, pod]) too.
    """
    tp = axis_size(mesh, "model")
    dp = dp_axes(mesh)
    dp_size = int(math.prod(axis_size(mesh, a) for a in dp))

    def f(shape):
        nd = len(shape)
        if nd == 0:
            return ()
        spec: list = [None] * nd
        # locate the batch dim: first dim equal to global_batch
        b_idx = next((i for i, d in enumerate(shape) if d == global_batch), None)
        if nd >= 4 and shape[-2] == n_kv_heads:
            t_idx, kv_idx = nd - 3, nd - 2
            if b_idx is not None and b_idx < t_idx and _div(shape[b_idx], dp_size):
                spec[b_idx] = dp
                if _div(n_kv_heads, tp):
                    spec[kv_idx] = "model"
                elif _div(shape[t_idx], tp):
                    spec[t_idx] = "model"
            else:
                # batch unshardable (long_500k): shard T over everything
                if _div(shape[t_idx], dp_size * tp):
                    spec[t_idx] = (*dp, "model")
                elif _div(shape[t_idx], dp_size):
                    spec[t_idx] = dp
            return tuple(spec)
        # recurrent states / conv windows: batch->dp; else last divisible->model
        if b_idx is not None and _div(shape[b_idx], dp_size):
            spec[b_idx] = dp
        for i in range(nd - 1, -1, -1):
            if spec[i] is None and i != b_idx and _div(shape[i], tp):
                spec[i] = "model"
                break
        return tuple(spec)

    def walk(node):
        if isinstance(node, torch.Tensor):
            return f(tuple(node.shape))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c) for c in node)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return ()

    return walk(cache)


# ---------------------------------------------------------------------------
# placement on a live mesh
# ---------------------------------------------------------------------------

def local_slice(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` under ``spec`` (a view
    of ``x``): each sharded dimension cut into equal blocks, the rank's
    block by its row-major index over the dimension's axes."""
    for dim, axes in enumerate(spec):
        if axes:
            n = mesh.axis_size(axes)
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.index(axes) * size, size)
    return x


def unshard(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's shard under
    ``spec``, gathered over the axes of each sharded dimension; the same
    on every rank."""
    for dim, axes in enumerate(spec):
        if axes:
            x = compat.all_gather(x, mesh.group(axes), dim=dim)
    return x


class Sharded(dict):
    """This rank's shards of a set of named tensors: a mapping of each
    name to its local shard, with ``specs`` (name -> spec), ``shapes``
    (name -> the whole tensor's shape) and the live ``mesh``."""

    def __init__(self, local: Dict[str, torch.Tensor], specs, shapes, mesh):
        super().__init__(local)
        self.specs, self.shapes, self.mesh = dict(specs), dict(shapes), mesh

    @classmethod
    def place(cls, named, specs, mesh) -> "Sharded":
        """Each rank's own copy of its shard of each whole tensor of
        ``named`` (a module or a mapping), on ``mesh.device``."""
        named = _named(named)
        local = {n: local_slice(t.detach(), specs[n], mesh).to(
                     mesh.device, copy=True).contiguous()
                 for n, t in named.items()}
        return cls(local, specs, {n: tuple(t.shape)
                                  for n, t in named.items()}, mesh)

    def like(self, local: Dict[str, torch.Tensor]) -> "Sharded":
        """``local`` (shards of the same names and specs) as a Sharded."""
        return Sharded(local, self.specs, self.shapes, self.mesh)

    def slice(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's shard of ``whole``, a tensor of ``name``'s shape."""
        return local_slice(whole, self.specs[name], self.mesh)

    def whole(self, name: str) -> torch.Tensor:
        """The whole tensor ``name``, gathered (a collective: every rank of
        the mesh calls it, in the same order)."""
        return unshard(self[name], self.specs[name], self.mesh)
