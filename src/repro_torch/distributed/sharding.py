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
the sharded train step updates).  :class:`ShardedCache` holds this
rank's slices of a decode cache with the cache's specs: sliced out of a
whole cache (:meth:`ShardedCache.place`) or allocated at the local
shapes alone (:meth:`ShardedCache.allocate`, behind
``Model.init_cache(..., mesh=)``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

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
    "SPLIT",
    "SELECT",
    "GATHER",
    "REPLICATED",
    "compute_split",
    "mixer_heads",
    "attention_split",
    "without_model",
    "only_model",
    "ShardedCache",
    "map_cache",
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
    from ..models.convert import leaf_shapes, tree_path

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

    return map_cache(lambda t: f(tuple(t.shape)), cache, leaf=lambda _: ())


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
    on every rank.  A gather over "model" is counted under that axis
    (``compat.STATS``)."""
    for dim, axes in enumerate(spec):
        if axes:
            on_model = "model" in ((axes,) if isinstance(axes, str)
                                   else axes)
            x = compat.all_gather(x, mesh.group(axes), dim=dim,
                                  axis="model" if on_model else None)
    return x


def without_model(spec: Spec) -> Spec:
    """``spec`` with "model" taken out: the layout of a tensor that is
    whole over the model axis and sharded over the others as ``spec``
    says."""
    def drop(axes):
        if not axes:
            return axes
        rest = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                     if a != "model")
        return rest[0] if len(rest) == 1 else (rest or None)
    return tuple(drop(a) for a in spec)


def only_model(spec: Spec) -> Spec:
    """``spec`` with every axis but "model" taken out."""
    return tuple("model" if axes and "model" in (
        (axes,) if isinstance(axes, str) else axes) else None
        for axes in spec)


# ---------------------------------------------------------------------------
# the compute split over the "model" axis (distributed.tp)
# ---------------------------------------------------------------------------

SPLIT, SELECT, GATHER, REPLICATED = ("split", "select", "gather",
                                     "replicated")
_ATTN = ("attn", "self_attn", "cross")
# the mixers' leaves by the dimension of this rank's heads' model shard
# (head-major, so a contiguous shard holds whole heads), and their packed
# leaves, whose segments split by head one by one: gathered whole, each
# rank selects its heads' parts (models.ssm, models.xlstm)
_MIXER_SPLIT = {
    "mamba": {"A_log": 0, "D": 0, "dt_bias": 0, "norm.scale": 0,
              "out_proj.kernel": 0},
    "mlstm": {"wq.kernel": 1, "wk.kernel": 1, "wv.kernel": 1,
              "wz.kernel": 1, "w_gates.kernel": 1, "w_gates.bias": 0,
              "norm.scale": 0, "wo.kernel": 0},
    "slstm": {"norm.scale": 0, "wo.kernel": 0},
}
_MIXER_SELECT = {"mamba": ("in_proj.kernel", "conv.kernel"), "mlstm": (),
                 "slstm": ("wx.kernel", "wx.bias", "r")}


def attention_split(cfg, tp: int, seq_len: int) -> Optional[str]:
    """How attention splits over a model axis of ``tp`` ranks, by the
    reference's ``_constrain_heads_or_seq``: ``"heads"`` where the head
    count divides it, else ``"seq"`` (the query sequence) where the
    sequence does, else None (computed whole on every model rank)."""
    if tp <= 1:
        return None
    if cfg.n_heads % tp == 0:
        return "heads"
    return "seq" if seq_len % tp == 0 else None


def mixer_heads(cfg) -> int:
    """The head count by which the Mamba2 (zamba2) or xLSTM mixers split
    over the model axis, 0 for a config without them."""
    if cfg.family == "hybrid":
        return cfg.n_ssm_heads
    return cfg.n_heads if cfg.mlstm_slstm_pattern else 0


def _mixer_leaf(name: str) -> Optional[Tuple[str, str]]:
    """``(mixer, leaf)`` of a Mamba2 / mLSTM / sLSTM parameter (``"mamba"``,
    ``"mlstm"`` or ``"slstm"``, and its name inside the mixer), else
    None."""
    parts = name.split(".")
    for i, p in enumerate(parts):
        if p == "mixer" and i >= 2 and parts[i - 2] == "mambas":
            return "mamba", ".".join(parts[i + 1:])
        if p == "core" and i >= 1:
            kind = "mlstm" if parts[i - 2:i - 1] == ["mlstms"] else "slstm"
            return kind, ".".join(parts[i + 1:])
    return None


def _split_of(name: str, cfg, tp: int, mixers: bool):
    """``(SPLIT, dim)`` where a model rank computes with its own shard of
    parameter ``name`` along ``dim``, ``(SELECT, None)`` where it computes
    with its heads' parts of the whole tensor, else ``(None, None)``.  A
    mixer's leaves split where its mixer does (``mixers``, and its head
    count divides ``tp``)."""
    leaf = _mixer_leaf(name)
    if leaf is None:
        dim = _split_dim(name, cfg, tp)
        return (None, None) if dim is None else (SPLIT, dim)
    if not mixers or mixer_heads(cfg) % tp:
        return None, None
    kind, rest = leaf
    if rest in _MIXER_SELECT[kind]:
        return SELECT, None
    if rest not in _MIXER_SPLIT[kind]:
        raise ValueError(f"{name}: a {kind} leaf of no known layout")
    return SPLIT, _MIXER_SPLIT[kind][rest]


def _split_dim(name: str, cfg, tp: int) -> Optional[int]:
    """The dimension of parameter ``name`` (no mixer's) along which a model
    rank computes with its own shard, or None where it computes with the
    whole tensor."""
    parts = name.split(".")
    leaf, owner = parts[-2:], parts[-3] if len(parts) > 2 else ""
    if name == "embed.table":
        return 0 if cfg.padded_vocab % tp == 0 else None
    if owner in _ATTN and leaf[0] in ("wq", "wo", "wk", "wv"):
        if cfg.n_heads % tp:
            return None     # the query sequence splits, or nothing
        if leaf[0] in ("wk", "wv") and cfg.n_kv_heads % tp:
            return None     # a KV head's columns would split
        if leaf[0] == "wo":
            return 0
        return 1 if leaf[1] == "kernel" else 0
    if owner in ("mlp", "shared") and leaf[0] in ("wi_gate", "wi_up", "wo"):
        if cfg.d_ff % tp:
            return None
        return 0 if leaf[0] == "wo" else 1
    if owner == "moe" and leaf[0] in ("wi_gate", "wi_up", "wo"):
        return 0 if cfg.n_experts % tp == 0 else None
    if parts[-1] in ("lora_a", "lora_b"):
        from ..models.transformer import _LORA_RANK

        return None if _LORA_RANK % tp else (
            1 if parts[-1] == "lora_a" else 0)
    return None


def compute_split(specs: Dict[str, Spec], cfg, mesh,
                  mixers: bool = True) -> Dict[str, str]:
    """For each parameter (``specs``: ``param_shardings``), how the ranks
    of the "model" axis compute with it in the sharded train step and
    the mesh prefill:

    * ``SPLIT``: with this rank's own model shard (column- or
      row-parallel matmuls, this rank's heads, vocabulary rows or
      experts; the Mamba2, mLSTM and sLSTM mixers' head-aligned leaves:
      ``A_log``, ``D``, ``dt_bias``, the norms' gains, ``out_proj``,
      ``wq`` / ``wk`` / ``wv`` / ``wz``, ``w_gates`` and its bias, ``wo``);
    * ``SELECT``: gathered whole, as ``GATHER`` is, but each rank
      computes with its heads' parts of it only (the mixers' packed
      leaves: Mamba2's ``in_proj`` and ``conv``, sLSTM's ``wx``, its bias
      and ``r``), so its gradient is summed over "model"
      (``distributed.tp.select``);
    * ``GATHER``: the rules shard it over "model" but the shard does not
      line up with what a rank computes (a norm's gain; gemma3-1b's
      ``wk`` / ``wv`` at tp = 2, half of its one KV head; attention that
      splits the query sequence; the router, whose logits route whole;
      a mixer whose heads do not divide the axis, or any mixer where
      ``mixers`` is False: the mesh decode's, whose states are stored on
      ``N`` / ``K``, not by head), so it is gathered whole for the step;
    * ``REPLICATED``: the rules leave it whole on "model".

    The mixers split where their head count (:func:`mixer_heads`)
    divides the axis.  Raises where a leaf that computes split is not
    stored split the same way: no leaf falls back to whole weights."""
    tp = axis_size(mesh, "model")
    out = {}
    for name, spec in specs.items():
        on_model = [d for d, axes in enumerate(spec) if axes and "model" in (
            (axes,) if isinstance(axes, str) else axes)]
        how, dim = _split_of(name, cfg, tp, mixers) if tp > 1 \
            else (None, None)
        if how == SPLIT and on_model != [dim]:
            raise ValueError(f"{name}: computes split on dimension {dim}"
                             f" but is stored as {spec}")
        out[name] = how or (GATHER if on_model else REPLICATED)
    return out


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

    def whole(self, name: str) -> torch.Tensor:
        """The whole tensor ``name``, gathered (a collective: every rank of
        the mesh calls it, in the same order)."""
        return unshard(self[name], self.specs[name], self.mesh)


# ---------------------------------------------------------------------------
# decode caches on a live mesh
# ---------------------------------------------------------------------------

def map_cache(fn, cache: Any, *others: Any, leaf=None) -> Any:
    """``fn(tensor, *matching)`` for every tensor of ``cache`` (lists,
    tuples, named tuples, dicts of tensors), each with the node at the same
    place in each tree of ``others`` (a spec where ``others`` holds
    ``cache_shardings``' specs); a leaf that is no tensor (a ``KVCache``'s
    ``length``) is kept as it is, or is ``leaf(node)`` where ``leaf`` is
    given."""
    def walk(node, *rest):
        if isinstance(node, torch.Tensor):
            return fn(node, *rest)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(*nodes) for nodes in zip(node, *rest)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(*nodes) for nodes in zip(node, *rest))
        if isinstance(node, dict):
            return {k: walk(v, *(o[k] for o in rest))
                    for k, v in node.items()}
        return node if leaf is None else leaf(node)

    return walk(cache, *others)


def _local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(n // mesh.axis_size(axes) if axes else n
                 for n, axes in zip(shape, spec))


class ShardedCache:
    """This rank's slices of a decode cache on a live ``mesh``: ``local``,
    the cache's own structure (lists of ``KVCache``, ``MambaCache``, ...,
    or an ``EncDecCache``) holding this rank's slice of each tensor, with
    ``specs`` (``cache_shardings`` of the whole cache, the same structure)
    and the global ``batch``.  A ``KVCache``'s ``length`` is a host int,
    the same on every rank.  The decode steps take it where they take a
    whole cache (``models.transformer.decoder_decode``,
    ``models.encdec.encdec_decode``) and return a new one."""

    def __init__(self, local: Any, specs: Any, mesh, batch: int):
        self.local, self.specs, self.mesh, self.batch = (local, specs, mesh,
                                                         batch)

    @classmethod
    def place(cls, cache: Any, mesh, batch: int,
              n_kv_heads: int) -> "ShardedCache":
        """This rank's own copy of its slice of each tensor of the whole
        ``cache`` (on ``mesh.device``) under ``cache_shardings``."""
        specs = cache_shardings(cache, mesh, batch, n_kv_heads)
        return cls(map_cache(
            lambda t, spec: local_slice(t, spec, mesh).to(
                mesh.device, copy=True).contiguous(), cache, specs),
            specs, mesh, batch)

    @classmethod
    def allocate(cls, make, mesh, batch: int, n_kv_heads: int,
                 device) -> "ShardedCache":
        """A fresh cache at this rank's local shapes only: ``make(whole)``
        builds the cache on the CPU, the whole one where ``whole`` (here
        under a ``FakeTensorMode`` of its own: shapes and dtypes, no
        storage, for the specs) else one of one sequence and one slot,
        whose leaves give each tensor's fill value (zero, or a
        stabiliser's -1e9).  Both are made outside any fake mode the
        caller runs in (a dry-run's, ``launch.dryrun``), so the fill is
        read from real values; the local tensors are made in the caller's
        mode."""
        from torch._subclasses.fake_tensor import (FakeTensorMode,
                                                   unset_fake_temporarily)

        def fill_of(one):
            fill = one.reshape(-1)[0]
            if not bool((one == fill).all()):
                raise ValueError("a cache leaf is not one value throughout")
            return fill.item()

        with unset_fake_temporarily():
            with FakeTensorMode():
                shapes = make(True)
            fills = map_cache(fill_of, make(False))
        specs = cache_shardings(shapes, mesh, batch, n_kv_heads)

        def alloc(fake, spec, fill):
            return torch.full(_local_shape(fake.shape, spec, mesh), fill,
                              dtype=fake.dtype, device=device)

        return cls(map_cache(alloc, shapes, specs, fills), specs, mesh,
                   batch)

    def like(self, local: Any) -> "ShardedCache":
        """``local`` (slices of the same layout) as a ShardedCache."""
        return ShardedCache(local, self.specs, self.mesh, self.batch)
