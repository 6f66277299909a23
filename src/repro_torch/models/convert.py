"""Carry the reference's parameters into the port.

``params_from_jax(cfg, tree)`` takes the pytree of the reference's
``repro.models.transformer.init_decoder`` as numpy arrays (``jax.tree.map
(np.asarray, params)``) and loads it into a :class:`~.transformer.Decoder`;
for an encoder-decoder config, the tree of ``repro.models.encdec.
init_encdec`` into an :class:`~.encdec.EncDec` (``enc_blocks`` and
``dec_blocks`` stacked on axis 0, the block's keys its module names:
``dec_blocks.<i>.cross.wk.kernel`` is ``tree["dec_blocks"]["cross"]["wk"]
["kernel"][i]``).
The reference stacks each segment's super-blocks on a leading axis, and
the blocks a super-block repeats on a second: a block's leaves are
``(n_iter, ...)``; a ``local_global`` super-block's ``locals``, a hybrid
one's ``mambas`` and an xLSTM one's ``mlstms`` are ``(n_iter, per', ...)``
(an MoE block's expert kernels ``(n_iter, E, d, ff)``).  The module's
parameter names are the tree's keys (``ln1.scale``, ``attn.wq.kernel``,
``moe.wi_gate.kernel``, ``mambas.<j>.mixer.A_log``, ...): a numeric part
indexes the stacked axis, ``global_`` is the tree's ``global``.  The
hybrid family's ``shared_attn`` is one unstacked block.  Every leaf of
the tree must land in exactly one parameter.

``params_to_jax(cfg, params)`` is the exact inverse: the module as the
reference's pytree of numpy arrays (stacked axes, ``global``, the
unstacked ``shared_attn``), which the checkpoint writes under the
reference's keys.  ``tree_of`` builds that layout from any mapping of
parameter names to arrays (the optimizer's moments), ``tree_path`` gives
one parameter's place in it and ``leaf_shapes`` each leaf's stacked
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .encdec import EncDec
from .transformer import Decoder

__all__ = ["params_from_jax", "params_to_jax", "tree_of", "tree_path",
           "leaf_shapes"]

# module attribute -> the reference tree's key, where they differ
_TREE_KEY = {"global_": "global"}


def _load(module: torch.nn.Module, tree, index=()) -> int:
    """Copy each parameter of ``module`` from ``tree`` by name, at
    ``index`` on the leaf's stacked axes; returns the elements copied."""
    n = 0
    for name, p in module.named_parameters():
        leaf, at = tree, list(index)
        for part in name.split("."):
            if part.isdigit():
                at.append(int(part))
            else:
                leaf = _sub(leaf, _TREE_KEY.get(part, part))
        src = np.asarray(leaf)
        if src.ndim < len(at) or any(
                i >= n for i, n in zip(at, src.shape)) or \
                src[tuple(at)].shape != tuple(p.shape):
            raise ValueError(f"{name}[{at}]: tree leaf {src.shape}, "
                             f"parameter {tuple(p.shape)}: the tree's "
                             "layout is not this config's")
        src = src[tuple(at)]
        p.copy_(torch.from_numpy(np.array(src, np.float32)))
        n += src.size
    return n


def params_from_jax(cfg: ModelConfig, tree, device="cuda"):
    """The reference's ``init_decoder`` pytree (numpy leaves) as the port's
    :class:`Decoder` on ``device``, or its ``init_encdec`` pytree as an
    :class:`EncDec` for an encoder-decoder config."""
    device = resolve_device(device)
    n = 0
    with torch.no_grad():
        if cfg.encoder_decoder:
            params = EncDec(cfg, device=device)
            for key in ("enc_blocks", "dec_blocks"):
                for i, block in enumerate(getattr(params, key)):
                    n += _load(block, _sub(tree, key), (i,))
            rest = ("embed", "enc_norm", "final_norm")
        else:
            params = Decoder(cfg, device=device)
            rest = ("embed", "final_norm") + (
                ("shared_attn",) if params.shared_attn is not None else ())
            for seg, seg_tree in zip(params.segments, _sub(tree, "segments")):
                for i, sup in enumerate(seg):
                    n += _load(sup, seg_tree, (i,))
        for key in rest:
            n += _load(getattr(params, key), _sub(tree, key))
    leaves = sum(np.asarray(a).size for a in _leaves(tree))
    if n != leaves:
        raise ValueError(f"the tree holds {leaves} values, the model "
                         f"{n}: its layout is not this config's")
    return params


def _sub(tree, key):
    """``tree[key]``, or a ValueError naming the missing key."""
    if not isinstance(tree, dict) or key not in tree:
        raise ValueError(f"the tree has no {key!r}: its layout is not this "
                         "config's")
    return tree[key]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_path(name: str):
    """``(keys, at)`` of the parameter ``name`` of a :class:`Decoder` or
    :class:`EncDec`: the reference tree's keys down to its leaf (an int
    key indexes the list ``segments``) and the index on the leaf's
    stacked axes."""
    parts = name.split(".")
    keys, at = [], []
    if parts[0] == "segments":
        keys, at, parts = ["segments", int(parts[1])], [int(parts[2])], \
            parts[3:]
    elif parts[0] in ("enc_blocks", "dec_blocks"):
        keys, at, parts = [parts[0]], [int(parts[1])], parts[2:]
    for part in parts:
        if part.isdigit():
            at.append(int(part))
        else:
            keys.append(_TREE_KEY.get(part, part))
    return tuple(keys), tuple(at)


def tree_of(named) -> dict:
    """The reference's pytree (numpy leaves) of ``named``, a mapping of a
    module's parameter names to tensors or arrays of the parameters'
    shapes: each leaf stacks its parameters on the axes
    :func:`tree_path` gives."""
    leaves = {}
    for name, value in named.items():
        keys, at = tree_path(name)
        value = (value.detach().cpu().numpy() if isinstance(value,
                                                             torch.Tensor)
                 else np.asarray(value))
        leaves.setdefault(keys, []).append((at, value))
    tree = {}
    for keys, parts in leaves.items():
        lead = tuple(1 + max(at[i] for at, _ in parts)
                     for i in range(len(parts[0][0])))
        leaf = np.empty(lead + parts[0][1].shape, parts[0][1].dtype)
        if len(parts) != int(np.prod(lead)):
            raise ValueError(f"{'/'.join(map(str, keys))}: {len(parts)} "
                             f"parameters for a stack of {lead}")
        for at, value in parts:
            leaf[at] = value
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return _lists(tree)


def leaf_shapes(named) -> dict:
    """The shape of each leaf of ``tree_of(named)`` (stacked axes first),
    by its keys (:func:`tree_path`); ``named`` maps parameter names to
    anything with a ``shape``."""
    lead: dict = {}
    shape = {}
    for name, t in named.items():
        keys, at = tree_path(name)
        top = lead.setdefault(keys, [0] * len(at))
        lead[keys] = [max(a, i + 1) for a, i in zip(top, at)]
        shape[keys] = tuple(t.shape)
    return {k: tuple(lead[k]) + shape[k] for k in lead}


def _lists(node):
    """Dicts keyed 0..n-1 (the segments) as lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def params_to_jax(cfg: ModelConfig, params) -> dict:
    """The reference's ``init_decoder`` (or ``init_encdec``) pytree of
    ``params`` as numpy arrays: ``params_from_jax(cfg, params_to_jax(cfg,
    params))`` holds the same values."""
    if bool(cfg.encoder_decoder) != isinstance(params, EncDec):
        kind = "an EncDec" if cfg.encoder_decoder else "a Decoder"
        raise ValueError(f"{cfg.name}'s parameters are {kind}")
    return tree_of(dict(params.named_parameters()))
