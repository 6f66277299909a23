"""Carry the reference's parameters into the port.

``params_from_jax(cfg, tree)`` takes the pytree of the reference's
``repro.models.transformer.init_decoder`` as numpy arrays (``jax.tree.map
(np.asarray, params)``) and loads it into a :class:`~.transformer.Decoder`.
The reference stacks each segment's super-blocks on a leading axis: a
block's leaves are ``(n_iter, ...)``; a ``local_global`` super-block's
``locals`` are ``(n_iter, per - 1, ...)`` and its ``global`` ``(n_iter,
...)``.  The module's parameter names are the tree's keys (``ln1.scale``,
``attn.wq.kernel``, ``mlp.wi_gate.kernel``, ...), so each block is loaded
by name; every leaf of the tree must land in exactly one parameter.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .transformer import Decoder, segments_for

__all__ = ["params_from_jax"]


def _leaf(tree, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def _load(module: torch.nn.Module, tree, index=()) -> int:
    """Copy ``tree[...][index]`` into each parameter of ``module`` by
    name; returns the elements copied."""
    n = 0
    for name, p in module.named_parameters():
        src = np.asarray(_leaf(tree, name))[index]
        if src.shape != tuple(p.shape):
            raise ValueError(f"{name}: tree leaf {src.shape}, parameter "
                             f"{tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(src, np.float32)))
        n += src.size
    return n


def params_from_jax(cfg: ModelConfig, tree, device="cuda") -> Decoder:
    """The reference's ``init_decoder`` pytree (numpy leaves) as the port's
    :class:`Decoder` on ``device``."""
    device = resolve_device(device)
    params = Decoder(cfg, device=device)
    with torch.no_grad():
        n = _load(params.embed, tree["embed"])
        n += _load(params.final_norm, tree["final_norm"])
        for (kind, _, _), seg, seg_tree in zip(segments_for(cfg),
                                               params.segments,
                                               tree["segments"]):
            for i, sup in enumerate(seg):
                if kind == "local_global":
                    for j, blk in enumerate(sup.locals):
                        n += _load(blk, seg_tree["locals"], (i, j))
                    n += _load(sup.global_, seg_tree["global"], (i,))
                else:
                    n += _load(sup, seg_tree, (i,))
    leaves = sum(np.asarray(a).size for a in _leaves(tree))
    if n != leaves:
        raise ValueError(f"the tree holds {leaves} values, the model "
                         f"{n}: its layout is not this config's")
    return params


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
