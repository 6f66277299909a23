"""Carry the reference's parameters into the port.

``params_from_jax(cfg, tree)`` takes the pytree of the reference's
``repro.models.transformer.init_decoder`` as numpy arrays (``jax.tree.map
(np.asarray, params)``) and loads it into a :class:`~.transformer.Decoder`.
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
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .transformer import Decoder

__all__ = ["params_from_jax"]

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
                leaf = leaf[_TREE_KEY.get(part, part)]
        src = np.asarray(leaf)[tuple(at)]
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
        if params.shared_attn is not None:
            n += _load(params.shared_attn, tree["shared_attn"])
        for seg, seg_tree in zip(params.segments, tree["segments"]):
            for i, sup in enumerate(seg):
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
