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
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from .encdec import EncDec
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
