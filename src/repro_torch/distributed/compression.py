"""Gradient compression: int8 error-feedback quantization (cross-pod DP).

The port of ``repro.distributed.compression``.  Per-tensor scale =
max|g| / 127, quantize (``torch.round``: half to even, as ``jnp.round``),
dequantize locally and keep the residual in an error-feedback
accumulator folded into the next step.  The scale divides by an f32
tensor, not a host scalar (a CUDA kernel would multiply by the
reciprocal), so the dequantized values are the reference's bit for bit.

Gradients are dicts keyed by parameter name (``train.step``'s); any
mapping of names to tensors will do.  The reference's scale is one a
leaf of its pytree, where a leaf stacks the same weight of every layer
of a segment: ``leaf_of`` maps a name to its leaf (``train.step`` passes
``models.convert.tree_path``'s keys), and the tensors of one leaf share
its scale (the max over all of them).  Without it each tensor is a leaf.

``compress_tree_int8`` is the stateless variant used inside train_step;
``EFCompressor`` carries the error-feedback state across steps.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

__all__ = ["compress_tree_int8", "EFCompressor", "EFState", "ef_init",
           "ef_compress"]


def _scales(grads: Dict[str, torch.Tensor], leaf_of: Optional[Callable],
            reduce_max: Optional[Callable] = None
            ) -> Dict[str, torch.Tensor]:
    """Each tensor's scale, max|g| / 127 over its leaf (over every rank's
    shard of it, where ``reduce_max`` takes the max across them)."""
    peak: Dict = {}
    for k, g in grads.items():
        m = g.float().abs().max()
        leaf = k if leaf_of is None else leaf_of(k)
        peak[leaf] = m if leaf not in peak else torch.maximum(peak[leaf], m)
    if reduce_max is not None and peak:
        keys = list(peak)
        peak = dict(zip(keys, reduce_max(torch.stack(
            [peak[k] for k in keys])).unbind()))
    return {k: torch.clamp(peak[k if leaf_of is None else leaf_of(k)],
                           min=1e-12) / torch.full((), 127.0,
                                                   device=g.device)
            for k, g in grads.items()}


def _q8(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_tree_int8(grads: Dict[str, torch.Tensor],
                       leaf_of: Optional[Callable] = None,
                       reduce_max: Optional[Callable] = None
                       ) -> Dict[str, torch.Tensor]:
    """Simulate the int8 all-reduce path: quantize-dequantize each leaf.
    Where the gradients are this rank's shards of the leaves (the sharded
    step's, split over the "model" axis), ``reduce_max`` maps the stacked
    per-leaf peaks to their max over the ranks that split them (a
    ``pmax``), so every shard takes the whole leaf's scale."""
    scales = _scales(grads, leaf_of, reduce_max)
    return {k: _q8(g, scales[k]) for k, g in grads.items()}


class EFState(NamedTuple):
    residual: Dict[str, torch.Tensor]


def ef_init(params) -> EFState:
    """Zero residuals (f32) for a module's parameters or a name -> tensor
    mapping."""
    named = (params.named_parameters() if isinstance(params, torch.nn.Module)
             else params.items())
    return EFState(residual={k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in named})


def ef_compress(grads: Dict[str, torch.Tensor], state: EFState
                ) -> Tuple[Dict[str, torch.Tensor], EFState]:
    """Error-feedback int8: compress (g + residual), carry the error."""
    full = {k: g.float() + state.residual[k] for k, g in grads.items()}
    comp = compress_tree_int8(full)
    return comp, EFState(residual={k: full[k] - comp[k] for k in full})


class EFCompressor:
    """Object wrapper for loops that keep python-side state."""

    def __init__(self, params):
        self.state = ef_init(params)

    def __call__(self, grads):
        comp, self.state = ef_compress(grads, self.state)
        return comp
