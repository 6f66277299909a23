"""Activation recomputation of the layer stack's super-blocks: the port of
the reference's ``jax.checkpoint(body, policy=_remat_policy(cfg),
prevent_cse=False)`` around each super-block of its layer scan
(``transformer.decoder_apply``, whisper's encoder and decoder bodies in
``encdec``).

:func:`remat_call` runs one super-block through
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` where
autograd records the forward, and plainly where it does not (the serving
steps run under ``no_grad``).  The policy is ``cfg.remat_policy``:

* ``"full"`` (the reference's ``nothing_saveable``): only the block's
  inputs are kept; its forward runs again in the backward pass.
* ``"dots"`` (``dots_with_no_batch_dims_saveable``): the outputs of the
  products with no batch dimensions are kept, every other op is
  recomputed (``create_selective_checkpoint_contexts`` with
  :func:`dots_policy`).

"No batch dimensions" is ``dot_general``'s notion, and the aten name of a
product does not carry it alone: ``torch.einsum`` reaches ``aten.bmm``
for any product, a projection too (with a batch of one).  So the choice
follows what each product is in the port's code.  The products with no
batch dimensions are an activation times a 2-D weight, ``x @ kernel``:
``layers.dense`` (every projection of attention, the MLPs, Mamba2 and
xLSTM), the MoE router and zamba2's LoRA adapter.
``torch.matmul`` folds their leading dimensions into one ``aten.mm``
(always where the weight requires grad, as in training), else reaches
``aten.bmm`` against the weight broadcast over the batch (a batch stride
of 0).  The products with batch dimensions reach ``aten.bmm`` with a
real batch: attention's score and value einsums (``bskgd,btkd``), the
MoE experts' ``(E, C, d)`` products, the SSD scan's chunk products
(Mamba2, mLSTM), the sLSTM's per-head recurrence and the mLSTM readout.
No projection of the port is written as an einsum.

Recomputing runs the same ops on the same inputs, so the loss and every
gradient equal the run without recomputation bit for bit (on the CPU;
``chip_smoke.py`` phase 17 holds it on the card).

On a mesh the recomputed forward issues the block's collectives again
(the model axis's ``psum`` / ``all_gather`` of ``distributed.tp``, MoE's
count gather), in the same order on every rank, as the reference's
partitioned program recomputes them.  ``distributed.compat`` counts them
in ``STATS`` and apart in ``APART["recompute"]``.  The backward pass runs
in the autograd engine's thread (on CUDA, a thread of its own), where
the caller's context variables (the model axis of ``distributed.tp``,
the token split of ``models.moe``) are not set, so a block is recomputed
inside a copy of the context its forward ran in.  Nothing in a block
draws random numbers, so the RNG state is not kept.
"""

from __future__ import annotations

import contextvars
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..distributed import compat

__all__ = ["remat_call", "dots_policy", "no_batch_dims"]

_aten = torch.ops.aten
_MATRIX = (_aten.mm.default, _aten.addmm.default)
_BATCHED = (_aten.bmm.default, _aten.baddbmm.default)


def no_batch_dims(func, args) -> bool:
    """Whether the op ``func`` on ``args`` is a product with no batch
    dimensions: a matrix product, or a batched one with an operand
    broadcast over its batch (module docstring)."""
    if func in _MATRIX:
        return True
    if func in _BATCHED:
        a, b = args[-2], args[-1]
        return a.stride(0) == 0 or b.stride(0) == 0
    return False


def dots_policy(ctx, func, *args, **kwargs) -> CheckpointPolicy:
    """``"dots"``: keep the products with no batch dimensions, recompute
    the rest (collectives included)."""
    return (CheckpointPolicy.MUST_SAVE if no_batch_dims(func, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


_CONTEXTS = {
    "full": None,
    "dots": functools.partial(create_selective_checkpoint_contexts,
                              dots_policy),
}


def _recompute(fn, *args):
    with compat.counted_apart("recompute"):
        return fn(*args)


def remat_call(cfg, fn, *args):
    """``fn(*args)``, with its activations recomputed in the backward pass
    under ``cfg.remat_policy`` where grad is enabled (module docstring)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat_policy not in _CONTEXTS:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} is none of "
                         f"{tuple(_CONTEXTS)}")
    forward = contextvars.copy_context()
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        return forward.run(_recompute, fn, *a)

    kwargs = {}
    if _CONTEXTS[cfg.remat_policy] is not None:
        kwargs["context_fn"] = _CONTEXTS[cfg.remat_policy]
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)
