"""GPipe-style pipeline parallelism over a mesh axis — the port of
``repro.distributed.pp``.

The ``pod`` axis can be re-purposed as a pipeline axis: each rank holds a
contiguous stage of layers; microbatches rotate through stages with
``compat.ppermute``.  This is the standard 1F1B-less GPipe schedule —
bubble fraction (S-1)/(S-1+M) — as a self-contained transform, so any
per-stage function can be pipelined.  Step for step the reference's: the
loop of ``n_stages + n_micro - 1`` steps, stage 0 injecting microbatch
``t``, a stage that is not active passing its input through, the last
stage recording microbatch ``t - (n_stages - 1)``, a ring permute
``i -> i+1 mod n``, and the outputs reaching every rank by a ``psum``
with zeros everywhere but the last stage.
"""

from __future__ import annotations

from typing import Callable

import torch

from . import compat

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, n_stages: int, n_micro: int,
                   mesh, axis: str = "pod"):
    """Returns f(stage_params, x) running stage_fn pipelined over ``axis``.

    stage_params: this rank's stage's parameters (whatever ``stage_fn``
    takes; each rank passes its own).
    x: (n_micro, micro_batch, ...) microbatched input, the same on every
    rank.
    Output: (n_micro, micro_batch, ...) after all stages, on every rank.
    """
    group = mesh.group(axis)
    if mesh.axis_size(axis) != n_stages:
        raise ValueError(f"{n_stages} stages on a {axis} axis of "
                         f"{mesh.axis_size(axis)}")
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def pipelined(stage_params, x):
        stage_id = compat.axis_index(group)
        n_steps = n_stages + n_micro - 1
        carry = torch.zeros_like(x[0])
        outs = torch.zeros_like(x)
        for t in range(n_steps):
            # stage 0 injects microbatch t; others take the permuted carry
            inp = x[min(max(t, 0), n_micro - 1)] if stage_id == 0 else carry
            active = t >= stage_id and t - stage_id < n_micro
            out = stage_fn(stage_params, inp) if active else inp
            # last stage records its finished microbatch
            if stage_id == n_stages - 1 and t >= n_stages - 1:
                outs[t - (n_stages - 1)] = out
            # rotate stage outputs forward
            carry = compat.ppermute(out, group, ring)
        # outs live on the last stage; the sum over stages broadcasts them
        if stage_id != n_stages - 1:
            outs = torch.zeros_like(outs)
        return compat.psum(outs, group)

    return pipelined
