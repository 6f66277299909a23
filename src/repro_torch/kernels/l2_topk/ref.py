"""Plain torch version of the squared-L2 block (the CPU path and the
oracle the CUDA kernel is held against)."""

from __future__ import annotations

import torch

__all__ = ["l2_dist_ref"]


def l2_dist_ref(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """queries (NQ, d), cands (N, d) -> (NQ, N) f32 ``qn - 2 q.c + cn``."""
    q = queries.to(torch.float32)
    c = cands.to(torch.float32)
    qn = (q * q).sum(1, keepdim=True)
    cn = (c * c).sum(1)
    return qn - 2.0 * (q @ c.T) + cn[None]
