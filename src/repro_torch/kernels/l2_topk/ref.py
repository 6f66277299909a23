"""Plain torch versions of the L2 kernels (the CPU path and the oracles
the CUDA kernels are held against)."""

from __future__ import annotations

import torch

__all__ = ["l2_dist_ref", "l2_top1_ref", "TOP1_CHUNK"]

TOP1_CHUNK = 32768   # rows per distance block in l2_top1_ref


def l2_dist_ref(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """queries (NQ, d), cands (N, d) -> (NQ, N) f32 ``qn - 2 q.c + cn``."""
    q = queries.to(torch.float32)
    c = cands.to(torch.float32)
    qn = (q * q).sum(1, keepdim=True)
    cn = (c * c).sum(1)
    return qn - 2.0 * (q @ c.T) + cn[None]


def l2_top1_ref(queries: torch.Tensor, centroids: torch.Tensor):
    """queries (NQ, d), centroids (K, d) -> (idx (NQ,) i32, val (NQ,) f32).

    The nearest centroid of each row and its squared distance
    ``qn - 2 q.c + cn``, computed ``TOP1_CHUNK`` rows at a time (one
    matrix product and one ``min`` each); ties go to the lowest index.
    """
    q = queries.to(torch.float32)
    c = centroids.to(torch.float32)
    cn = (c * c).sum(1)[None]
    idx = torch.empty(q.shape[0], dtype=torch.int32, device=q.device)
    val = torch.empty(q.shape[0], dtype=torch.float32, device=q.device)
    for i in range(0, q.shape[0], TOP1_CHUNK):
        sl = q[i:i + TOP1_CHUNK]
        d = (sl * sl).sum(1, keepdim=True) - 2.0 * (sl @ c.T) + cn
        v, j = d.min(1)
        idx[i:i + TOP1_CHUNK] = j
        val[i:i + TOP1_CHUNK] = v
    return idx, val
