"""Squared-L2 distance block: the IVF arena scan's flat-vector scorer.

Counterpart of the reference wrapper ``repro.kernels.l2_topk.l2_dist``
(``src/repro/kernels/l2_topk/ops.py``).  Empty inputs short-circuit; the
kernel takes any ``d`` (it masks the ragged depth tile, which is the same
as zero-padding ``d`` — distance-preserving) and any row counts.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._check import cuda_args, ptr, stream_of
from .ref import l2_dist_ref

__all__ = ["l2_dist"]


def l2_dist(queries: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """queries (NQ, d), cands (N, d) -> (NQ, N) f32 squared L2 distances.

    CPU tensors take the plain torch version; CUDA tensors (f32) launch
    ``csrc/l2_dist.cu`` on the current stream.
    """
    if queries.dim() != 2 or cands.dim() != 2 or \
            queries.shape[1] != cands.shape[1]:
        raise ValueError(f"l2_dist: shapes {tuple(queries.shape)} and "
                         f"{tuple(cands.shape)} do not match as (NQ, d), (N, d)")
    nq, d = queries.shape
    n = cands.shape[0]
    if nq == 0 or n == 0:
        return torch.zeros((nq, n), dtype=torch.float32, device=queries.device)
    if queries.device.type == "cpu" and cands.device.type == "cpu":
        return l2_dist_ref(queries, cands)
    cuda_args("l2_dist", queries, cands)
    if queries.dtype != torch.float32 or cands.dtype != torch.float32:
        raise TypeError("l2_dist: kernel takes float32 tensors")
    out = torch.empty((nq, n), dtype=torch.float32, device=queries.device)
    lib = _build.library("l2_dist")
    fn = lib.l2_dist_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(queries), ptr(cands), ptr(out), nq, n, d, stream_of(out))
    _build.check(lib, rc, "l2_dist")
    l2_dist.launches += 1
    return out


l2_dist.launches = 0
