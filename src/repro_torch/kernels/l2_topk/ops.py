"""The L2 kernels: the scan's distance block and k-means' nearest centroid.

Counterparts of the reference wrappers ``repro.kernels.l2_topk.l2_dist``
and ``l2_top1`` (``src/repro/kernels/l2_topk/ops.py``).  Empty inputs
short-circuit; the kernels take any ``d`` (they mask the ragged depth
tile, which is the same as zero-padding ``d`` — distance-preserving) and
any row counts, so nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._check import cuda_args, ptr, stream_of
from .ref import l2_dist_ref, l2_top1_ref

__all__ = ["l2_dist", "l2_top1"]


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
    l2_dist.rows += n
    l2_dist.tiles[(nq, n)] = l2_dist.tiles.get((nq, n), 0) + 1
    return out


l2_dist.launches = 0
l2_dist.rows = 0             # candidate rows scored, over all launches
l2_dist.tiles = {}           # {(NQ, N): launches}


def l2_top1(queries: torch.Tensor, centroids: torch.Tensor):
    """queries (NQ, d), centroids (K, d) -> (idx (NQ,) i32, val (NQ,) f32).

    The nearest centroid of each row by squared L2 and that distance;
    ties go to the lowest index.  Float inputs of another dtype are cast
    to f32; ``NQ == 0`` or ``K == 0`` gives ``(zeros, +inf)``.  CPU
    tensors take the plain torch version; CUDA tensors launch
    ``csrc/l2_top1.cu`` once on the current stream, which writes no
    distance block.
    """
    if queries.dim() != 2 or centroids.dim() != 2 or \
            queries.shape[1] != centroids.shape[1]:
        raise ValueError(f"l2_top1: shapes {tuple(queries.shape)} and "
                         f"{tuple(centroids.shape)} do not match as (NQ, d), "
                         "(K, d)")
    nq, d = queries.shape
    k = centroids.shape[0]
    if nq == 0 or k == 0:
        return (torch.zeros(nq, dtype=torch.int32, device=queries.device),
                torch.full((nq,), float("inf"), dtype=torch.float32,
                           device=queries.device))
    if queries.device.type == "cpu" and centroids.device.type == "cpu":
        return l2_top1_ref(queries, centroids)
    q = queries.to(torch.float32).contiguous()
    c = centroids.to(torch.float32).contiguous()
    cuda_args("l2_top1", q, c)
    idx = torch.empty(nq, dtype=torch.int32, device=q.device)
    val = torch.empty(nq, dtype=torch.float32, device=q.device)
    lib = _build.library("l2_top1")
    fn = lib.l2_top1_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(q), ptr(c), ptr(idx), ptr(val), nq, k, d, stream_of(idx))
    _build.check(lib, rc, "l2_top1")
    l2_top1.launches += 1
    l2_top1.shapes[(k, d, nq)] = l2_top1.shapes.get((k, d, nq), 0) + 1
    return idx, val


l2_top1.launches = 0
l2_top1.shapes = {}          # {(K, d, rows): launches}
