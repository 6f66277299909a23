"""Segmented top-k select over padded per-query candidate rows.

Contract (that of ``repro.kernels.seg_topk``)::

    seg_topk(dists (NQ, N), lens (NQ,), k) -> (vals (NQ, k) f32 ascending,
                                               idx  (NQ, k) i32)

Row ``i``'s columns at or past ``lens[i]`` (clamped to ``N``) count as
``+inf``; when ``k > N`` the row is widened with ``+inf`` columns.
Selection order is the lexicographic ``(value asc, column asc)``
minimum, ties at ``+inf`` included, so slots past the real candidates
come back as ``val=+inf`` pointing at the lowest masked columns; callers
separate real ``+inf`` hits from padding by ``idx < lens[i]``.
``torch.topk`` is not used anywhere: its tie order is unspecified.
NaN sorts after ``+inf`` (padding included), every NaN tied by column.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._check import cuda_args, ptr, stream_of
from .ref import seg_topk_ref

__all__ = ["seg_topk"]

SORT_CHUNK = 4096            # u64 entries the kernel sorts in shared memory


def seg_topk(dists: torch.Tensor, lens: torch.Tensor, k: int):
    """CPU tensors take the plain stable sort; CUDA tensors (f32 dists,
    i32 lens) launch ``csrc/seg_topk.cu``, bit-identical to it."""
    if dists.dim() != 2 or lens.dim() != 1 or lens.shape[0] != dists.shape[0]:
        raise ValueError(f"seg_topk: shapes {tuple(dists.shape)} and "
                         f"{tuple(lens.shape)} do not match as (NQ, N), (NQ,)")
    nq, n = dists.shape
    k = int(k)
    if nq == 0 or k == 0:
        return (torch.full((nq, k), float("inf"), dtype=torch.float32,
                           device=dists.device),
                torch.zeros((nq, k), dtype=torch.int32, device=dists.device))
    if dists.device.type == "cpu" and lens.device.type == "cpu":
        return seg_topk_ref(dists, lens.clamp(max=n), k)
    cuda_args("seg_topk", dists, lens)
    if dists.dtype != torch.float32 or lens.dtype != torch.int32:
        raise TypeError("seg_topk: kernel takes float32 dists and int32 lens")
    vals = torch.empty((nq, k), dtype=torch.float32, device=dists.device)
    idx = torch.empty((nq, k), dtype=torch.int32, device=dists.device)
    # past SORT_CHUNK the kernel sorts the k selected keys in global memory
    kpad = max(2, 1 << (k - 1).bit_length())
    scratch = (torch.empty((nq, kpad), dtype=torch.int64, device=dists.device)
               if kpad > SORT_CHUNK else None)
    lib = _build.library("seg_topk")
    fn = lib.seg_topk_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(dists), ptr(lens), ptr(vals), ptr(idx),
            None if scratch is None else ptr(scratch), nq, n, k,
            stream_of(vals))
    _build.check(lib, rc, "seg_topk")
    seg_topk.launches += 1
    seg_topk.shapes[(n, k)] = seg_topk.shapes.get((n, k), 0) + 1
    seg_topk.tiles[(nq, n, k)] = seg_topk.tiles.get((nq, n, k), 0) + 1
    return vals, idx


seg_topk.launches = 0
seg_topk.shapes = {}         # {(n, k): launches}
seg_topk.tiles = {}          # {(NQ, n, k): launches}
