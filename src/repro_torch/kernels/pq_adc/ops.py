"""Batched PQ asymmetric-distance scan over an arena of codes.

Counterpart of the reference wrapper ``repro.kernels.pq_adc.pq_adc``
(``src/repro/kernels/pq_adc/ops.py``) together with the per-query
``vmap`` the reference scan puts around it: here one call scores a
whole block of per-query tables against the shared arena.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._check import cuda_args, ptr, stream_of
from .ref import pq_adc_ref

__all__ = ["pq_adc", "tables_per_block"]

KSUB = 256
QT_MAX = 8                   # tables per block the kernel can hold
SMEM_BUDGET = 64 << 10       # shared bytes aimed for per block
SMEM_MAX = 227 << 10         # the most one H100 block may take


def tables_per_block(m: int) -> int:
    """Query tables one block keeps in shared memory (1..8) for ``m``
    subquantizers of 256 entries; raises when one table does not fit."""
    table = m * KSUB * 4
    if table > SMEM_MAX:
        raise ValueError(f"pq_adc: a PQ{m}x8 table ({table} B) exceeds one "
                         f"block's shared memory")
    qt = QT_MAX
    while qt > 1 and qt * table > SMEM_BUDGET:
        qt //= 2
    return qt


def pq_adc(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (QB, m, 256) f32, codes (N, m) u8 -> (QB, N) f32 distances.

    ``out[q, r] = sum_j luts[q, j, codes[r, j]]``.  CPU tensors take the
    plain torch version (any integer code dtype); CUDA tensors (f32
    tables, u8 codes) launch ``csrc/pq_adc.cu``.  Empty inputs
    short-circuit.
    """
    if luts.dim() != 3 or codes.dim() != 2 or luts.shape[1] != codes.shape[1]:
        raise ValueError(f"pq_adc: shapes {tuple(luts.shape)} and "
                         f"{tuple(codes.shape)} do not match as "
                         "(QB, m, ksub), (N, m)")
    qb, m, ksub = luts.shape
    n = codes.shape[0]
    if qb == 0 or n == 0:
        return torch.zeros((qb, n), dtype=torch.float32, device=luts.device)
    if luts.device.type == "cpu" and codes.device.type == "cpu":
        return pq_adc_ref(luts, codes)
    cuda_args("pq_adc", luts, codes)
    if luts.dtype != torch.float32 or codes.dtype != torch.uint8 or \
            ksub != KSUB:
        raise TypeError("pq_adc: kernel takes float32 (QB, m, 256) tables "
                        "and uint8 codes")
    qt = tables_per_block(m)
    out = torch.empty((qb, n), dtype=torch.float32, device=luts.device)
    lib = _build.library("pq_adc")
    fn = lib.pq_adc_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(luts), ptr(codes), ptr(out), qb, n, m, qt, stream_of(out))
    _build.check(lib, rc, "pq_adc")
    pq_adc.launches += 1
    return out


pq_adc.launches = 0
