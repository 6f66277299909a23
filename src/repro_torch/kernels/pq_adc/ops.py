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
QT_CHOICES = (16, 8, 4, 2, 1)    # queries one block can hold
SPAN_BYTES = 32768               # codes one ring stage of the kernel holds
SMEM_MAX = 227 << 10             # the most one H100 block may take
# below this many code rows a block holds at most 8 queries' tables: each
# block loads its tables once, and on an H100 (64 queries, m = 8) 16 tables
# a block lost to 8 at 95,350 rows and won from 500,000 rows on
QT16_MIN_ROWS = 1 << 18


def ring_rows(m: int, qt: int) -> int:
    """Code rows one ring stage of ``csrc/pq_adc.cu`` holds beside ``qt``
    tables (as the kernel computes it): SPAN_BYTES of codes, fewer where
    the tables leave less room, 0 where not even 16 rows fit (the kernel
    then reads the codes from global memory)."""
    want = max(128, (SPAN_BYTES // m) & ~127)
    room = SMEM_MAX - m * KSUB * qt * 4 - 16
    rows = min(want, (room // (2 * m)) & ~15) if room > 0 else 0
    return rows if rows >= 16 else 0


def tables_per_block(m: int) -> int:
    """Query tables one block keeps in shared memory for ``m``
    subquantizers of 256 entries: the most of 16, 8, 4 or 2 that fit
    beside a full ring of codes, else 1 (for any m up to 227, with a
    shorter ring or none); raises when one table does not fit."""
    full = max(128, (SPAN_BYTES // m) & ~127)
    for qt in QT_CHOICES[:-1]:
        if ring_rows(m, qt) == full:
            return qt
    if m * KSUB * 4 <= SMEM_MAX:
        return 1
    raise ValueError(f"pq_adc: a PQ{m}x8 table ({m * KSUB * 4} B) exceeds "
                     f"one block's shared memory")


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
    if n < QT16_MIN_ROWS:
        qt = min(qt, 8)
    out = torch.empty((qb, n), dtype=torch.float32, device=luts.device)
    lib = _build.library("pq_adc")
    fn = lib.pq_adc_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(luts), ptr(codes), ptr(out), qb, n, m, qt, stream_of(out))
    _build.check(lib, rc, "pq_adc")
    pq_adc.launches += 1
    pq_adc.rows += n
    return out


pq_adc.launches = 0
pq_adc.rows = 0              # code rows scored, over all launches
