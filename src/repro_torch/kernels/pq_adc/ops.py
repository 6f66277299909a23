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

__all__ = ["pq_adc", "tables_per_block", "chunk_plan"]

KSUB = 256
QT_CHOICES = (16, 8, 4, 2, 1)    # queries one block can hold
SPAN_BYTES = 32768               # codes one ring stage of the kernel holds
SMEM_MAX = 227 << 10             # the most one H100 block may take
# below this many code rows a block holds at most 8 queries' tables: each
# block loads its tables once, and on an H100 (64 queries, m = 8) 16 tables
# a block lost to 8 at 95,350 rows and won from 500,000 rows on
QT16_MIN_ROWS = 1 << 18
# the most subquantizers one launch scores: one table of 256 f32 entries
# a subquantizer must fit a block (m * 1 KB <= 227 KB)
M_LAUNCH_MAX = SMEM_MAX // (KSUB * 4)
# subquantizers a launch scores past M_LAUNCH_MAX: 16, where 8 tables a
# block fit beside a full code ring and every warp of a span has rows.
# On an H100 (64 queries, m = 256, 2^20 codes; tools/ab_kernels.py) chunks
# of 16 took 6.9 ms, of 8 8.7, of 32 9.2, of 64 16.3, of 128 47.3
M_CHUNK = 16


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


def chunk_plan(m: int) -> list:
    """The subquantizer ranges ``[(j0, j1), ...]`` of one call, one launch
    each, in j order: all of ``m`` at once where its tables fit a block
    (m <= 227), else chunks of ``M_CHUNK`` (the last one shorter).  A
    later launch adds onto the earlier ones' partial sums, so the result
    is bitwise the j-ordered f32 sum over all m."""
    if m <= M_LAUNCH_MAX:
        return [(0, m)]
    return [(j0, min(m, j0 + M_CHUNK)) for j0 in range(0, m, M_CHUNK)]


def pq_adc(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (QB, m, 256) f32, codes (N, m) u8 -> (QB, N) f32 distances.

    ``out[q, r] = sum_j luts[q, j, codes[r, j]]``.  CPU tensors take the
    plain torch version (any integer code dtype); CUDA tensors (f32
    tables, u8 codes) launch ``csrc/pq_adc.cu`` once for each chunk of
    :func:`chunk_plan` (once for any m <= 227).  Empty inputs
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
    out = torch.empty((qb, n), dtype=torch.float32, device=luts.device)
    for j0, j1 in chunk_plan(m):
        if j1 - j0 == m:
            launch(luts, codes, out, accumulate=False)
        else:
            launch(luts[:, j0:j1].contiguous(), codes[:, j0:j1].contiguous(),
                   out, accumulate=j0 > 0)
    return out


def launch(luts: torch.Tensor, codes: torch.Tensor, out: torch.Tensor,
           accumulate: bool) -> None:
    """One launch of ``csrc/pq_adc.cu`` on contiguous CUDA tensors: luts
    (QB, mc, 256) f32 and codes (N, mc) u8 with mc <= 227.  It writes
    ``out[q, r] = s + sum_j luts[q, j, codes[r, j]]``, the j-ordered f32
    sum started from ``s = out[q, r]`` (``accumulate``) or from 0.
    :func:`pq_adc` calls it once for each chunk of :func:`chunk_plan`."""
    qb, mc, _ = luts.shape
    n = codes.shape[0]
    qt = tables_per_block(mc)
    if n < QT16_MIN_ROWS:
        qt = min(qt, 8)
    lib = _build.library("pq_adc")
    fn = lib.pq_adc_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(luts), ptr(codes), ptr(out), qb, n, mc, qt, int(accumulate),
            stream_of(out))
    _build.check(lib, rc, "pq_adc")
    pq_adc.launches += 1
    pq_adc.rows += n


pq_adc.launches = 0
pq_adc.rows = 0              # code rows scored, over all launches
