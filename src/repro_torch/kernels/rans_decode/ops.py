"""Interleaved-lane rANS decode (32/16 variant) with a static pmf.

Counterpart of the reference's ``repro.kernels.rans_decode`` (``ops.py``):
``make_tables`` is a numpy copy of its table builder, and ``rans_decode``
decodes the stream that :class:`repro_torch.core.vrans.VRans16Encoder`
writes when ``L`` lanes push one symbol each per row, rows in reverse.

torch's ``uint32`` has little operator support, so the wrapper carries
the u32 lane heads as **int32 bit patterns**
(``heads.view(np.int32)``), and the 16-bit words as int32 values; the
kernel reads both back as u32.  The reference pads ``words`` with ``L``
zero words so that masked gathers stay in bounds; here a word index past
the end reads 0 and nothing is padded.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._check import COUNT_LOCK, cuda_args, ptr, stream_of
from .ref import rans_decode_ref

__all__ = ["make_tables", "rans_decode"]

MAX_LANES = 1024   # at most 8 decode warps of 4 lanes a thread


def make_tables(freqs: np.ndarray, r: int):
    """freqs (A,) summing to 2^r -> (slot->sym, slot->freq, slot->start),
    each (2^r,) int32."""
    freqs = np.asarray(freqs)
    if int(freqs.sum()) != (1 << r):
        raise ValueError(f"make_tables: freqs sum to {int(freqs.sum())}, "
                         f"not 2^{r}")
    starts = np.cumsum(freqs) - freqs
    sym_t = np.repeat(np.arange(len(freqs)), freqs).astype(np.int32)
    freq_t = freqs[sym_t].astype(np.int32)
    start_t = starts[sym_t].astype(np.int32)
    return sym_t, freq_t, start_t


def rans_decode(heads: torch.Tensor, words: torch.Tensor,
                sym_t: torch.Tensor, freq_t: torch.Tensor,
                start_t: torch.Tensor, rows: int, r: int) -> torch.Tensor:
    """Decode ``rows`` symbols on each of ``L`` lanes -> (rows, L) int32.

    heads (L,) int32 (u32 bit patterns), words (W,) int32 (16-bit
    values), tables (2^r,) int32 from :func:`make_tables`, ``r`` in
    [1, 16].  CPU tensors take the plain step loop; CUDA tensors launch
    ``csrc/rans_decode.cu`` (one block; one decode warp up to 64 lanes,
    else up to 8, ``L <= 1024``), bit-equal to it.
    """
    rows, r = int(rows), int(r)
    if not 1 <= r <= 16:
        raise ValueError(f"rans_decode: precision r={r} is not in [1, 16]")
    if heads.dim() != 1 or words.dim() != 1:
        raise ValueError("rans_decode: heads and words are 1-D")
    for t in (sym_t, freq_t, start_t):
        if t.shape != (1 << r,):
            raise ValueError(f"rans_decode: tables must be (2^{r},), got "
                             f"{tuple(t.shape)}")
    L = heads.shape[0]
    if rows < 0:
        raise ValueError("rans_decode: rows must be >= 0")
    if rows == 0 or L == 0:
        return torch.zeros((rows, L), dtype=torch.int32, device=heads.device)
    args = (heads, words, sym_t, freq_t, start_t)
    if all(t.device.type == "cpu" for t in args):
        return rans_decode_ref(*args, rows=rows, r=r)
    cuda_args("rans_decode", *args)
    if any(t.dtype != torch.int32 for t in args):
        raise TypeError("rans_decode: kernel takes int32 heads (u32 bit "
                        "patterns), words and tables")
    if L > MAX_LANES:
        raise ValueError(f"rans_decode: kernel takes at most {MAX_LANES} "
                         f"lanes, got {L}")
    out = torch.empty((rows, L), dtype=torch.int32, device=heads.device)
    lib = _build.library("rans_decode")
    rc = lib.rans_decode_launch(*(ptr(t) for t in args), ptr(out), L,
                                words.shape[0], rows, r, stream_of(out))
    _build.check(lib, rc, "rans_decode")
    with COUNT_LOCK:
        rans_decode.launches += 1
    return out


rans_decode.launches = 0
