"""Plain torch version of the interleaved rANS decoder (the CPU path and
the oracle the CUDA kernel is held against)."""

from __future__ import annotations

import torch

__all__ = ["rans_decode_ref"]

_U32 = 0xFFFFFFFF


def rans_decode_ref(heads: torch.Tensor, words: torch.Tensor,
                    sym_t: torch.Tensor, freq_t: torch.Tensor,
                    start_t: torch.Tensor, rows: int, r: int) -> torch.Tensor:
    """The reference oracle's step loop, one Python iteration per row.

    Each step decodes one symbol per lane with u32 arithmetic (carried in
    int64 and wrapped to 32 bits), then refills every lane whose head fell
    below 2^16 with the next word, in lane order (an exclusive prefix sum
    over the need mask).  A word index past the end of ``words`` reads 0,
    as the reference's zero slack does.  Returns (rows, L) int32.
    """
    dev = heads.device
    h = heads.to(torch.int64) & _U32
    w = words.to(torch.int64) & _U32
    sym_t = sym_t.to(torch.int64)
    freq_t = freq_t.to(torch.int64) & _U32
    start_t = start_t.to(torch.int64) & _U32
    n_words = w.shape[0]
    mask = (1 << r) - 1
    ptr = torch.zeros((), dtype=torch.int64, device=dev)
    out = torch.empty((rows, h.shape[0]), dtype=torch.int32, device=dev)
    for t in range(rows):
        cf = h & mask
        out[t] = sym_t[cf].to(torch.int32)
        h = (freq_t[cf] * (h >> r) + cf - start_t[cf]) & _U32
        need = h < (1 << 16)
        k = torch.cumsum(need, 0) - need.to(torch.int64)
        idx = ptr + k
        ok = need & (idx < n_words)
        got = w[torch.where(ok, idx, 0)] if n_words else torch.zeros_like(h)
        h = torch.where(need, ((h << 16) | torch.where(ok, got, 0)) & _U32, h)
        ptr = ptr + need.sum()
    return out
