"""Plain torch version of batched bitvector rank (the CPU path and the
oracle the CUDA kernel is held against)."""

from __future__ import annotations

import torch

__all__ = ["wt_rank_ref"]


def wt_rank_ref(words: torch.Tensor, super_cum: torch.Tensor,
                queries: torch.Tensor) -> torch.Tensor:
    """``rank1(q)`` by unpacking every bit, a cumsum and a gather.

    ``words`` (W,) int32 bit patterns of the u32 words; ``queries`` (Q,)
    positions.  A query outside ``[0, 32 W]`` or past the last superblock
    of ``super_cum`` gives -1, as in the kernel.  ``super_cum`` is read
    only for that check: the counts come from the words alone.
    """
    shifts = torch.arange(32, device=words.device, dtype=torch.int64)
    bits = (words.to(torch.int64)[:, None] >> shifts) & 1
    cum = torch.cat([torch.zeros(1, dtype=torch.int64, device=words.device),
                     torch.cumsum(bits.reshape(-1), 0)])
    q = queries.to(torch.int64)
    ok = (q >= 0) & (q <= 32 * words.shape[0]) & \
        ((q >> 9) < super_cum.shape[0])
    got = cum[torch.where(ok, q, 0)]
    return torch.where(ok, got, -1).to(torch.int32)
