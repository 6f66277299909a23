"""Plain torch version of the batched PQ ADC scan (gathers)."""

from __future__ import annotations

import torch

__all__ = ["pq_adc_ref"]


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (QB, m, ksub) f32, codes (N, m) int -> (QB, N) f32.

    One query at a time, so peak memory is one (N, m) gather, not the
    (QB, N, m) cube.
    """
    qb, m, _ = luts.shape
    n = codes.shape[0]
    idx = codes.to(torch.int64)
    sub = torch.arange(m, device=codes.device)[None, :]
    out = torch.empty((qb, n), dtype=torch.float32, device=luts.device)
    for q in range(qb):
        out[q] = luts[q].to(torch.float32)[sub, idx].sum(1)
    return out
