"""Plain torch version of the batched PQ ADC scan (gathers)."""

from __future__ import annotations

import torch

__all__ = ["pq_adc_ref"]


def pq_adc_ref(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """luts (QB, m, ksub) f32, codes (N, m) int -> (QB, N) f32.

    The sequential j-ordered f32 sum ``0 + lut[0, c0] + lut[1, c1] + ...``,
    one (QB, N) gather a subquantizer: bitwise the sum the CUDA kernel
    computes, on either device.
    """
    qb, m, _ = luts.shape
    n = codes.shape[0]
    idx = codes.to(torch.int64)
    luts = luts.to(torch.float32)
    out = torch.zeros((qb, n), dtype=torch.float32, device=luts.device)
    for j in range(m):
        out += luts[:, j, idx[:, j]]
    return out
