"""Plain torch version of the segmented top-k: one stable sort over the
masked row, so ties (``+inf`` included) keep ascending-column order."""

from __future__ import annotations

import torch

__all__ = ["seg_topk_ref"]


def seg_topk_ref(dists: torch.Tensor, lens: torch.Tensor, k: int):
    """dists (NQ, N), lens (NQ,) -> (vals (NQ, k) f32, idx (NQ, k) i32)."""
    nq, n = dists.shape
    cols = torch.arange(n, device=dists.device)[None, :]
    masked = torch.where(cols < lens.to(dists.device)[:, None].to(torch.int64),
                         dists.to(torch.float32),
                         torch.tensor(float("inf"), device=dists.device))
    if n < k:                                # widen with masked columns
        masked = torch.nn.functional.pad(masked, (0, k - n),
                                         value=float("inf"))
    vals, order = torch.sort(masked, dim=1, stable=True)
    return vals[:, :k].contiguous(), order[:, :k].to(torch.int32)
