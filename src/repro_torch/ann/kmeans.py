"""Lloyd k-means on the index's device (IVF coarse quantizers, PQ codebooks).

``assign`` is the nearest-centroid kernel ``l2_top1``: one launch over
all rows on a CUDA tensor, with no distance block in memory; on a CPU
tensor its plain version, the chunked ``x @ c.T`` plus ``min`` the
reference leaves to XLA (``repro.ann.kmeans``), in full f32 (no TF32).

The centroid update sums each cluster's rows in a fixed order: rows are
sorted stably by cluster and each cluster's contiguous segment is summed
in row order (``segment_reduce``), the order of the reference's
``np.add.at``.  No float atomics are involved, so the same ``x``, ``k``,
``seed`` and ``iters`` give bitwise-equal centroids from run to run on
the card.  Initial and re-seed picks draw from the same numpy generator
as the reference, so the two packages start from the same centroids for
the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.l2_topk import l2_top1

__all__ = ["kmeans", "assign", "assign_t"]


def assign_t(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row, (n,) int64 on ``x``'s device; ties go
    to the lowest centroid index."""
    return l2_top1(x, centroids)[0].to(torch.int64)


def _on(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


def assign(x: np.ndarray, centroids: np.ndarray,
           device="cuda") -> np.ndarray:
    """numpy in/out; the distance work runs on ``device``."""
    dev = resolve_device(device)
    return assign_t(_on(x, dev), _on(centroids, dev)).cpu().numpy()


def _cluster_sums(x: torch.Tensor, a: torch.Tensor,
                  counts: torch.Tensor) -> torch.Tensor:
    """(k, d) per-cluster row sums, each summed in ascending row order."""
    order = torch.argsort(a, stable=True)
    return torch.segment_reduce(x[order], "sum", lengths=counts, axis=0,
                                unsafe=True)


def kmeans(x: np.ndarray, k: int, iters: int = 10, seed: int = 0,
           device="cuda") -> np.ndarray:
    """Returns (k, d) f32 centroids trained on ``x`` (numpy in/out)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    centroids = x[rng.choice(n, size=k, replace=False)].astype(np.float32)
    xt = _on(x, dev)
    ct = _on(centroids, dev)
    for _ in range(iters):
        a = assign_t(xt, ct)
        counts = torch.bincount(a, minlength=k)
        sums = _cluster_sums(xt, a, counts)
        counts = counts.to(torch.float32)
        empty = counts == 0
        counts[empty] = 1.0
        ct = sums / counts[:, None]
        n_empty = int(empty.sum())
        if n_empty:  # re-seed empty clusters on far points
            ct[empty] = _on(x[rng.choice(n, size=n_empty, replace=False)],
                            dev)
    return ct.cpu().numpy()
