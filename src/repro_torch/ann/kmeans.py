"""Lloyd k-means on the index's device (IVF coarse quantizers, PQ codebooks).

``assign`` is a chunked ``x @ c.T`` plus ``argmin`` — a plain matrix
product, which the reference leaves to XLA (``repro.ann.kmeans``) and
the port to ``torch.matmul`` in full f32 (no TF32).  The centroid update
sums with ``index_add_`` in place of ``np.add.at``.  Initial and re-seed
picks draw from the same numpy generator as the reference, so the two
packages start from the same centroids for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["kmeans", "assign", "assign_t"]

ASSIGN_CHUNK = 32768


def assign_t(x: torch.Tensor, centroids: torch.Tensor,
             chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest centroid of each row, (n,) int64 on ``x``'s device; ties go
    to the lowest centroid index."""
    cn = (centroids * centroids).sum(1)[None]
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for i in range(0, x.shape[0], chunk):
        sl = x[i:i + chunk]
        d = (sl * sl).sum(1, keepdim=True) - 2.0 * (sl @ centroids.T) + cn
        out[i:i + chunk] = d.argmin(1)
    return out


def _on(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(device)


def assign(x: np.ndarray, centroids: np.ndarray,
           device="cuda") -> np.ndarray:
    """numpy in/out; the distance work runs on ``device``."""
    dev = resolve_device(device)
    return assign_t(_on(x, dev), _on(centroids, dev)).cpu().numpy()


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
        sums = torch.zeros_like(ct).index_add_(0, a, xt)
        counts = torch.bincount(a, minlength=k).to(torch.float32)
        empty = counts == 0
        counts[empty] = 1.0
        ct = sums / counts[:, None]
        n_empty = int(empty.sum())
        if n_empty:  # re-seed empty clusters on far points
            ct[empty] = _on(x[rng.choice(n, size=n_empty, replace=False)],
                            dev)
    return ct.cpu().numpy()
