"""Synthetic datasets with controlled statistics (DESIGN.md §9).

The original SIFT1M/Deep1M/FB-ssnpp are not downloadable offline; id
compression rates depend only on (N, K, cluster-size distribution), which a
GMM with matched imbalance reproduces; PQ-code compressibility (Fig 3)
depends on within-cluster vector concentration, which ``concentration``
controls.  Three presets mirror the paper's datasets:

  * ``sift-like``  — 128-d, blockwise structure (4x4x8 gradient histograms
                     approximated by non-isotropic block covariances),
                     strong cluster concentration (codes compressible);
  * ``deep-like``  — 96-d isotropic GMM, milder concentration;
  * ``ssnpp-like`` — 256-d, heavy-tailed cluster sizes, near-uniform codes
                     (the "hard to exploit" regime the paper reports).
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "make_tokens", "PRESETS"]

PRESETS = {
    "sift-like": dict(d=128, n_modes=2048, concentration=0.25, block=8, heavy=False),
    "deep-like": dict(d=96, n_modes=2048, concentration=0.45, block=0, heavy=False),
    "ssnpp-like": dict(d=256, n_modes=2048, concentration=0.9, block=0, heavy=True),
}


def make_dataset(preset: str, n: int, n_queries: int = 1000, seed: int = 0):
    """Returns (base (n,d) f32, queries (nq,d) f32)."""
    p = PRESETS[preset]
    rng = np.random.default_rng(seed)
    d, modes = p["d"], p["n_modes"]
    centers = rng.standard_normal((modes, d)).astype(np.float32)
    if p["heavy"]:
        w = rng.pareto(1.2, size=modes) + 0.05
    else:
        w = rng.gamma(4.0, 1.0, size=modes) + 0.05
    w = w / w.sum()

    def sample(count):
        which = rng.choice(modes, size=count, p=w)
        pts = centers[which]
        noise = rng.standard_normal((count, d)).astype(np.float32)
        if p["block"]:
            # blockwise scaling: later dims within a block get less energy
            scale = np.tile(
                np.linspace(1.0, 0.35, p["block"]), d // p["block"]
            ).astype(np.float32)
            noise *= scale[None]
        return pts + p["concentration"] * noise

    return sample(n), sample(n_queries)


def make_tokens(n_tokens: int, vocab: int, seed: int = 0, zipf_a: float = 1.2):
    """Zipfian token stream for LM training examples."""
    rng = np.random.default_rng(seed)
    ranks = rng.zipf(zipf_a, size=n_tokens)
    return np.minimum(ranks - 1, vocab - 1).astype(np.int32)
