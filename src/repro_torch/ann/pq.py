"""Product Quantizer (Jegou et al.) — train / encode / ADC tables.

``PQmxb``: m subquantizers of b bits (default 8 -> 256 centroids each).
Training and encoding run their distance work on ``device``
(:mod:`repro_torch.ann.kmeans`).  ``adc_tables`` and ``adc_score`` stay
numpy: they are the exact scalar path the oracle and the scan's exact
re-score decide with, the same expressions as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .kmeans import assign, kmeans

__all__ = ["ProductQuantizer"]


@dataclasses.dataclass
class ProductQuantizer:
    m: int
    bits: int
    codebooks: np.ndarray | None = None  # (m, 2^bits, d_sub)
    device: str = "cuda"

    @property
    def ksub(self) -> int:
        return 1 << self.bits

    def train(self, x: np.ndarray, iters: int = 8, seed: int = 0) -> "ProductQuantizer":
        n, d = x.shape
        if d % self.m:
            raise ValueError(f"PQ{self.m}: dim {d} is not a multiple of m")
        dsub = d // self.m
        cb = np.zeros((self.m, self.ksub, dsub), np.float32)
        for j in range(self.m):
            sub = x[:, j * dsub : (j + 1) * dsub].astype(np.float32)
            cb[j] = kmeans(sub, self.ksub, iters=iters, seed=seed + j,
                           device=self.device)
        self.codebooks = cb
        return self

    def encode(self, x: np.ndarray) -> np.ndarray:
        n, d = x.shape
        dsub = d // self.m
        codes = np.zeros((n, self.m), np.uint8 if self.bits <= 8 else np.uint16)
        for j in range(self.m):
            sub = x[:, j * dsub : (j + 1) * dsub].astype(np.float32)
            codes[:, j] = assign(sub, self.codebooks[j], device=self.device)
        return codes

    def decode(self, codes: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [self.codebooks[j][codes[:, j]] for j in range(self.m)], axis=1
        )

    def adc_tables(self, queries: np.ndarray) -> np.ndarray:
        """(nq, m, 2^bits) squared-distance lookup tables."""
        nq, d = queries.shape
        dsub = d // self.m
        tabs = np.zeros((nq, self.m, self.ksub), np.float32)
        for j in range(self.m):
            qs = queries[:, j * dsub : (j + 1) * dsub]
            diff = qs[:, None, :] - self.codebooks[j][None]
            tabs[:, j] = np.einsum("qkd,qkd->qk", diff, diff)
        return tabs

    @staticmethod
    def adc_score(codes: np.ndarray, table: np.ndarray) -> np.ndarray:
        """codes (n, m) + one query's table (m, 2^bits) -> (n,) distances."""
        m = codes.shape[1]
        return table[np.arange(m)[None, :], codes.astype(np.int64)].sum(axis=1)
