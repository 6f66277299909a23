"""Fenwick (binary indexed) tree for order statistics and adaptive CDFs.

Used by:
  * ROC for O(log n) select-by-rank / remove on large clusters
    (``repro.core.roc``),
  * the REC Pólya-urn vertex model (``repro.core.rec``), where it stores
    per-vertex occurrence weights and answers ``cum(v)``, ``find(cf)``
    queries — this is the structure the paper identifies as the dominant
    runtime cost of ANS-based id coding (Section 5.2).

Pure-Python ints; the tree size is a power of two for branch-free ``find``.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

__all__ = ["Fenwick"]


class Fenwick:
    """Prefix-sum tree over ``n`` slots of non-negative integer weights."""

    __slots__ = ("n", "size", "tree", "total")

    def __init__(self, weights: Iterable[int] | int):
        if isinstance(weights, int):
            w: List[int] = [0] * weights
        else:
            w = [int(x) for x in weights]
        self.n = len(w)
        size = 1
        while size < self.n:
            size <<= 1
        self.size = size
        # O(size) build: tree[i] covers (i - lowbit(i), i]; propagation must
        # run over ALL tree nodes (including those above n) so internal
        # nodes beyond the data range carry complete partial sums.
        tree = [0] * (size + 1)
        tree[1 : self.n + 1] = w
        for i in range(1, size):
            j = i + (i & (-i))
            if j <= size:
                tree[j] += tree[i]
        self.tree = tree
        self.total = sum(w)

    @classmethod
    def ones(cls, n: int) -> "Fenwick":
        return cls([1] * n)

    def add(self, i: int, delta: int) -> None:
        """Add ``delta`` to slot ``i``."""
        self.total += delta
        i += 1
        while i <= self.size:
            self.tree[i] += delta
            i += i & (-i)

    def cum(self, i: int) -> int:
        """Sum of weights of slots ``< i`` (exclusive prefix sum)."""
        s = 0
        while i > 0:
            s += self.tree[i]
            i -= i & (-i)
        return s

    def get(self, i: int) -> int:
        return self.cum(i + 1) - self.cum(i)

    def find(self, cf: int) -> int:
        """Largest ``i`` such that ``cum(i) <= cf``; i.e. the slot whose
        cumulative interval ``[cum(i), cum(i)+w_i)`` contains ``cf``."""
        pos = 0
        half = self.size
        rem = cf
        tree = self.tree
        while half > 0:
            nxt = pos + half
            if nxt <= self.size and tree[nxt] <= rem:
                rem -= tree[nxt]
                pos = nxt
            half >>= 1
        return pos  # 0-based slot

    def to_array(self) -> np.ndarray:
        return np.array([self.get(i) for i in range(self.n)], dtype=np.int64)
