"""Wavelet tree over the cluster-assignment string (paper §3.3 / §4.1).

The IVF id lists jointly form a partition of ``[N)``; instead of storing K
separate lists, index the string ``S in [K)^N`` where ``S[i]`` = cluster of
id ``i``.  The id at offset ``O`` of cluster ``k`` is then
``select_k(S, O)`` — full random access, which is exactly what the paper's
§4.1 search trick needs: the scanner accumulates ``(k, O)`` pairs and only
the final top-k results are resolved to ids.

Structure: one bitvector per level (pointerless, node boundaries kept as a
small per-level offset table).  ``WT`` backs levels with flat
``BitVector``s; ``WT1`` with RRR-compressed ``RRRVector``s (slower select,
better rate on skewed partitions — Table 1's WT vs WT1 trade-off).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .bitvec import BitVector
from .rrr import RRRVector

__all__ = ["WaveletTree"]


@dataclasses.dataclass
class WaveletTree:
    nsyms: int                       # K
    nlevels: int
    length: int                      # N
    levels: List[object]             # BitVector | RRRVector per level
    bounds: List[np.ndarray]         # per level: node start offsets (2^d + 1)
    compressed: bool

    @classmethod
    def build(cls, s: np.ndarray, nsyms: int, compressed: bool = False) -> "WaveletTree":
        s = np.asarray(s, dtype=np.int64)
        if s.size and (s.min() < 0 or s.max() >= nsyms):
            raise ValueError("symbols out of range")
        nlevels = max(1, int(np.ceil(np.log2(max(2, nsyms)))))
        levels: List[object] = []
        bounds: List[np.ndarray] = []
        order = s.copy()  # symbols arranged in current level order
        for d in range(nlevels):
            shift = nlevels - 1 - d
            bit = (order >> shift) & 1
            # node of each element at this level = prefix bits above `shift`
            node = order >> (shift + 1)
            nnodes = 1 << d
            counts = np.bincount(node, minlength=nnodes)
            starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            bounds.append(starts)
            vec = (
                RRRVector.from_bits(bit.astype(np.uint8))
                if compressed
                else BitVector.from_bits(bit.astype(np.uint8))
            )
            levels.append(vec)
            # stable partition within each node for the next level
            key = node * 2 + bit
            order = order[np.argsort(key, kind="stable")]
        return cls(
            nsyms=nsyms,
            nlevels=nlevels,
            length=int(s.size),
            levels=levels,
            bounds=bounds,
            compressed=compressed,
        )

    # -- queries ------------------------------------------------------------
    def access(self, i: int) -> int:
        """S[i]: the cluster of id ``i`` (top-down rank walk)."""
        sym = 0
        pos = i
        for d in range(self.nlevels):
            vec = self.levels[d]
            lo = int(self.bounds[d][sym])
            bit = self._bit(vec, lo + pos)
            ones_before = vec.rank1(lo + pos) - vec.rank1(lo)
            pos = ones_before if bit else (pos - ones_before)
            sym = sym * 2 + bit
        return sym

    @staticmethod
    def _bit(vec, pos: int) -> int:
        return vec.rank1(pos + 1) - vec.rank1(pos)

    def select(self, k: int, occ: int) -> int:
        """Global index of the ``occ``-th (0-based) occurrence of symbol k.

        This is the paper's (cluster, offset) -> id resolution (§4.1).
        """
        if not 0 <= k < self.nsyms:
            raise IndexError("symbol out of range")
        pos = occ
        for d in range(self.nlevels - 1, -1, -1):
            shift = self.nlevels - 1 - d
            bit = (k >> shift) & 1
            node = k >> (shift + 1)
            vec = self.levels[d]
            lo = int(self.bounds[d][node])
            ones_lo = vec.rank1(lo)
            if bit:
                pos = vec.select1(ones_lo + pos) - lo
            else:
                zeros_lo = lo - ones_lo
                pos = vec.select0(zeros_lo + pos) - lo
        return pos

    def select_batch(self, ks: Sequence[int], occs: Sequence[int]) -> np.ndarray:
        return np.array([self.select(int(k), int(o)) for k, o in zip(ks, occs)])

    def cluster_size(self, k: int) -> int:
        # occurrences of k = ones (or zeros) of k's leaf-level node segment
        d = self.nlevels - 1
        node = k >> 1
        vec = self.levels[d]
        lo = int(self.bounds[d][node])
        hi = int(self.bounds[d][node + 1])
        ones = vec.rank1(hi) - vec.rank1(lo)
        return ones if (k & 1) else (hi - lo - ones)

    def decode_cluster(self, k: int) -> np.ndarray:
        """All ids of cluster k, ascending (select is order-preserving)."""
        n = self.cluster_size(k)
        return np.array([self.select(k, o) for o in range(n)], dtype=np.int64)

    # -- sizes ----------------------------------------------------------------
    @property
    def size_bits(self) -> int:
        """Payload bits (paper-comparable, excludes rank/select indexes)."""
        return int(sum(v.size_bits for v in self.levels))

    @property
    def index_bits(self) -> int:
        b = sum(v.index_bits for v in self.levels)
        b += sum(32 * len(x) for x in self.bounds)
        return int(b)

    def bits_per_id(self) -> float:
        return self.size_bits / max(1, self.length)
