"""Elias-Fano coding of monotone id sequences (paper baseline, Appendix A.1).

For n sorted ids with universe u: the low ``l = max(0, floor(log2(u/n)))``
bits are concatenated verbatim; the high parts ``ids >> l`` are coded in
unary into a bitvector of ``n + (u >> l) + 1`` bits (bit ``(ids[i] >> l) + i``
is set).  Total ~= ``n * (2 + log2(u/n))`` bits — within 0.56 bits/id of the
set bound for large n.  ``access(i)`` needs ``select1(i)`` on the high
bitvector; we keep a sampled select index (counted in the overhead figure,
excluded from the paper-comparable ``size_bits`` like the paper does:
"the sum of bits in both bit streams ... without overheads").
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .bitvec import BitVector, pack_lowbits, unpack_lowbits

__all__ = ["EliasFano"]


@dataclasses.dataclass
class EliasFano:
    n: int
    universe: int
    l: int
    low: np.ndarray        # packed low bits (uint64 words)
    high: BitVector        # unary-coded high parts

    @classmethod
    def encode(cls, ids: np.ndarray, universe: int) -> "EliasFano":
        ids = np.sort(np.asarray(ids, dtype=np.int64))
        n = int(ids.size)
        if n and (ids[0] < 0 or ids[-1] >= universe):
            raise ValueError("ids out of range")
        l = max(0, int(np.floor(np.log2(universe / n)))) if n else 0
        low = pack_lowbits(ids & ((1 << l) - 1), l) if n else np.zeros(0, np.uint64)
        high_positions = (ids >> l) + np.arange(n)
        nbits = int(n + (universe >> l) + 1)
        high = BitVector.from_positions(high_positions, nbits)
        return cls(n=n, universe=universe, l=l, low=low, high=high)

    def decode(self) -> np.ndarray:
        if self.n == 0:
            return np.zeros(0, dtype=np.int64)
        ones = self.high.one_positions()
        highs = ones - np.arange(self.n)
        lows = unpack_lowbits(self.low, self.l, self.n)
        return (highs << self.l) | lows

    def access(self, i: int) -> int:
        """Random access to the i-th smallest id (select on the high bits)."""
        pos = self.high.select1(i)
        high = pos - i
        low = int(unpack_lowbits(self.low, self.l, self.n, i, 1)[0]) if self.l else 0
        return (high << self.l) | low

    @property
    def size_bits(self) -> int:
        """Paper-comparable size: both bit streams, no rank/select overhead."""
        return self.n * self.l + self.high.nbits

    @property
    def size_bits_with_overheads(self) -> int:
        return self.size_bits + self.high.index_bits
