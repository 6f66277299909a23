"""Blocked sorted list with O(sqrt n)-ish rank-insert.

Used by the REC decoder, which must maintain the sorted multiset of decoded
edges and report each insertion rank (hundreds of thousands of inserts —
a flat ``list.insert`` would be quadratic).  Blocks are plain Python lists
(C memmove on insert); a Fenwick over block sizes gives the global rank.
"""

from __future__ import annotations

import bisect
from typing import List

from .fenwick import Fenwick

__all__ = ["SortedList"]

_BLOCK = 1024


class SortedList:
    def __init__(self) -> None:
        self._blocks: List[List[int]] = [[]]
        self._maxs: List[int] = []           # max key per block (parallel)
        self._sizes = Fenwick([0])
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def insert(self, key) -> int:
        """Insert ``key``; returns its rank (bisect_left position)."""
        if self._len == 0:
            self._blocks[0].append(key)
            self._maxs = [key]
            self._sizes.add(0, 1)
            self._len = 1
            return 0
        bi = bisect.bisect_left(self._maxs, key)
        if bi == len(self._blocks):
            bi -= 1
        blk = self._blocks[bi]
        pos = bisect.bisect_left(blk, key)
        rank = self._sizes.cum(bi) + pos
        blk.insert(pos, key)
        self._sizes.add(bi, 1)
        if key > self._maxs[bi]:
            self._maxs[bi] = key
        self._len += 1
        if len(blk) >= 2 * _BLOCK:
            self._split(bi)
        return rank

    def _split(self, bi: int) -> None:
        blk = self._blocks[bi]
        mid = len(blk) // 2
        left, right = blk[:mid], blk[mid:]
        self._blocks[bi] = left
        self._blocks.insert(bi + 1, right)
        self._maxs[bi] = left[-1]
        self._maxs.insert(bi + 1, right[-1])
        # rebuild the size Fenwick (rare: amortized O(sqrt n) splits)
        self._sizes = Fenwick([len(b) for b in self._blocks])

    def to_list(self) -> List:
        out: List = []
        for b in self._blocks:
            out.extend(b)
        return out
