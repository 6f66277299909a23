"""Bit-packed vectors with rank/select — substrate for EF, WT and RRR.

Storage is little-endian packed uint8 (``np.packbits(bitorder="little")``);
rank uses byte-popcount cumulative sums sampled per superblock
(``np.bitwise_count`` is a hardware popcount on numpy >= 2.0); select is a
binary search over the sampled ranks.  The sampled structures are reported
as ``index_bits`` and excluded from the paper-comparable payload size,
matching how the paper reports Elias-Fano ("without overheads").
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["BitVector", "pack_lowbits", "unpack_lowbits"]

_SUPER = 64  # bytes per superblock (512 bits)


@dataclasses.dataclass
class BitVector:
    data: np.ndarray      # packed uint8, little-endian bit order
    nbits: int

    def __post_init__(self) -> None:
        counts = np.bitwise_count(self.data).astype(np.int64)
        # cumulative popcount before each superblock boundary
        self._byte_cum = np.concatenate([[0], np.cumsum(counts)])
        self.nones = int(self._byte_cum[-1])

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "BitVector":
        bits = np.asarray(bits, dtype=np.uint8)
        return cls(np.packbits(bits, bitorder="little"), int(bits.size))

    @classmethod
    def from_positions(cls, positions: np.ndarray, nbits: int) -> "BitVector":
        bits = np.zeros(nbits, dtype=np.uint8)
        bits[np.asarray(positions, dtype=np.int64)] = 1
        return cls(np.packbits(bits, bitorder="little"), nbits)

    def bits(self) -> np.ndarray:
        return np.unpackbits(self.data, bitorder="little")[: self.nbits]

    def one_positions(self) -> np.ndarray:
        return np.flatnonzero(self.bits()).astype(np.int64)

    # -- rank / select -----------------------------------------------------
    def rank1(self, pos: int) -> int:
        """Number of 1 bits in [0, pos)."""
        if pos <= 0:
            return 0
        pos = min(pos, self.nbits)
        byte, rem = divmod(pos, 8)
        r = int(self._byte_cum[byte])
        if rem:
            r += int(np.bitwise_count(self.data[byte] & ((1 << rem) - 1)))
        return r

    def rank1_batch(self, pos: np.ndarray) -> np.ndarray:
        pos = np.clip(np.asarray(pos, dtype=np.int64), 0, self.nbits)
        byte, rem = np.divmod(pos, 8)
        r = self._byte_cum[byte]
        partial = np.bitwise_count(
            self.data[np.minimum(byte, len(self.data) - 1)]
            & ((1 << rem.astype(np.uint8)) - 1).astype(np.uint8)
        ).astype(np.int64)
        return r + np.where(rem > 0, partial, 0)

    def rank0(self, pos: int) -> int:
        return min(pos, self.nbits) - self.rank1(pos)

    def select1(self, j: int) -> int:
        """Position of the j-th (0-based) 1 bit."""
        if not 0 <= j < self.nones:
            raise IndexError("select1 out of range")
        byte = int(np.searchsorted(self._byte_cum, j + 1, side="left")) - 1
        rem = j - int(self._byte_cum[byte])
        b = int(self.data[byte])
        for bit in range(8):
            if (b >> bit) & 1:
                if rem == 0:
                    return byte * 8 + bit
                rem -= 1
        raise AssertionError("select1 internal error")

    def select0(self, j: int) -> int:
        """Position of the j-th (0-based) 0 bit."""
        nzeros = self.nbits - self.nones
        if not 0 <= j < nzeros:
            raise IndexError("select0 out of range")
        # binary search on rank0(byte*8) = byte*8 - byte_cum[byte]
        zero_cum = np.arange(len(self._byte_cum), dtype=np.int64) * 8 - self._byte_cum
        byte = int(np.searchsorted(zero_cum, j + 1, side="left")) - 1
        rem = j - int(zero_cum[byte])
        b = int(self.data[byte])
        for bit in range(8):
            if not (b >> bit) & 1:
                if byte * 8 + bit >= self.nbits:
                    break
                if rem == 0:
                    return byte * 8 + bit
                rem -= 1
        raise AssertionError("select0 internal error")

    @property
    def size_bits(self) -> int:
        """Payload size (the raw bits), paper-comparable."""
        return self.nbits

    @property
    def index_bits(self) -> int:
        """Rank/select acceleration structures (sampled at _SUPER bytes)."""
        return 32 * (len(self._byte_cum) // _SUPER + 1)


def pack_lowbits(vals: np.ndarray, l: int) -> np.ndarray:
    """Pack the low ``l`` bits of each value into a little-endian bit stream."""
    if l == 0:
        return np.zeros(0, dtype=np.uint8)
    vals = np.asarray(vals, dtype=np.int64)
    bits = ((vals[:, None] >> np.arange(l)) & 1).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little")


def unpack_lowbits(
    packed: np.ndarray, l: int, n: int, start: int = 0, count: int | None = None
) -> np.ndarray:
    """Unpack ``count`` l-bit values starting at index ``start``."""
    if count is None:
        count = n - start
    if l == 0:
        return np.zeros(count, dtype=np.int64)
    bits = np.unpackbits(packed, bitorder="little", count=n * l)
    seg = bits[start * l : (start + count) * l].reshape(count, l).astype(np.int64)
    return (seg << np.arange(l)).sum(axis=1)
