"""RRR-style compressed bitvector (class/offset enumerative coding).

Backs the paper's ``WT1`` variant (Raman-Raman-Rao [46] as used by SDSL's
``rrr_vector``): the bitvector is cut into B=31-bit blocks; each block
stores its *class* c = popcount (5 bits, fixed width) and its *offset* —
the enumerative rank of the block's pattern among all C(31, c) patterns —
in ``ceil(log2 C(31, c))`` bits.  Biased blocks (c near 0 or 31) cost ~0
offset bits, which is where the compression over a flat bitvector comes
from; perfectly balanced blocks cost slightly more than 1 bit/bit.
Superblock samples (rank + offset-stream position every 16 blocks) give
O(1)-ish rank; they are counted in ``index_bits``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RRRVector"]

_B = 31                 # block size in bits
_CLASS_BITS = 5
_SUPER = 16             # blocks per superblock

# Pascal triangle up to 31; C[n, k]
_C = np.zeros((_B + 1, _B + 1), dtype=np.int64)
_C[:, 0] = 1
for _n in range(1, _B + 1):
    for _k in range(1, _n + 1):
        _C[_n, _k] = _C[_n - 1, _k - 1] + _C[_n - 1, _k]

# offset bit-width per class
_W = np.array(
    [int(np.ceil(np.log2(max(1, int(_C[_B, c]))))) for c in range(_B + 1)],
    dtype=np.int64,
)


def _encode_offsets(blocks: np.ndarray, classes: np.ndarray) -> np.ndarray:
    """Enumerative rank of each block pattern within its class (vectorized)."""
    nblk = blocks.shape[0]
    offsets = np.zeros(nblk, dtype=np.int64)
    remaining_ones = classes.copy()
    # msb-first scan: positions b = B-1 .. 0, 'remaining positions' = b
    for b in range(_B - 1, -1, -1):
        bit = (blocks >> b) & 1
        # C(b, rem) = #patterns with a 0 at position b (rem ones in b slots);
        # the table is zero for rem > b, which is exactly the right value.
        offsets += np.where(bit == 1, _C[b, remaining_ones], 0)
        remaining_ones -= bit
    return offsets


def _decode_block(offset: int, c: int) -> int:
    """Inverse of :func:`_encode_offsets` for a single block."""
    pattern = 0
    rem = c
    for b in range(_B - 1, -1, -1):
        if rem == 0:
            break
        take = int(_C[b, rem])  # zero when rem > b => bit must be 1
        if offset >= take:
            offset -= take
            pattern |= 1 << b
            rem -= 1
    return pattern


@dataclasses.dataclass
class RRRVector:
    nbits: int
    classes: np.ndarray      # (nblocks,) uint8
    offsets: np.ndarray      # (nblocks,) int64 — offset values (packed width _W[c])
    rank_samples: np.ndarray # (nsuper+1,) cumulative ones before superblock

    @classmethod
    def from_bits(cls, bits: np.ndarray) -> "RRRVector":
        bits = np.asarray(bits, dtype=np.uint8)
        nbits = int(bits.size)
        nblk = -(-nbits // _B) if nbits else 0
        padded = np.zeros(nblk * _B, dtype=np.uint8)
        padded[:nbits] = bits
        words = padded.reshape(nblk, _B).astype(np.int64)
        blocks = (words << np.arange(_B)).sum(axis=1)  # bit b of block = position b
        classes = np.bitwise_count(blocks.astype(np.uint64)).astype(np.int64)
        offsets = _encode_offsets(blocks, classes)
        nsuper = -(-nblk // _SUPER) if nblk else 0
        cum = np.concatenate([[0], np.cumsum(classes)]).astype(np.int64)
        rank_samples = cum[np.minimum(np.arange(nsuper + 1) * _SUPER, nblk)]
        return cls(
            nbits=nbits,
            classes=classes.astype(np.uint8),
            offsets=offsets,
            rank_samples=rank_samples,
        )

    # -- queries -----------------------------------------------------------
    def _block_pattern(self, blk: int) -> int:
        return _decode_block(int(self.offsets[blk]), int(self.classes[blk]))

    def rank1(self, pos: int) -> int:
        if pos <= 0:
            return 0
        pos = min(pos, self.nbits)
        blk, rem = divmod(pos, _B)
        sup = blk // _SUPER
        r = int(self.rank_samples[sup])
        lo = sup * _SUPER
        if blk > lo:
            r += int(self.classes[lo:blk].astype(np.int64).sum())
        if rem:
            pat = self._block_pattern(blk) if blk < len(self.classes) else 0
            r += int(np.bitwise_count(np.uint64(pat & ((1 << rem) - 1))))
        return r

    def rank0(self, pos: int) -> int:
        return min(pos, self.nbits) - self.rank1(pos)

    @property
    def nones(self) -> int:
        return int(self.rank_samples[-1]) + (
            int(self.classes[(len(self.rank_samples) - 1) * _SUPER :].astype(np.int64).sum())
            if (len(self.rank_samples) - 1) * _SUPER < len(self.classes)
            else 0
        )

    def _select_generic(self, j: int, ones: bool) -> int:
        total = self.nones if ones else self.nbits - self.nones
        if not 0 <= j < total:
            raise IndexError("select out of range")
        # binary search superblocks
        if ones:
            samples = self.rank_samples
        else:
            samples = (
                np.arange(len(self.rank_samples), dtype=np.int64) * _SUPER * _B
                - self.rank_samples
            )
        sup = int(np.searchsorted(samples, j + 1, side="left")) - 1
        blk = sup * _SUPER
        acc = int(samples[sup])
        # scan blocks
        while blk < len(self.classes):
            c = int(self.classes[blk])
            inblk = c if ones else min(_B, self.nbits - blk * _B) - c
            if acc + inblk > j:
                break
            acc += inblk
            blk += 1
        pat = self._block_pattern(blk)
        rem = j - acc
        for b in range(_B):
            bit = (pat >> b) & 1
            if (bit == 1) == ones:
                if rem == 0:
                    return blk * _B + b
                rem -= 1
        raise AssertionError("select internal error")

    def select1(self, j: int) -> int:
        return self._select_generic(j, True)

    def select0(self, j: int) -> int:
        return self._select_generic(j, False)

    def bits(self) -> np.ndarray:
        out = np.zeros(len(self.classes) * _B, dtype=np.uint8)
        for blk in range(len(self.classes)):
            pat = self._block_pattern(blk)
            for b in range(_B):
                out[blk * _B + b] = (pat >> b) & 1
        return out[: self.nbits]

    # -- sizes ---------------------------------------------------------------
    @property
    def size_bits(self) -> int:
        """Payload: 5-bit classes + variable-width offsets."""
        return _CLASS_BITS * len(self.classes) + int(_W[self.classes].sum())

    @property
    def index_bits(self) -> int:
        # rank sample (u32) + offset-stream pointer (u32) per superblock
        return 64 * len(self.rank_samples)
