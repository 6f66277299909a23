"""Vectorized interleaved-lane rANS (the TPU adaptation of the paper's coder).

A single ANS stream is sequential: each push/pop depends on the previous
state.  TPUs (and the numpy model here) want wide data-parallel ops, so we
run ``L`` independent lanes in lockstep — one ``(L,)`` uint64 head vector —
and round-robin symbols over lanes.  Renormalization emits/consumes 32-bit
words into a single flat stack; each op emits *at most one* word per lane
(64/32 scheme with power-of-two totals, exact by b-uniqueness — see
``repro.core.ans.StreamANS``), and the decoder's consume mask provably
mirrors the encoder's emit mask, so the words of one op are contiguous and
lane-ordered: a dense layout that maps onto TPU vector loads with a
prefix-sum word distribution (see ``repro.kernels.rans_decode``).

Precision ``r`` (``total = 2^r``, ``r <= 32``) may vary per op; per-lane
``(start, freq)`` pairs are supported, as are lane masks for ragged data.

Encoding processes symbols in *reverse* op order so that decoding streams
forward; ``finalize`` reverses the word chunks accordingly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["VRansEncoder", "VRansDecoder", "vrans_size_bits"]

_WORD = np.uint64(32)
_MASK32 = np.uint64(0xFFFFFFFF)
_LOW = np.uint64(1) << np.uint64(32)
_ONE = np.uint64(1)


@dataclasses.dataclass
class VRansEncoder:
    """Encoder over ``lanes`` parallel rANS streams.

    Symbols must be pushed in reverse of the intended decode order.
    """

    lanes: int

    def __post_init__(self) -> None:
        self.heads = np.full(self.lanes, int(_LOW), dtype=np.uint64)
        self._chunks: List[np.ndarray] = []  # appended word groups (encode order)

    def push(
        self,
        starts: np.ndarray,
        freqs: np.ndarray,
        r: int,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        """Push one symbol per active lane: pmf ``freqs/2^r``, CDF ``starts``."""
        if r == 0:
            return
        if not 0 < r <= 32:
            raise ValueError("precision must be in (0, 32]")
        heads = self.heads
        starts = starts.astype(np.uint64)
        freqs = freqs.astype(np.uint64)
        live = (
            np.ones(self.lanes, dtype=bool)
            if mask is None
            else np.asarray(mask, dtype=bool)
        )
        need = (heads >= (freqs << np.uint64(64 - r))) & live
        if need.any():
            self._chunks.append((heads[need] & _MASK32).astype(np.uint32))
            heads = np.where(need, heads >> _WORD, heads)
        safe_f = np.where(live, freqs, _ONE)
        upd = ((heads // safe_f) << np.uint64(r)) + starts + (heads % safe_f)
        self.heads = np.where(live, upd, heads)

    def push_uniform(
        self, xs: np.ndarray, r: int, mask: Optional[np.ndarray] = None
    ) -> None:
        xs = np.asarray(xs).astype(np.uint64)
        self.push(xs, np.ones_like(xs), r, mask)

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns ``(heads (L,) uint64, words (W,) uint32)``.

        ``words`` is ordered so the decoder reads it *forward*: the encoder
        pushed ops in reverse decode order, so the chunk list is reversed.
        """
        if self._chunks:
            words = np.concatenate(self._chunks[::-1])
        else:
            words = np.zeros(0, dtype=np.uint32)
        return self.heads.copy(), words


@dataclasses.dataclass
class VRansDecoder:
    heads: np.ndarray  # (L,) uint64
    words: np.ndarray  # (W,) uint32, consumed front-to-back

    def __post_init__(self) -> None:
        self.heads = self.heads.astype(np.uint64).copy()
        self.words = np.asarray(self.words, dtype=np.uint32)
        self.ptr = 0

    def peek_cf(self, r: int) -> np.ndarray:
        return (self.heads & np.uint64((1 << r) - 1)).astype(np.int64)

    def advance(
        self,
        starts: np.ndarray,
        freqs: np.ndarray,
        r: int,
        mask: Optional[np.ndarray] = None,
    ) -> None:
        if r == 0:
            return
        heads = self.heads
        starts = starts.astype(np.uint64)
        freqs = freqs.astype(np.uint64)
        live = (
            np.ones(heads.shape[0], dtype=bool)
            if mask is None
            else np.asarray(mask, dtype=bool)
        )
        cf = heads & np.uint64((1 << r) - 1)
        upd = freqs * (heads >> np.uint64(r)) + cf - starts
        heads = np.where(live, upd, heads)
        need = (heads < _LOW) & live
        cnt = int(need.sum())
        if cnt:
            if self.ptr + cnt > self.words.shape[0]:
                raise ValueError("vrANS stream underflow (corrupt or over-read)")
            grp = self.words[self.ptr : self.ptr + cnt].astype(np.uint64)
            self.ptr += cnt
            refill = np.zeros_like(heads)
            refill[need] = grp
            heads = np.where(need, (heads << _WORD) | refill, heads)
        self.heads = heads

    def pop_uniform(
        self, r: int, mask: Optional[np.ndarray] = None
    ) -> np.ndarray:
        xs = self.peek_cf(r)
        ones = np.ones(self.heads.shape[0], dtype=np.uint64)
        self.advance(xs.astype(np.uint64), ones, r, mask)
        return xs


def vrans_size_bits(heads: np.ndarray, words: np.ndarray) -> int:
    """Serialized size: lane heads at 64b each + 32b per tail word."""
    return 64 * int(heads.shape[0]) + 32 * int(words.shape[0])


# ---------------------------------------------------------------------------
# 32/16 variant: uint32 heads, 16-bit words — the TPU-kernel coder.
# TPUs have no native 64-bit integer path; with head in [2^16, 2^32) and
# r <= 16, every operation (including freq * (head >> r)) fits uint32
# exactly, so the Pallas decoder (repro.kernels.rans_decode) runs on pure
# 32-bit vector arithmetic.  Same single-renorm mirror proof as 64/32.
# ---------------------------------------------------------------------------

_LOW16 = np.uint32(1) << np.uint32(16)
_MASK16 = np.uint32(0xFFFF)


@dataclasses.dataclass
class VRans16Encoder:
    """Lane-parallel 32/16 rANS encoder (push in reverse decode order)."""

    lanes: int

    def __post_init__(self) -> None:
        self.heads = np.full(self.lanes, int(_LOW16), dtype=np.uint32)
        self._chunks: List[np.ndarray] = []

    def push(self, starts, freqs, r: int, mask=None) -> None:
        if r == 0:
            return
        if not 0 < r <= 16:
            raise ValueError("precision must be in (0, 16]")
        heads = self.heads
        starts = np.asarray(starts).astype(np.uint32)
        freqs = np.asarray(freqs).astype(np.uint32)
        live = (
            np.ones(self.lanes, dtype=bool)
            if mask is None else np.asarray(mask, dtype=bool)
        )
        need = (heads >= (freqs << np.uint32(32 - r))) & live
        if need.any():
            self._chunks.append((heads[need] & _MASK16).astype(np.uint16))
            heads = np.where(need, heads >> np.uint32(16), heads)
        safe_f = np.where(live, freqs, np.uint32(1))
        upd = ((heads // safe_f) << np.uint32(r)) + starts + (heads % safe_f)
        self.heads = np.where(live, upd, heads)

    def push_uniform(self, xs, r: int, mask=None) -> None:
        xs = np.asarray(xs).astype(np.uint32)
        self.push(xs, np.ones_like(xs), r, mask)

    def finalize(self):
        words = (
            np.concatenate(self._chunks[::-1])
            if self._chunks else np.zeros(0, dtype=np.uint16)
        )
        return self.heads.copy(), words


@dataclasses.dataclass
class VRans16Decoder:
    """Numpy mirror of the Pallas decoder (for tests / CPU fallback)."""

    heads: np.ndarray
    words: np.ndarray

    def __post_init__(self) -> None:
        self.heads = self.heads.astype(np.uint32).copy()
        self.words = np.asarray(self.words, dtype=np.uint16)
        self.ptr = 0

    def peek_cf(self, r: int) -> np.ndarray:
        return (self.heads & np.uint32((1 << r) - 1)).astype(np.int64)

    def advance(self, starts, freqs, r: int, mask=None) -> None:
        if r == 0:
            return
        heads = self.heads
        starts = np.asarray(starts).astype(np.uint32)
        freqs = np.asarray(freqs).astype(np.uint32)
        live = (
            np.ones(heads.shape[0], dtype=bool)
            if mask is None else np.asarray(mask, dtype=bool)
        )
        cf = heads & np.uint32((1 << r) - 1)
        upd = freqs * (heads >> np.uint32(r)) + cf - starts
        heads = np.where(live, upd, heads)
        need = (heads < _LOW16) & live
        cnt = int(need.sum())
        if cnt:
            if self.ptr + cnt > self.words.shape[0]:
                raise ValueError("vrANS16 stream underflow")
            grp = self.words[self.ptr:self.ptr + cnt].astype(np.uint32)
            self.ptr += cnt
            refill = np.zeros_like(heads)
            refill[need] = grp
            heads = np.where(need, (heads << np.uint32(16)) | refill, heads)
        self.heads = heads

    def pop_uniform(self, r: int, mask=None) -> np.ndarray:
        xs = self.peek_cf(r)
        ones = np.ones(self.heads.shape[0], dtype=np.uint32)
        self.advance(xs.astype(np.uint32), ones, r, mask)
        return xs
