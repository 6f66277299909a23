"""Adaptive per-cluster entropy coding of PQ codes — paper Eq. (6)-(7).

Vector quantizers are assumed to produce max-entropy codes, but *conditioned
on the IVF cluster* the per-subquantizer code distribution is skewed (the
cluster already pins down part of the vector).  The paper codes each PQ
column within each cluster with the sequential Pólya-urn estimator::

    Pr(x_i = x | x_0..x_{i-1}) = (1 + #occurrences of x so far) / (256 + i)

Implementation notes (DESIGN.md §3.5): the urn total ``256+i`` is not a
power of two, so for the streaming coder we quantize the urn to ``2^16``
before every op — both encoder and decoder derive the quantization from
identical counts, so it is exactly reproducible; redundancy is O(256/2^16)
bits/op.  All clusters are coded in *lockstep lanes* (vectorized numpy ops
over a (n_clusters, 256) count matrix) but each cluster owns its private
word stream, preserving the paper's online setting (random access at
cluster granularity; one stream per cluster spanning all m columns, so the
64-bit head is amortized over ``n_k * m`` symbols).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["PolyaCodec", "polya_encode_clusters", "polya_decode_clusters"]

_R = 16
_TOTAL = 1 << _R
_ALPHA = 256  # PQ byte alphabet
_WORDBITS = 32
_LOW = np.uint64(1) << np.uint64(32)
_MASK32 = np.uint64(0xFFFFFFFF)


def _quantized_model(counts: np.ndarray, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """(freqs, cums_exclusive), both (C, 256), summing to exactly 2^16."""
    raw_total = _ALPHA + t
    freqs = ((counts + 1) * _TOTAL) // raw_total          # each >= 1 for t <= 65279
    deficit = _TOTAL - freqs.sum(axis=1)
    freqs[:, -1] += deficit                               # exact fixup, last symbol
    cums = np.cumsum(freqs, axis=1) - freqs               # exclusive
    return freqs, cums


@dataclasses.dataclass
class _LaneStreams:
    """Per-lane rANS with private word stacks (cluster-granular access)."""

    lanes: int

    def __post_init__(self) -> None:
        self.heads = np.full(self.lanes, int(_LOW), dtype=np.uint64)
        self.words: List[List[int]] = [[] for _ in range(self.lanes)]

    def push(self, starts, freqs, mask) -> None:
        heads = self.heads
        starts = starts.astype(np.uint64)
        freqs = freqs.astype(np.uint64)
        need = (heads >= (freqs << np.uint64(64 - _R))) & mask
        for lane in np.flatnonzero(need):
            self.words[lane].append(int(heads[lane] & _MASK32))
        heads = np.where(need, heads >> np.uint64(_WORDBITS), heads)
        safe_f = np.where(mask, freqs, np.uint64(1))
        upd = ((heads // safe_f) << np.uint64(_R)) + starts + (heads % safe_f)
        self.heads = np.where(mask, upd, heads)


def polya_encode_clusters(
    clusters: Sequence[np.ndarray],
) -> Tuple[np.ndarray, List[np.ndarray], int]:
    """Encode per-cluster PQ code matrices [(n_k, m) uint8, ...].

    Returns (heads (C,) uint64, per-cluster word arrays, total_bits).
    Encoding runs columns j = m-1..0 and rows t = n_max-1..0 in reverse so
    decoding streams forward; word lists are reversed at the end.
    """
    C = len(clusters)
    sizes = np.array([c.shape[0] for c in clusters], dtype=np.int64)
    m = clusters[0].shape[1]
    n_max = int(sizes.max())
    # (C, n_max, m) padded symbol cube
    cube = np.zeros((C, n_max, m), dtype=np.int64)
    for k, c in enumerate(clusters):
        cube[k, : c.shape[0]] = c
    st = _LaneStreams(C)
    lane_idx = np.arange(C)
    for j in range(m - 1, -1, -1):
        counts = np.zeros((C, _ALPHA), dtype=np.int64)
        np.add.at(counts, (np.repeat(lane_idx, sizes),
                           np.concatenate([c[:, j] for c in clusters])), 1)
        for t in range(n_max - 1, -1, -1):
            active = t < sizes
            x = cube[:, t, j]
            counts[lane_idx[active], x[active]] -= 1
            freqs, cums = _quantized_model(counts, t)
            st.push(cums[lane_idx, x], freqs[lane_idx, x], active)
    words = [np.asarray(w[::-1], dtype=np.uint32) for w in st.words]
    total_bits = 64 * C + 32 * sum(len(w) for w in words)
    return st.heads, words, total_bits


def polya_decode_clusters(
    heads: np.ndarray,
    words: Sequence[np.ndarray],
    sizes: Sequence[int],
    m: int,
) -> List[np.ndarray]:
    """Inverse of :func:`polya_encode_clusters` (vectorized lockstep)."""
    C = len(sizes)
    sizes = np.asarray(sizes, dtype=np.int64)
    n_max = int(sizes.max())
    heads = heads.astype(np.uint64).copy()
    wmax = max((len(w) for w in words), default=0)
    wmat = np.zeros((C, wmax), dtype=np.uint64)
    for k, w in enumerate(words):
        wmat[k, : len(w)] = w
    ptr = np.zeros(C, dtype=np.int64)
    lane_idx = np.arange(C)
    cube = np.zeros((C, n_max, m), dtype=np.int64)
    for j in range(m):
        counts = np.zeros((C, _ALPHA), dtype=np.int64)
        for t in range(n_max):
            active = t < sizes
            freqs, cums = _quantized_model(counts, t)
            cum_incl = cums + freqs
            cf = (heads & np.uint64(_TOTAL - 1)).astype(np.int64)
            sym = (cum_incl <= cf[:, None]).sum(axis=1)
            f = freqs[lane_idx, sym].astype(np.uint64)
            c = cums[lane_idx, sym].astype(np.uint64)
            upd = f * (heads >> np.uint64(_R)) + cf.astype(np.uint64) - c
            heads = np.where(active, upd, heads)
            need = (heads < _LOW) & active
            if need.any():
                refill = wmat[lane_idx, np.minimum(ptr, wmax - 1)]
                heads = np.where(
                    need, (heads << np.uint64(_WORDBITS)) | refill, heads
                )
                ptr = ptr + need
            cube[:, t, j] = np.where(active, sym, 0)
            counts[lane_idx[active], sym[active]] += 1
    return [cube[k, : int(sizes[k])].astype(np.uint8) for k in range(C)]


@dataclasses.dataclass
class PolyaCodec:
    """Facade used by the IVF index and the Fig-3 benchmark."""

    def encode(self, clusters: Sequence[np.ndarray]):
        heads, words, bits = polya_encode_clusters(clusters)
        return {"heads": heads, "words": words, "bits": bits,
                "sizes": [c.shape[0] for c in clusters],
                "m": clusters[0].shape[1]}

    def decode(self, blob) -> List[np.ndarray]:
        return polya_decode_clusters(
            blob["heads"], blob["words"], blob["sizes"], blob["m"]
        )

    def bits_per_element(self, blob) -> float:
        nsym = sum(blob["sizes"]) * blob["m"]
        return blob["bits"] / max(1, nsym)
