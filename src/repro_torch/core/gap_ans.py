"""Gap-ANS: the TPU-native set codec (beyond-paper optimization).

Exact ROC needs sequential order statistics (Fenwick pointer-chasing) — fine
on a CPU, hostile to a TPU.  The paper itself notes (§4) that *a sorted
sequence is informationally equivalent to a set*.  We exploit that: sort the
ids (TPUs sort well), delta-encode the gaps, and entropy-code the gaps with
the vectorized interleaved-lane rANS under a per-cluster Rice/geometric
model:

    ids sorted ascending;  g_0 = ids[0];  g_i = ids[i] - ids[i-1] - 1
    k   = Rice parameter  ~ log2(mean gap)          (per cluster, 5-bit header)
    q_i = g_i >> k   coded with a static geometric table (escape for tails)
    rem = g_i & (2^k - 1)  coded uniform (k bits, split into <=12-bit pushes)

Decode is fully parallel: lanes decode round-robin symbols in lockstep and a
prefix sum over gaps reconstructs the ids (``repro_torch.kernels.rans_decode``
is the CUDA realization — the same 32/16 coder).

Perf-iteration note (EXPERIMENTS.md §Perf): v1 used the 64/32 coder with a
fixed 64 lanes; the 64-bit lane heads cost ``64*64/n`` bits/id — 4.2 bpe at
n=977 and 10+ bpe for small clusters, wiping out the compression.  v2 (this
file) uses 32-bit heads (the 32/16 coder — also the only one a TPU can run
natively) and scales lanes with the cluster size, capping head overhead at
~1 bit/id while keeping wide decode parallelism for large clusters.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .vrans import VRans16Decoder, VRans16Encoder

__all__ = ["GapAnsCodec", "encode_gaps", "decode_gaps", "lanes_for"]

_Q_PRECISION = 12          # 2^12 total for the quotient table
_Q_SYMBOLS = 24            # geometric table size; last slot = escape
_ESCAPE = _Q_SYMBOLS - 1
_OVERFLOW_BITS = 24        # uniform bits for escaped quotients (2 pushes)
_CHUNK = 12                # max bits per uniform push (r <= 16 for 32/16)
_MAX_K = 30


def _quotient_table() -> Tuple[np.ndarray, np.ndarray]:
    """Static geometric pmf over Rice quotients, quantized to 2^12."""
    total = 1 << _Q_PRECISION
    freqs = np.maximum(1, total >> (np.arange(_Q_SYMBOLS) + 1)).astype(np.int64)
    slack = total - int(freqs.sum())
    freqs[_ESCAPE if slack >= 0 else 0] += slack
    assert freqs.sum() == total and (freqs > 0).all()
    cums = np.concatenate([[0], np.cumsum(freqs)[:-1]]).astype(np.int64)
    return freqs, cums


_QF, _QC = _quotient_table()
_SLOT2SYM = np.repeat(np.arange(_Q_SYMBOLS), _QF).astype(np.int64)


def lanes_for(n: int) -> int:
    """Lane count scaling: ~0.5 bit/id of head overhead, wide when it pays.

    Perf-iteration v3 (EXPERIMENTS.md §Perf): n//32 -> n//64 halves the
    per-cluster head overhead for mid-size clusters at half the decode
    parallelism — measured net win at IVF cluster sizes (~1k ids).
    """
    return int(max(1, min(64, n // 64)))


def _rice_k(n: int, universe: int) -> int:
    if n <= 0:
        return 0
    mean_gap = max(0, universe - n) / (n + 1)
    k = int(np.floor(np.log2(mean_gap + 1.0))) if mean_gap > 0 else 0
    return max(0, min(k, _MAX_K))


def _best_k(gaps: np.ndarray, universe: int) -> int:
    """Per-cluster Rice parameter by exact cost search around the estimate.

    Perf-iteration v3: the closed-form k underestimates by ~0.3 bit/id when
    the gap distribution is over-dispersed (k-means clusters); an exact
    3-candidate sweep over the static table cost fixes it for O(n) work.
    """
    n = len(gaps)
    k0 = _rice_k(n, universe)
    logp = -np.log2(_QF / _QF.sum())
    best_k, best_cost = k0, None
    for k in range(max(0, k0 - 1), min(_MAX_K, k0 + 2) + 1):
        q = gaps >> k
        qs = np.minimum(q, _ESCAPE)
        cost = n * k + float(logp[qs].sum()) + _OVERFLOW_BITS * int((q >= _ESCAPE).sum())
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _push_uniform_wide(enc: VRans16Encoder, vals: np.ndarray, bits: int,
                       mask: np.ndarray) -> None:
    """Uniform push of ``bits``-wide values as <=_CHUNK-bit pieces.

    Pieces are pushed high-chunk-first so decode pops low-chunk-first
    (encode order is the reverse of decode order).
    """
    done = 0
    pieces = []
    while done < bits:
        w = min(_CHUNK, bits - done)
        pieces.append(((vals >> done) & ((1 << w) - 1), w))
        done += w
    for piece, w in reversed(pieces):
        enc.push_uniform(piece, w, mask=mask)


def _pop_uniform_wide(dec: VRans16Decoder, bits: int, mask: np.ndarray,
                      lanes: int) -> np.ndarray:
    out = np.zeros(lanes, dtype=np.int64)
    done = 0
    while done < bits:
        w = min(_CHUNK, bits - done)
        piece = dec.pop_uniform(w, mask=mask)
        out |= piece.astype(np.int64) << done
        done += w
    return out


def encode_gaps(
    ids: np.ndarray, universe: int, lanes: int = 0
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Encode a set of unique ids from [universe). Returns (heads, words, k)."""
    ids = np.sort(np.asarray(ids, dtype=np.int64))
    n = int(ids.size)
    lanes = lanes or lanes_for(n)
    k = _rice_k(n, universe)
    if n == 0:
        enc = VRans16Encoder(lanes)
        heads, words = enc.finalize()
        return heads, words, k
    gaps = np.empty(n, dtype=np.int64)
    gaps[0] = ids[0]
    gaps[1:] = ids[1:] - ids[:-1] - 1
    if gaps.min() < 0:
        raise ValueError("ids must be unique and within range")
    k = _best_k(gaps, universe)
    q = gaps >> k
    rem = gaps & ((1 << k) - 1)
    qs = np.minimum(q, _ESCAPE)
    over = q - _ESCAPE
    if np.any(over >= (1 << _OVERFLOW_BITS)):
        raise ValueError("gap overflow beyond escape range")

    rows = -(-n // lanes)
    pad = rows * lanes - n

    def laneify(a: np.ndarray) -> np.ndarray:
        return np.concatenate([a, np.zeros(pad, a.dtype)]).reshape(rows, lanes)

    qs_m, over_m, rem_m = laneify(qs), laneify(over), laneify(rem)
    valid = laneify(np.ones(n, dtype=bool))
    esc_m = laneify(q >= _ESCAPE) & valid

    enc = VRans16Encoder(lanes)
    # push in reverse decode order; decode order per row: q, [overflow], rem.
    for t in range(rows - 1, -1, -1):
        if k > 0:
            _push_uniform_wide(enc, rem_m[t], k, valid[t])
        if esc_m[t].any():
            _push_uniform_wide(enc, over_m[t], _OVERFLOW_BITS, esc_m[t])
        enc.push(_QC[qs_m[t]], _QF[qs_m[t]], _Q_PRECISION, mask=valid[t])
    heads, words = enc.finalize()
    return heads, words, k


def decode_gaps(
    heads: np.ndarray, words: np.ndarray, k: int, n: int, lanes: int = 0
) -> np.ndarray:
    """Decode a set encoded by :func:`encode_gaps`; returns sorted ids."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    lanes = lanes or lanes_for(n)
    dec = VRans16Decoder(heads, words)
    rows = -(-n // lanes)
    gaps = np.zeros((rows, lanes), dtype=np.int64)
    flat_valid = np.zeros(rows * lanes, dtype=bool)
    flat_valid[:n] = True
    valid = flat_valid.reshape(rows, lanes)
    for t in range(rows):
        cf = dec.peek_cf(_Q_PRECISION)
        q = _SLOT2SYM[cf]
        dec.advance(_QC[q], _QF[q], _Q_PRECISION, mask=valid[t])
        q = np.where(valid[t], q, 0)
        esc = (q == _ESCAPE) & valid[t]
        if esc.any():
            over = _pop_uniform_wide(dec, _OVERFLOW_BITS, esc, lanes)
            q = q + np.where(esc, over, 0)
        rem = (_pop_uniform_wide(dec, k, valid[t], lanes)
               if k > 0 else np.zeros(lanes, np.int64))
        gaps[t] = (q.astype(np.int64) << k) | np.where(valid[t], rem, 0)
    flat = gaps.reshape(-1)[:n]
    return np.cumsum(flat + 1) - 1


@dataclasses.dataclass
class GapAnsCodec:
    """Set codec facade used by the index layer (see repro.core.codecs).

    ``lanes=0`` (default) scales lanes with cluster size.
    """

    lanes: int = 0

    def encode(self, ids: np.ndarray, universe: int):
        n = int(len(ids))
        lanes = self.lanes or lanes_for(n)
        heads, words, k = encode_gaps(ids, universe, lanes)
        return {"heads": heads, "words": words, "k": k, "n": n}

    def decode(self, blob, universe: int) -> np.ndarray:
        lanes = self.lanes or lanes_for(blob["n"])
        return decode_gaps(
            blob["heads"], blob["words"], blob["k"], blob["n"], lanes
        )

    def size_bits(self, blob) -> int:
        # 32-bit lane heads + 16-bit words + 5-bit Rice header
        return (32 * int(blob["heads"].shape[0])
                + 16 * int(blob["words"].shape[0]) + 5)
