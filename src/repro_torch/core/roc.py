"""Random Order Coding (ROC) — bits-back coding of id *sets*.

This is the paper's primary codec (Section 3.2 / 4.2).  A cluster's id list
is order-invariant, so a sequence of ``n`` unique ids drawn from ``[N)``
carries ``log n!`` fewer bits than its naive encoding.  ROC collects exactly
that saving with an ANS stack:

encode (per cluster, ids need not be pre-sorted)::

    for i = n .. 1:                       # i = number of ids remaining
        j   = ans.pop_uniform(i)          # bits-back: sample a rank (-log i bits)
        x   = j-th smallest remaining id  # order statistics (Fenwick)
        ans.push_uniform(x, N)            # id model: uniform over [N)  (+log N bits)

decode::

    for i = 1 .. n:
        x = ans.pop_uniform(N)
        j = rank of x among ids decoded so far (after insertion)
        ans.push_uniform(j, i)            # return the borrowed bits

Both loops are exact mirrors, so the ANS state round-trips exactly; with the
exact big-integer coder (``BigANS``) the rate is ``log2 C(N, n)`` up to +1
bit, with **no initial-bits overhead**: starting from state 0, early
``pop_uniform`` calls on a small state are still bijective (they return
low-entropy ranks), which is the cleanest resolution of the paper's
"initial bits issue" for the offline/online settings alike.

Differences from the paper's C++ implementation (documented in DESIGN.md):
the paper uses a fixed-width streaming ANS where the initial state is filled
with random bits; we use the exact coder for rate reporting (the paper notes
ANS redundancy is ~2e-5 bits/op — unobservable at our scales) and the
vectorized lane coder (``repro.core.gap_ans``) for the TPU-adapted fast path.
"""

from __future__ import annotations

import bisect
from typing import List, Sequence

import numpy as np

from .ans import BigANS
from .fenwick import Fenwick

__all__ = [
    "roc_push_set",
    "roc_pop_set",
    "roc_encode_clusters",
    "roc_decode_clusters",
    "set_information_bits",
]


def roc_push_set(ans: BigANS, ids: Sequence[int], alphabet: int) -> None:
    """Push the *set* of unique ``ids`` (subset of ``[alphabet)``) onto ``ans``."""
    sorted_ids = np.sort(np.asarray(ids, dtype=np.int64))
    n = int(sorted_ids.size)
    if n == 0:
        return
    if sorted_ids[0] < 0 or sorted_ids[-1] >= alphabet:
        raise ValueError("ids out of range")
    if n > 1 and np.any(sorted_ids[1:] == sorted_ids[:-1]):
        raise ValueError("ROC set codec requires unique ids")
    ids_list = [int(v) for v in sorted_ids]
    if n <= 512:
        # O(n^2) memmove path: faster than Fenwick for small clusters.
        for i in range(n, 0, -1):
            j = ans.pop_uniform(i)
            x = ids_list.pop(j)
            ans.push_uniform(x, alphabet)
    else:
        fw = Fenwick.ones(n)
        for i in range(n, 0, -1):
            j = ans.pop_uniform(i)
            pos = fw.find(j)
            fw.add(pos, -1)
            ans.push_uniform(ids_list[pos], alphabet)


def roc_pop_set(ans: BigANS, n: int, alphabet: int) -> np.ndarray:
    """Pop a set of ``n`` ids; returns them sorted ascending."""
    out: List[int] = []
    for i in range(1, n + 1):
        x = ans.pop_uniform(alphabet)
        j = bisect.bisect_left(out, x)
        out.insert(j, x)
        ans.push_uniform(j, i)
    return np.asarray(out, dtype=np.int64)


def roc_encode_clusters(
    lists: Sequence[np.ndarray], alphabet: int, joint: bool = False
) -> List[BigANS]:
    """Encode inverted lists.

    ``joint=False`` — the paper's *online* setting: one stream per cluster
    (partial random access).  ``joint=True`` — the *offline* setting: all
    clusters share one stream (decoded back-to-front), amortizing nothing
    here (BigANS has no initial bits) but producing a single blob.
    """
    if joint:
        ans = BigANS()
        for ids in lists:
            roc_push_set(ans, ids, alphabet)
        return [ans]
    return [_encode_one(ids, alphabet) for ids in lists]


def _encode_one(ids: np.ndarray, alphabet: int) -> BigANS:
    ans = BigANS()
    roc_push_set(ans, ids, alphabet)
    return ans


def roc_decode_clusters(
    streams: Sequence[BigANS], sizes: Sequence[int], alphabet: int, joint: bool = False
) -> List[np.ndarray]:
    """Inverse of :func:`roc_encode_clusters`: per-cluster sorted ids."""
    if joint:
        (ans,) = streams
        out = [roc_pop_set(ans, n, alphabet) for n in reversed(list(sizes))]
        return out[::-1]
    return [roc_pop_set(a, n, alphabet) for a, n in zip(streams, sizes)]


def set_information_bits(alphabet: int, n: int) -> float:
    """``log2 C(alphabet, n)`` — the information content of an n-subset."""
    import math

    return (
        math.lgamma(alphabet + 1)
        - math.lgamma(n + 1)
        - math.lgamma(alphabet - n + 1)
    ) / math.log(2)
