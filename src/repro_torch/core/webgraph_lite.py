"""WebGraph-style offline graph codec — the Zuckerli baseline stand-in.

Full Zuckerli [62] is a large C++ codebase; per DESIGN.md §9 we implement
the WebGraph [5,6] scheme it builds on, with Zuckerli's two headline
improvements approximated: (1) the block/residual structure is
entropy-coded with ANS instead of instantaneous codes, (2) runs of
consecutive integers are run-length encoded.  Per node, the (sorted)
friend list is encoded as:

  * reference selection: try the previous ``W`` nodes; pick the one whose
    list overlaps most; encode the delta (0 = no reference);
  * copy-blocks: the reference list is partitioned into alternating
    copied/skipped blocks; block lengths are entropy-coded;
  * residuals: remaining targets as gap-coded integers (zeta-like bucket +
    uniform refinement), intervals of consecutive ints run-length coded.

This is labeled ``zuckerli-lite`` in benchmark tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .ans import StreamANS

__all__ = ["webgraph_encode", "webgraph_decode"]

_WINDOW = 7
_BUCKET_R = 8    # bucket pmf precision

# static decreasing pmf over bucket = bit_length(v) in [0, 32]
_BF = np.maximum(1, (1 << 6) >> (np.arange(33) // 2)).astype(np.int64)
_BF[0] += (1 << _BUCKET_R) - int(_BF.sum())
assert _BF.sum() == (1 << _BUCKET_R) and (_BF > 0).all()
_BC = np.cumsum(_BF) - _BF
_BSLOT = np.repeat(np.arange(33), _BF)


def _push_gamma(ans: StreamANS, v: int) -> None:
    """Entropy-coded Elias-gamma-like: bucket = bit_length, then uniform."""
    b = int(v).bit_length()
    if b > 1:
        # v in [2^(b-1), 2^b): encode low b-1 bits first (decoded last)
        ans.push_uniform_pow2(v - (1 << (b - 1)), b - 1)
    ans.push(int(_BC[b]), int(_BF[b]), _BUCKET_R)


def _pop_gamma(ans: StreamANS) -> int:
    cf = ans.pop_cf(_BUCKET_R)
    b = int(_BSLOT[cf])
    ans.pop_advance(int(_BC[b]), int(_BF[b]), _BUCKET_R)
    if b == 0:
        return 0
    if b == 1:
        return 1
    low = ans.pop_uniform_pow2(b - 1)
    return (1 << (b - 1)) + low


def webgraph_encode(adj: Sequence[np.ndarray], n_vertices: int) -> StreamANS:
    """Encode adjacency lists (target ids per node, any order)."""
    ans = StreamANS()
    sorted_adj = [np.sort(np.asarray(a, dtype=np.int64)) for a in adj]
    # encode nodes in reverse so decode streams forward
    for i in range(len(sorted_adj) - 1, -1, -1):
        _encode_node(ans, sorted_adj, i)
    return ans


def _best_reference(sorted_adj, i: int) -> int:
    best, best_overlap = 0, 0
    mine = set(int(x) for x in sorted_adj[i])
    if not mine:
        return 0
    for d in range(1, min(_WINDOW, i) + 1):
        ref = sorted_adj[i - d]
        overlap = len(mine.intersection(int(x) for x in ref))
        if overlap > best_overlap:
            best, best_overlap = d, overlap
    return best


def _encode_node(ans: StreamANS, sorted_adj, i: int) -> None:
    """Pushes node i's description in reverse of decode order."""
    mine = sorted_adj[i]
    ref_delta = _best_reference(sorted_adj, i)
    ops: List = []  # (kind, value) in DECODE order
    ops.append(("gamma", len(mine)))
    ops.append(("gamma", ref_delta))
    copied = np.zeros(0, dtype=np.int64)
    if ref_delta:
        ref = sorted_adj[i - ref_delta]
        inref = np.isin(ref, mine)
        # alternating block lengths starting with a copied block
        blocks: List[int] = []
        cur, run = True, 0
        for b in inref:
            if bool(b) == cur:
                run += 1
            else:
                blocks.append(run)
                cur, run = not cur, 1
        blocks.append(run)
        # (if ref[0] is not copied the loop already emitted a leading 0 block)
        ops.append(("gamma", len(blocks)))
        for b in blocks:
            ops.append(("gamma", b))
        copied = ref[inref]
    residual = np.setdiff1d(mine, copied, assume_unique=False)
    # interval run-lengths within residuals
    k = 0
    rops: List = []
    nres = len(residual)
    prev = -1
    idx = 0
    while idx < nres:
        run = 1
        while idx + run < nres and residual[idx + run] == residual[idx] + run:
            run += 1
        gap = int(residual[idx]) - prev - 1
        rops.append(("gamma", gap))
        rops.append(("gamma", run - 1))
        prev = int(residual[idx]) + run - 1
        idx += run
        k += 1
    ops.append(("gamma", k))
    ops.extend(rops)
    for kind, v in reversed(ops):
        _push_gamma(ans, int(v))


def webgraph_decode(ans: StreamANS, n_nodes: int, n_vertices: int) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    for i in range(n_nodes):
        deg = _pop_gamma(ans)
        ref_delta = _pop_gamma(ans)
        copied = np.zeros(0, dtype=np.int64)
        if ref_delta:
            ref = out[i - ref_delta]
            nblocks = _pop_gamma(ans)
            blocks = [_pop_gamma(ans) for _ in range(nblocks)]
            mask = np.zeros(len(ref), dtype=bool)
            pos, take = 0, True
            for b in blocks:
                if take:
                    mask[pos : pos + b] = True
                pos += b
                take = not take
            copied = ref[mask]
        k = _pop_gamma(ans)
        residual = []
        prev = -1
        for _ in range(k):
            gap = _pop_gamma(ans)
            run = _pop_gamma(ans) + 1
            start = prev + 1 + gap
            residual.extend(range(start, start + run))
            prev = start + run - 1
        merged = np.sort(np.concatenate([copied, np.asarray(residual, np.int64)]))
        assert len(merged) == deg, "webgraph decode inconsistency"
        out.append(merged)
    return out
