"""Random Edge Coding (REC) — offline whole-graph compression (paper §3.2/§4.3).

A graph's edge list is an order-invariant *multiset* of vertex pairs; REC
collects the full ``log E!`` of edge-order freedom (much larger than the
per-node ``sum_i log m_i!`` of the online setting) by bits-back coding over
a latent edge permutation, with the two endpoints of each edge coded under a
vertex model.

Decode (forward)::

    for i = 1..E:
        u = pop_vertex(model); model.observe(u)
        v = pop_vertex(model); model.observe(v)
        insert (u, v) at rank j of the sorted decoded-edge list
        push_uniform(j, i)                     # bits-back

Encode is the exact mirror run backwards (Fenwick over the canonically
sorted edge list for rank selection; model un-observes before pushing).

Vertex models:
  * ``polya`` — Pólya urn, freq(v) = count(v) + 1, the adaptive model of
    [51] with b=0 bias as the paper uses for directed NSG graphs.  Coded
    with the *exact* ``BigANS`` (arbitrary totals); state size grows with
    the graph, so this path is quadratic-ish and meant for the paper-rate
    measurement at moderate E.
  * ``degree`` — a static model proportional to final vertex degrees
    (quantized to 2^r), streamed with ``StreamANS`` in O(E log N); the
    degree table is counted in the reported size.  This is the fast path
    (and the TPU-facing one — static tables only; DESIGN.md §3.5).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .ans import BigANS, StreamANS
from .fenwick import Fenwick

__all__ = ["rec_encode", "rec_decode", "RECResult"]


@dataclasses.dataclass
class RECResult:
    payload_bits: int
    aux_bits: int          # degree table for the static model, else 0
    model: str
    state: object          # BigANS | StreamANS
    aux: object = None

    @property
    def total_bits(self) -> int:
        return self.payload_bits + self.aux_bits


def _canonical_edges(edges: np.ndarray) -> np.ndarray:
    """Sort edges lexicographically (the canonical order for rank coding)."""
    edges = np.asarray(edges, dtype=np.int64)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    return edges[order]


# ---------------------------------------------------------------------------
# Pólya-urn model with exact coding
# ---------------------------------------------------------------------------

def _urn_push(ans: BigANS, fw: Fenwick, v: int) -> None:
    """Push vertex v under freq(v) = count(v) + 1 (counts held in fw - 1)."""
    freq = fw.get(v)
    cum = fw.cum(v)
    ans.push_pmf(cum, freq, fw.total)


def _urn_pop(ans: BigANS, fw: Fenwick) -> int:
    cf = ans.pop_cf(fw.total)
    v = fw.find(cf)
    ans.pop_advance(fw.cum(v), fw.get(v), fw.total)
    return v


def rec_encode(edges: np.ndarray, n_vertices: int, model: str = "polya") -> RECResult:
    """Encode a directed edge list (E, 2). See module docstring."""
    edges = _canonical_edges(edges)
    E = edges.shape[0]
    if model == "polya":
        return _rec_encode_polya(edges, n_vertices, E)
    if model == "degree":
        return _rec_encode_degree(edges, n_vertices, E)
    raise ValueError(f"unknown REC model {model!r}")


def rec_decode(res: RECResult, n_vertices: int, n_edges: int) -> np.ndarray:
    """Inverse of :func:`rec_encode`: the (E, 2) edge list, sorted."""
    if res.model == "polya":
        return _rec_decode_polya(res.state, n_vertices, n_edges)
    return _rec_decode_degree(res.state, res.aux, n_vertices, n_edges)


def _rec_encode_polya(edges: np.ndarray, N: int, E: int) -> RECResult:
    ans = BigANS()
    # final counts: every endpoint observed once; urn freq = count + 1
    weights = np.bincount(edges.reshape(-1), minlength=N) + 1
    fw = Fenwick([int(w) for w in weights])
    fw_edges = Fenwick.ones(E)
    elist = edges  # canonical order; fw_edges masks removals
    for i in range(E, 0, -1):
        j = ans.pop_uniform(i)
        pos = fw_edges.find(j)
        fw_edges.add(pos, -1)
        u, v = int(elist[pos, 0]), int(elist[pos, 1])
        # mirror of decode (pop u, observe, pop v, observe): un-observe v,
        # push v, un-observe u, push u.
        fw.add(v, -1)
        _urn_push(ans, fw, v)
        fw.add(u, -1)
        _urn_push(ans, fw, u)
    return RECResult(payload_bits=ans.bits, aux_bits=0, model="polya", state=ans)


def _rec_decode_polya(ans: BigANS, N: int, E: int) -> np.ndarray:
    fw = Fenwick.ones(N)  # counts 0 + 1
    decoded: List[Tuple[int, int]] = []
    import bisect

    for i in range(1, E + 1):
        u = _urn_pop(ans, fw)
        fw.add(u, 1)
        v = _urn_pop(ans, fw)
        fw.add(v, 1)
        e = (u, v)
        j = bisect.bisect_left(decoded, e)
        decoded.insert(j, e)
        ans.push_uniform(j, i)
    return np.asarray(decoded, dtype=np.int64)


# ---------------------------------------------------------------------------
# Static degree model with streaming coding
# ---------------------------------------------------------------------------

_DEG_R = 20  # pmf precision

# "The initial state must be filled with a few random bits" (paper §3.2):
# the degree path interleaves bits-back rank pops with vertex pushes, and
# the first pops draw on a fresh state.  A fixed 63-bit seed provides the
# cushion; its ~64 bits are a one-time overhead counted in payload_bits.
_SEED = (1 << 63) | 0x5DEECE66D1234567


def _degree_table(degrees: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize freq(v) ∝ degree(v) to total 2^_DEG_R (zeros stay zero)."""
    total = 1 << _DEG_R
    deg = degrees.astype(np.int64)
    pos = deg > 0
    npos = int(pos.sum())
    if npos == 0:
        raise ValueError("graph has no edges")
    scaled = np.zeros_like(deg)
    scaled[pos] = np.maximum(1, (deg[pos] * (total - npos)) // int(deg.sum()))
    # exact fixup on the largest entry
    scaled[np.argmax(scaled)] += total - int(scaled.sum())
    cums = np.concatenate([[0], np.cumsum(scaled)[:-1]])
    return scaled, cums


def _rec_encode_degree(edges: np.ndarray, N: int, E: int) -> RECResult:
    degrees = np.bincount(edges.reshape(-1), minlength=N)
    freqs, cums = _degree_table(degrees)
    ans = StreamANS(head=_SEED)
    fw_edges = Fenwick.ones(E)
    # Pow2-truncated bits-back: sample rank j < 2^floor(log2 i) <= i.  The
    # decoded-set-equals-remaining-set identity makes this consistent on
    # both sides; the saving is sum floor(log2 i) ~= log E! - 0.5E bits
    # (the exact-rate reference is the polya path).
    for i in range(E, 0, -1):
        r = int(i).bit_length() - 1  # floor(log2 i)
        j = ans.pop_uniform_pow2(r) if r > 0 else 0
        pos = fw_edges.find(j)
        fw_edges.add(pos, -1)
        u, v = int(edges[pos, 0]), int(edges[pos, 1])
        # decode order per edge: pop u, pop v, push rank -> mirror here.
        ans.push(int(cums[v]), int(freqs[v]), _DEG_R)
        ans.push(int(cums[u]), int(freqs[u]), _DEG_R)
    return RECResult(
        payload_bits=ans.bits,
        aux_bits=_degree_table_bits(degrees),
        model="degree",
        state=ans,
        aux=(freqs, cums),
    )


def _degree_table_bits(degrees: np.ndarray) -> int:
    """Cost of shipping the degree table: ANS-coded counts (entropy + eps)."""
    vals, counts = np.unique(degrees, return_counts=True)
    p = counts / counts.sum()
    h = float(-(p * np.log2(p)).sum())
    # per-vertex entropy of the degree value + the (value -> freq) dictionary
    return int(np.ceil(h * len(degrees))) + 64 * len(vals)


def _rec_decode_degree(ans: StreamANS, aux, N: int, E: int) -> np.ndarray:
    from .sortedlist import SortedList

    freqs, cums = aux
    # cf -> vertex via binary search on the cumulative table (O(log N))
    cum_incl = np.cumsum(freqs)

    def pop_vertex() -> int:
        cf = ans.pop_cf(_DEG_R)
        v = int(np.searchsorted(cum_incl, cf, side="right"))
        ans.pop_advance(int(cums[v]), int(freqs[v]), _DEG_R)
        return v

    decoded = SortedList()
    for i in range(1, E + 1):
        u = pop_vertex()
        v = pop_vertex()
        j = decoded.insert(u * N + v)  # lexicographic key
        r = int(i).bit_length() - 1
        if r > 0:
            ans.push_uniform_pow2(j, r)
    keys = np.asarray(decoded.to_list(), dtype=np.int64)
    return np.stack([keys // N, keys % N], axis=1)
