"""Graph ANN index (NSG/HNSW-like) with compressed friend lists — the port
of ``repro.ann.graph``.

Builders, as in the reference (same decisions, made on the index's
device a chunk of nodes at a time):

* ``nsg``  — exact kNN graph + MRNG occlusion pruning;
* ``hnsw`` — kNN candidates + the same heuristic + reverse edges up to
  the degree cap, base layer only.

Where the reference decides with numpy, the port decides the same way:
every distance that feeds a decision is summed in numpy's own order
(:func:`repro_torch.ann.npsum.np_sum_f32`, bit-equal on the card), the
candidates of a node are ordered by ``np.argsort`` of those distances on
the host (its default, unstable kind, as the reference calls it), and the
greedy occlusion pass runs over candidate positions with all nodes of a
chunk at once.  So the prune of a given kNN list, HNSW's reverse edges
and :meth:`GraphIndex.add` give the reference's adjacency exactly.  The
kNN graph itself is ``l2_dist`` + ``seg_topk`` (the Hopper kernels on a
CUDA index, their plain torch versions on a CPU one); its values differ
from the reference's XLA dot in the last bits, so its lists equal the
reference's except at near-ties inside ``rescore_eps``.

Friend lists are coded per node on the host through the port's codecs,
byte for byte as in the reference.  Search: :meth:`GraphIndex.search` is
the beam-batched engine (:mod:`repro_torch.ann.graph_scan`);
:meth:`GraphIndex.search_ref` is the reference's per-query loop, the
engine's bit-exact oracle.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..core.codecs import get_codec
from ..device import resolve_device
from ..kernels.l2_topk import l2_dist
from ..kernels.seg_topk import seg_topk
from .npsum import np_sq_dist
from .scan import (RESCORE_SLACK, CacheOwnerMixin, _bucket, rescore_eps)
from .stats import SearchStats

__all__ = ["knn_graph", "prune_kept", "kept_lists", "hnsw_reverse_edges",
           "build_nsg", "build_hnsw", "GraphIndex"]

# bytes of one distance block (rows x base) in knn_graph and add's
# candidate search, and of one chunk's pairwise differences in the prune
BLOCK_BYTES = {"cuda": 2 << 30, "cpu": 64 << 20}
PRUNE_BYTES = {"cuda": 4 << 30, "cpu": 64 << 20}


def _as_base(x, device) -> torch.Tensor:
    """``x`` as a contiguous f32 tensor on ``device`` (a tensor already
    there is used as is)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def knn_graph(x, k: int, device="cuda", chunk: Optional[int] = None,
              rows: Optional[int] = None) -> np.ndarray:
    """Exact kNN (excluding self): returns (n, k) int32 neighbor ids (of
    the first ``rows`` rows only, when given).

    Blocks of ``chunk`` query rows are scored against the whole base with
    ``l2_dist`` and cut to ``k + 1`` by ``(value, column)`` with
    ``seg_topk`` (ties to the lower column, as ``lax.top_k``); self is
    dropped from each row as the reference does (the first ``k`` entries
    that are not the row itself)."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    xdev = _as_base(x, dev)
    n = xdev.shape[0]
    if k >= n:
        raise ValueError(f"knn_graph needs more than k = {k} rows, got {n}")
    chunk = chunk or max(1, BLOCK_BYTES[dev.type] // (4 * n))
    nq = n if rows is None else min(n, rows)
    out = np.zeros((nq, k), np.int32)
    for lo in range(0, nq, chunk):
        hi = min(nq, lo + chunk)
        dmat = l2_dist(xdev[lo:hi], xdev)
        lens = torch.full((hi - lo,), n, dtype=torch.int32, device=dev)
        _, cols = seg_topk(dmat, lens, k + 1)
        del dmat
        cols = cols.long()
        self_col = torch.arange(lo, hi, device=dev)[:, None]
        # the first k columns that are not the row itself, in order
        pos = torch.argsort((cols == self_col).to(torch.int8), dim=1,
                            stable=True)[:, :k]
        out[lo:hi] = cols.gather(1, pos).cpu().numpy()
    return out


def _np_argsort_rows(cd: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``np.argsort(cd[i, :lens[i]])`` for every row (default kind, as the
    reference calls it on each node's candidates), positions past
    ``lens[i]`` after them in order.  Rows of one length take one batched
    ``axis=1`` call, which orders each row as a call on that row alone."""
    c, width = cd.shape
    order = np.tile(np.arange(width, dtype=np.int64), (c, 1))
    for ln in np.unique(lens):
        ln = int(ln)
        rows = np.flatnonzero(lens == ln)
        if ln:
            order[rows, :ln] = np.argsort(cd[rows, :ln], axis=1)
    return order


def prune_kept(x, cand: np.ndarray, centers: np.ndarray, r: int,
               lens: Optional[np.ndarray] = None, device=None) -> np.ndarray:
    """MRNG occlusion rule for many nodes at once: keep ``c`` unless a kept
    neighbor is strictly closer to ``c`` than the center is.

    ``cand`` (c, L) holds each center's candidates (the first ``lens[i]``
    of row ``i`` count; default all ``L``); ``x`` is the base (a tensor
    on the device that decides, or an array with ``device``).  Returns
    (c, r) int64 kept ids in acceptance order, -1 past each row's count —
    row ``i`` equals the reference's ``_occlusion_prune(x, cand[i,
    :lens[i]], centers[i], r)``.  Distances come from ``np_sq_dist``, the
    candidate order from ``np.argsort`` on the host, and the greedy pass
    runs over candidate positions with all nodes of a chunk at once."""
    dev = x.device if isinstance(x, torch.Tensor) else resolve_device(device)
    xdev = _as_base(x, dev)
    cand = np.asarray(cand, np.int64)
    centers = np.asarray(centers, np.int64)
    c, width = cand.shape
    d = xdev.shape[1]
    lens = (np.full(c, width, np.int64) if lens is None
            else np.asarray(lens, np.int64))
    out = np.full((c, r), -1, np.int64)
    if c == 0 or width == 0 or r <= 0:
        return out
    rows = max(1, PRUNE_BYTES[dev.type] // (8 * width * width * d))
    pos = torch.arange(width, device=dev)
    for lo in range(0, c, rows):
        hi = min(c, lo + rows)
        cand_t = torch.from_numpy(cand[lo:hi]).to(dev)
        ctr = torch.from_numpy(centers[lo:hi]).to(dev)
        xc = xdev[cand_t.clamp(min=0)]                       # (b, L, d)
        cd = np_sq_dist(xc, xdev[ctr][:, None, :])            # (b, L)
        order = torch.from_numpy(_np_argsort_rows(
            cd.cpu().numpy(), lens[lo:hi])).to(dev)
        cand_o = cand_t.gather(1, order)
        cd_o = cd.gather(1, order)
        xo = xc.gather(1, order[:, :, None].expand(-1, -1, d))
        del xc
        # pairwise candidate distances (symmetric: (a - b)^2 == (b - a)^2)
        dd = np_sq_dist(xo[:, :, None, :], xo[:, None, :, :])  # (b, L, L)
        del xo
        valid = (pos[None, :] < torch.from_numpy(lens[lo:hi]).to(dev)[:, None]
                 ) & (cand_o != ctr[:, None])
        kept = torch.zeros((hi - lo, width), dtype=torch.bool, device=dev)
        cnt = torch.zeros(hi - lo, dtype=torch.int64, device=dev)
        for p in range(width):
            occluded = (kept & (dd[:, p, :] < cd_o[:, p:p + 1])).any(1)
            take = valid[:, p] & ~occluded & (cnt < r)
            kept[:, p] = take
            cnt += take
        # kept ids in acceptance (position) order, -1 after them
        first = torch.argsort((~kept).to(torch.int8), dim=1,
                              stable=True)[:, :r]
        ids = torch.where(kept.gather(1, first), cand_o.gather(1, first),
                          torch.full((), -1, device=dev, dtype=torch.int64))
        out[lo:hi, :ids.shape[1]] = ids.cpu().numpy()
    return out


def kept_lists(kept: np.ndarray) -> List[np.ndarray]:
    """(n, r) kept ids, -1 padded -> per-node sorted int64 arrays."""
    kept = np.asarray(kept, np.int64)
    cnt = (kept >= 0).sum(axis=1)
    big = np.iinfo(np.int64).max
    srt = np.sort(np.where(kept >= 0, kept, big), axis=1)
    flat = srt[srt != big]
    return np.split(flat, np.cumsum(cnt)[:-1]) if kept.shape[0] else []


def _free_slot_edges(src: torch.Tensor, dst: torch.Tensor,
                     free: torch.Tensor, n: int):
    """Reverse edges into free slots: of the edges ``src -> dst`` (int64
    tensors of nodes below ``n``), target ``j`` takes the first
    ``free[j]`` sources in ascending order.  One sort on the device;
    returns the kept ``(dst, src)``, by target, then source."""
    key, _ = torch.sort(dst * n + src)
    t, s = key // n, key % n
    rank = torch.arange(t.shape[0], device=t.device) - torch.searchsorted(t, t)
    app = rank < free[t]
    return t[app], s[app]


def hnsw_reverse_edges(kept: np.ndarray, m: int, device="cuda"
                       ) -> List[np.ndarray]:
    """HNSW's reverse-edge pass over the pruned lists, in closed form.

    The reference appends, for ``i`` ascending and each ``j`` in
    ``kept[i]``, the source ``i`` to ``adj[j]`` while ``adj[j]`` is short
    of ``m`` and does not hold ``i``.  An appended entry never creates a
    further edge (its target already lists its source), so ``adj[j]`` ends
    as ``kept[j]`` plus the first ``m - |kept[j]|`` sources ``i``,
    ascending, with ``j`` in ``kept[i]`` and ``i`` not in ``kept[j]``:
    one sort on the device.  Returns per-node sorted int64 arrays, the
    reference's ``sorted(set(adj[j]))``."""
    dev = resolve_device(device)
    kt = torch.from_numpy(np.asarray(kept, np.int64)).to(dev)
    n, width = kt.shape
    has = kt >= 0
    cnt = has.sum(1)
    src = torch.arange(n, device=dev)[:, None].expand(n, width)[has]
    dst = kt[has]
    # drop sources the target already lists (chunked membership test)
    recip = torch.empty_like(src, dtype=torch.bool)
    step = max(1, (256 << 20) // max(1, 8 * width))
    for lo in range(0, src.shape[0], step):
        s, t = src[lo:lo + step], dst[lo:lo + step]
        recip[lo:lo + step] = (kt[t] == s[:, None]).any(1)
    t, s = _free_slot_edges(src[~recip], dst[~recip], m - cnt, n)
    node = torch.cat([src, t])
    nbr = torch.cat([dst, s])
    key, _ = torch.sort(node * n + nbr)
    flat = (key % n).cpu().numpy()
    counts = torch.bincount(key // n, minlength=n).cpu().numpy()
    return np.split(flat, np.cumsum(counts)[:-1])


def build_nsg(x: np.ndarray, r: int, knn_k: int = 0, seed: int = 0,
              device="cuda", timings: Optional[Dict[str, float]] = None
              ) -> List[np.ndarray]:
    """NSG-style adjacency (friend lists, <= r out-edges per node).

    ``timings``, when given, receives the seconds of the kNN graph
    (``knn_s``) and of the prune (``prune_s``)."""
    del seed  # deterministic; accepted for the reference's signature
    knn_k = knn_k or min(max(2 * r, 16), 64)
    xdev = _as_base(x, resolve_device(device))
    t = time.perf_counter()
    nn = knn_graph(xdev, knn_k)
    t_knn = time.perf_counter() - t
    t = time.perf_counter()
    n = xdev.shape[0]
    adj = kept_lists(prune_kept(xdev, nn, np.arange(n), r))
    if timings is not None:
        timings.update(knn_s=t_knn, prune_s=time.perf_counter() - t)
    return adj


def build_hnsw(x: np.ndarray, m: int, seed: int = 0, device="cuda",
               timings: Optional[Dict[str, float]] = None
               ) -> List[np.ndarray]:
    """HNSW-ish base layer: kNN candidates + heuristic + reverse edges
    (``timings`` as in :func:`build_nsg`; ``prune_s`` includes the reverse
    edges)."""
    del seed
    xdev = _as_base(x, resolve_device(device))
    t = time.perf_counter()
    nn = knn_graph(xdev, min(2 * m, 48))
    t_knn = time.perf_counter() - t
    t = time.perf_counter()
    n = xdev.shape[0]
    kept = prune_kept(xdev, nn, np.arange(n), m)
    adj = hnsw_reverse_edges(kept, m, device=xdev.device)
    if timings is not None:
        timings.update(knn_s=t_knn, prune_s=time.perf_counter() - t)
    return adj


@dataclasses.dataclass
class GraphIndex(CacheOwnerMixin):
    id_codec: str = "roc"
    cache_bytes: Optional[int] = None    # DecodedListCache budget (None = default)
    cache_policy: str = "lru"            # "lru" | "2q"
    max_epochs: Optional[int] = None     # auto-compact past this universe count
    device: str = "cuda"                 # where the base lives and is scored

    def __post_init__(self) -> None:
        self.torch_device = resolve_device(self.device)
        self.id_map: Optional[np.ndarray] = None   # set by a shard planner
        self._xdev: Optional[torch.Tensor] = None

    # -- the base on the device -----------------------------------------------
    @property
    def base_dev(self) -> torch.Tensor:
        """The (n, d) f32 base on the index's device, uploaded once (rows
        appended by :meth:`add` are written into spare capacity)."""
        return self._xdev[:self.n]

    def _upload(self, lo: int = 0) -> None:
        """Put rows ``lo..n`` of ``x`` on the device, growing the buffer
        by a quarter when it is full."""
        n, d = self.x.shape
        if self._xdev is None or self._xdev.shape[0] < n:
            cap = n if self._xdev is None else max(
                n, self._xdev.shape[0] * 5 // 4 + 1024)
            old = self._xdev
            self._xdev = torch.empty((cap, d), dtype=torch.float32,
                                     device=self.torch_device)
            if old is not None:
                self._xdev[:lo] = old[:lo]
                del old
            else:
                lo = 0
        self._xdev[lo:n] = torch.from_numpy(
            np.ascontiguousarray(self.x[lo:n])).to(self.torch_device)

    def _medoid(self) -> int:
        mean = self.x.mean(0)
        return int(np.argmin(np.sum((self.x - mean) ** 2, axis=1)))

    def _encode(self, a: np.ndarray, universe: int):
        return self._codec.encode(a, universe) if len(a) else None

    def build(self, x: np.ndarray, adj: List[np.ndarray]) -> "GraphIndex":
        self.x = x.astype(np.float32)
        self.n = x.shape[0]
        self.adj_raw = list(adj)
        self._codec = get_codec(self.id_codec)
        self._blobs = [self._encode(a, self.n) for a in adj]
        # per-node encoding universe: a blob decodes against the universe it
        # was sealed at, so appends re-encode only the nodes they touch
        self._universes = np.full(self.n, self.n, np.int64)
        self.entry = self._medoid()
        self._decoded_cache = self._new_cache()
        self._upload()
        return self

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, object], *, id_codec: str,
                    device="cuda", **fields) -> "GraphIndex":
        """A searchable index from a built graph's plain arrays.

        ``arrays`` holds ``x`` (n, d) f32, ``adj`` (one sorted int64 friend
        list a node), and optionally ``entry`` (default: the medoid, as
        :meth:`build` picks it), ``universes`` (each node's encoding
        universe, default n; the reference's ``_universes``) and
        ``id_map``.  Each list is coded at its universe with the port's
        codec copy — the reference's bytes.  ``fields`` are the remaining
        dataclass fields (``cache_bytes``, ...)."""
        self = cls(id_codec=id_codec, device=device, **fields)
        self.x = np.asarray(arrays["x"], np.float32)
        self.n = self.x.shape[0]
        self.adj_raw = [np.asarray(a, np.int64) for a in arrays["adj"]]
        if len(self.adj_raw) != self.n:
            raise ValueError("need one friend list per row of x")
        uni = arrays.get("universes")
        self._universes = (np.full(self.n, self.n, np.int64) if uni is None
                           else np.asarray(uni, np.int64).copy())
        self._codec = get_codec(id_codec)
        self._blobs = [self._encode(a, int(u))
                       for a, u in zip(self.adj_raw, self._universes)]
        entry = arrays.get("entry")
        self.entry = self._medoid() if entry is None else int(entry)
        if arrays.get("id_map") is not None:
            self.id_map = np.asarray(arrays["id_map"], np.int64)
        self._decoded_cache = self._new_cache()
        self._upload()
        return self

    # -- online ingest -----------------------------------------------------------
    def _ingest_candidates(self, n_old: int, m: int, width: int):
        """Each new row's first ``width`` candidates in the reference's
        ``np.argsort(d, kind="stable")`` order over every earlier row.

        Row ``n_old + t`` ranges over rows ``0 .. n_old + t - 1``
        (``seg_topk`` with ``lens = n_old + t``).  The kernel short-list
        takes every row inside the ``rescore_eps`` band of the
        ``width``-th kernel distance (K doubles while the band may run past
        the cut), is re-scored exactly with ``np_sq_dist`` and ordered by
        (exact distance, row).  Returns ((m, width) int64 -1 padded,
        (m,) counts)."""
        dev = self.torch_device
        xdev = self.base_dev
        d = self.x.shape[1]
        cand = np.full((m, width), -1, np.int64)
        counts = np.minimum(width, n_old + np.arange(m)).astype(np.int64)
        rows = max(1, BLOCK_BYTES[dev.type] // (4 * (n_old + m)))
        for t0 in range(0, m, rows):
            t1 = min(m, t0 + rows)
            b = t1 - t0
            lens_h = (n_old + np.arange(t0, t1)).astype(np.int64)
            if lens_h[-1] == 0:
                continue
            # every block of one add scores the same columns (``lens``
            # masks each row's own range), so the launches share one shape
            ncols = n_old + m - 1
            q = xdev[n_old + t0:n_old + t1]
            qh = self.x[n_old + t0:n_old + t1]
            qn = np.einsum("qd,qd->q", qh, qh)
            dmat = l2_dist(q, xdev[:ncols])
            lens = torch.from_numpy(lens_h.astype(np.int32)).to(dev)
            take = counts[t0:t1]
            K = min(_bucket(width + RESCORE_SLACK, floor=16), ncols)
            while True:
                vals_d, cols_d = seg_topk(dmat, lens, K)
                vals = vals_d.cpu().numpy()
                thr = np.full(b, -np.inf)
                live = take > 0
                bound = vals[np.flatnonzero(live), take[live] - 1].astype(
                    np.float64)
                thr[live] = bound + np.array(
                    [rescore_eps(d, bd, qq) for bd, qq in
                     zip(bound, qn[live])])
                retry = bool(np.any((lens_h > K) & (vals[:, K - 1] <= thr)))
                if not retry or K >= ncols:
                    break
                K = min(2 * K, ncols)
            del dmat
            cols = cols_d.long()
            inband = (vals_d.double() <= torch.from_numpy(thr).to(dev)[:, None]
                      ) & (cols < lens.long()[:, None])
            # short-list in column order, padding last
            big = torch.iinfo(torch.int64).max
            sl, _ = torch.sort(torch.where(inband, cols, big), dim=1)
            ok = sl != big
            ex = np_sq_dist(xdev[sl.masked_fill(~ok, 0)], q[:, None, :])
            ex = ex.masked_fill(~ok, float("inf"))
            o = torch.sort(ex, dim=1, stable=True)[1][:, :width]
            pick = sl.gather(1, o)
            pick = torch.where(ok.gather(1, o), pick, -1)
            got = pick.cpu().numpy()
            cand[t0:t1, :got.shape[1]] = got
        cols = np.arange(width)[None, :]
        cand[cols >= counts[:, None]] = -1
        return cand, counts

    def add(self, x_new: np.ndarray, r: int = 16) -> "GraphIndex":
        """Incremental HNSW-style insertion of new vectors.

        Each new node gets <= ``r`` out-edges by the occlusion rule over
        its ``max(2r, 16)`` nearest earlier rows (old rows and the new rows
        before it), plus reverse edges on its neighbors up to the ``r``
        cap.  The same adjacency, blobs, universes and cache
        invalidations as the reference's row-by-row loop, computed a batch
        at a time on the device: the candidates by ``l2_dist`` +
        ``seg_topk`` and an exact re-score, the prune by
        :func:`prune_kept`, and the reverse edges in closed form (a new
        source is never yet in its target's list, so each target takes
        the first free slots, sources ascending).  Only the touched
        friend lists re-encode, at the grown universe."""
        x_new = np.asarray(x_new, np.float32)
        if x_new.ndim == 1:
            x_new = x_new[None]
        m = x_new.shape[0]
        if m == 0:
            return self
        n_old = self.n
        self.x = np.concatenate([self.x, x_new], axis=0)
        self._upload(n_old)
        self.n = n_old + m
        width = max(2 * r, 16)
        cand, counts = self._ingest_candidates(n_old, m, width)
        new_ids = np.arange(n_old, n_old + m, dtype=np.int64)
        kept = prune_kept(self.base_dev, cand, new_ids, r, lens=counts)
        new_lists = kept_lists(kept)
        # reverse edges: target j takes sources (ascending) into its free
        # slots; a new target's list is its own kept set
        lens_now = np.concatenate(
            [np.fromiter((len(a) for a in self.adj_raw), np.int64, n_old),
             (kept >= 0).sum(axis=1)])
        has = kept >= 0
        dev = self.torch_device
        dst, src = (a.cpu().numpy() for a in _free_slot_edges(
            torch.from_numpy(np.repeat(new_ids, has.sum(axis=1))).to(dev),
            torch.from_numpy(kept[has]).to(dev),
            torch.from_numpy(r - lens_now).to(dev), self.n))
        self.adj_raw.extend(new_lists)
        self._blobs.extend([None] * m)
        touched = np.unique(dst)
        bounds = np.searchsorted(dst, touched, side="left")
        ends = np.searchsorted(dst, touched, side="right")
        for j, lo, hi in zip(touched.tolist(), bounds, ends):
            self.adj_raw[j] = np.sort(np.concatenate(
                [self.adj_raw[j], src[lo:hi]])).astype(np.int64)
        self._universes = np.concatenate(
            [self._universes, np.full(m, self.n, np.int64)])
        for i in np.union1d(touched, new_ids).tolist():
            self._blobs[i] = self._encode(self.adj_raw[i], self.n)
            self._universes[i] = self.n
            self.decoded_cache.invalidate(i)
        if (self.max_epochs is not None
                and self.n_epochs > self.max_epochs):
            self.compact()
        return self

    @property
    def n_epochs(self) -> int:
        """Distinct encoding universes currently live (1 after compact)."""
        return int(np.unique(self._universes).size)

    def compact(self) -> "GraphIndex":
        """Re-encode every friend list at the current universe (the
        offline builders' rates again, at O(n) cost)."""
        self._blobs = [self._encode(a, self.n) for a in self.adj_raw]
        self._universes = np.full(self.n, self.n, np.int64)
        self.decoded_cache.clear()
        return self

    def id_bits(self) -> int:
        return int(sum(self._codec.size_bits(b) for b in self._blobs
                       if b is not None))

    def bits_per_edge(self) -> float:
        edges = sum(len(a) for a in self.adj_raw)
        return self.id_bits() / max(1, edges)

    def _friends(self, i: int) -> np.ndarray:
        """Friend list of node ``i``, decoded through the LRU cache."""
        blob = self._blobs[i]
        if blob is None:
            return np.zeros(0, np.int64)
        universe = int(self._universes[i])
        return self.decoded_cache.get(
            i, lambda: np.asarray(self._codec.decode(blob, universe)))

    def search(self, queries: np.ndarray, ef: int = 16, topk: int = 10,
               engine: str = "auto", query_block: int = 64,
               kernel_min: int | None = None, select: str = "auto"):
        """Beam-batched search (:func:`repro_torch.ann.graph_scan.
        batched_graph_search`), bit-identical to :meth:`search_ref` — ids
        and distances — for every codec, engine, gate and select mode.  On
        a CUDA index ``engine`` ``auto``/``pallas`` scores through the
        Hopper ``l2_dist`` (``xla`` raises); on a CPU index ``auto``/``xla``
        runs its plain torch version (``pallas`` raises)."""
        from .graph_scan import batched_graph_search

        return batched_graph_search(self, queries, ef=ef, topk=topk,
                                    engine=engine, query_block=query_block,
                                    kernel_min=kernel_min, select=select)

    def search_ref(self, queries: np.ndarray, ef: int = 16, topk: int = 10):
        """Best-first (beam ef) search decoding friend lists on the fly —
        the reference's per-query loop, the batched engine's oracle.
        Returns ``(ids, dists, SearchStats)``."""
        t0 = time.perf_counter()
        nq = queries.shape[0]
        ids = np.zeros((nq, topk), np.int64)
        dists = np.full((nq, topk), np.inf, np.float32)
        hops = 0
        ndis = 0
        decodes0 = self.decoded_cache.decodes
        for qi in range(nq):
            q = queries[qi]
            visited = {self.entry}
            d0 = float(np.sum((self.x[self.entry] - q) ** 2))
            ndis += 1
            cand = [(d0, self.entry)]           # min-heap of frontier
            best = [(-d0, self.entry)]          # max-heap of results (size ef)
            while cand:
                d, u = heapq.heappop(cand)
                if d > -best[0][0] and len(best) >= ef:
                    break
                hops += 1
                friends = self._friends(u)
                new = [v for v in friends if v not in visited]
                visited.update(new)
                if not new:
                    continue
                dv = np.sum((self.x[new] - q) ** 2, axis=1)
                ndis += len(new)
                for v, dd in zip(new, dv):
                    dd = float(dd)
                    if len(best) < ef or dd < -best[0][0]:
                        heapq.heappush(cand, (dd, int(v)))
                        heapq.heappush(best, (-dd, int(v)))
                        if len(best) > ef:
                            heapq.heappop(best)
            res = sorted([(-d, v) for d, v in best])[:topk]
            for j, (dd, v) in enumerate(res):
                ids[qi, j] = v
                dists[qi, j] = dd
        stats = SearchStats(
            wall_s=time.perf_counter() - t0,
            ndis=ndis,
            id_resolve_s=0.0,
            decodes=self.decoded_cache.decodes - decodes0,
            engine="graph",
            visited=hops,
        )
        return ids, dists, stats
