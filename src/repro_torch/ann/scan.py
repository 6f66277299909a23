"""Batched compressed-IVF scan engine on PyTorch — the paper's §4.1 at batch scale.

The port of ``repro.ann.scan``.  Same five steps, same results, bit for
bit (``IVFIndex.search`` == ``IVFIndex.search_ref`` == the reference's
``search``):

1. **Coarse probe** for the whole query batch (numpy, shared with the
   oracle so probe sets are bit-identical).
2. **Cluster dedup + arena gather**: the union of probed clusters of a
   query block is gathered once, *on the index's device*, with
   ``index_select`` from the device-resident payload (f32 vectors or u8
   PQ codes) — the arena never crosses the host boundary.
3. **Blocked scoring** of the query block against the arena through the
   Hopper kernels (``l2_dist`` / ``pq_adc``) on a CUDA index, or their
   plain torch versions on a CPU index.
4. **Exact top-k**: the short-list within the kernel-error band of the
   (topk + ``RESCORE_SLACK``)-th best kernel distance is re-scored with
   the oracle's numpy scalar path, so kernel float error only reorders
   the short-list, never the result.  The short-list is cut host-side
   (stable masked argsort over the pulled block) or device-side
   (``select="device"``: candidate gather + ``seg_topk``, only ``(qb, K)``
   short-lists reach the host).
5. **Vectorized late id resolution** through the index's
   :class:`repro_torch.core.epoch.EpochStore` and a
   :class:`DecodedListCache`.

Engines: the index's device decides, not whether CUDA can be found.  On
a CUDA index ``auto``/``pallas`` launch the Hopper kernels and ``xla``
raises; on a CPU index ``auto``/``xla`` run the plain torch versions and
``pallas`` raises.  ``stats.engine`` reports ``"pallas"`` or ``"xla"``.

Batching contract: results are a pure function of (index, queries,
nprobe, topk) — independent of ``query_block``, ``select`` and cache
state.  Only the stats differ.

:func:`batched_flat_search` is the brute-force counterpart for a Flat
index: ``l2_dist`` against the whole (padded) base, ``seg_topk`` on the
device, the same K-doubling retry and numpy re-score, bit-identical to
the per-query numpy loop (``stats.engine`` ``"flat-pallas"`` or
``"flat-xla"``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Dict, List

import numpy as np
import torch

from ..kernels.l2_topk import l2_dist
from ..kernels.pq_adc import pq_adc
from ..kernels.seg_topk import seg_topk
from .pq import ProductQuantizer
from .stats import SearchStats

__all__ = [
    "batched_search",
    "batched_flat_search",
    "padded_base",
    "MERGE_KEY_PAD",
    "coarse_probes",
    "select_topk",
    "score_rows_flat",
    "resolve_ids_batch",
    "rescore_eps",
    "pack_merge_keys",
    "DecodedListCache",
    "CacheOwnerMixin",
]

# extra short-list entries re-scored exactly: kernel scoring only has to get
# the top-k *set* right up to this slack, never the exact float ordering.
RESCORE_SLACK = 8
DEFAULT_QUERY_BLOCK = 64
# select="auto" tile gate: on a CPU index the host numpy select competes
# with a plain torch device select, so only candidate rows at least this
# wide take the device path; a CUDA index always selects on device.
SELECT_MIN_CPU = 4096


# ---------------------------------------------------------------------------
# shared numpy primitives (used by BOTH search_ref and the batched engine so
# parity is by construction)
# ---------------------------------------------------------------------------

def coarse_probes(queries: np.ndarray, centroids: np.ndarray,
                  nprobe: int) -> np.ndarray:
    """(nq, min(nprobe, nlist)) probed clusters, nearest first, stable ties."""
    qc = (
        np.sum(queries**2, 1, keepdims=True)
        - 2.0 * queries @ centroids.T
        + np.sum(centroids**2, 1)[None]
    )
    nprobe = min(nprobe, centroids.shape[0])
    return np.argsort(qc, axis=1, kind="stable")[:, :nprobe]


def select_topk(d: np.ndarray, topk: int) -> np.ndarray:
    """Indices of the ``topk`` smallest entries, ties to the earlier index."""
    return np.argsort(d, kind="stable")[: min(topk, d.shape[0])]


def score_rows_flat(rows: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Squared L2 of each row to ``q`` — the oracle's scalar scoring path."""
    diff = rows - q[None]
    return np.einsum("nd,nd->n", diff, diff)


def rescore_eps(d: int, bound: float, qn: float, factor: float = 16.0) -> float:
    """Error band of the kernels' expanded ``qn - 2qc + cn`` f32 scoring.

    The expanded form cancels catastrophically for near-duplicate vectors,
    so kernel distances near a decision ``bound`` may be mis-ranked by up
    to the cancellation error; exact decisions must re-score everything
    within this band.  ``factor`` carries headroom over the d-term f32
    contraction bound — too wide only re-scores a few extra rows, never
    breaks parity.
    """
    scale = 1.0 + abs(float(bound)) + float(qn)
    return factor * d * float(np.finfo(np.float32).eps) * scale


# ---------------------------------------------------------------------------
# decoded-list LRU cache
# ---------------------------------------------------------------------------

class DecodedListCache:
    """Byte-budgeted cache over decoded id lists, LRU or 2Q.

    ``policy="lru"`` (default) is plain recency eviction.  ``policy="2q"``
    is a segmented LRU: first touch lands an entry in a *probation*
    segment, a second touch promotes it to a *protected* segment (capped
    at ``HOT_FRACTION`` of the budget, demoting its own LRU tail back to
    probation), and eviction always drains probation first — so a scan
    over many cold clusters cannot flush the clusters that skewed query
    traffic keeps hot.

    Keys are ``(epoch, cluster)`` pairs: appends create fresh keys and
    never alias warm ones, so ingest needs no invalidation (only
    compaction, which renumbers epochs, calls :meth:`clear`).
    """

    HOT_FRACTION = 0.75

    def __init__(self, max_bytes: int = 64 << 20, policy: str = "lru"):
        if policy not in ("lru", "2q"):
            raise ValueError(f"unknown cache policy {policy!r} "
                             "(options: lru, 2q)")
        self.max_bytes = int(max_bytes)
        self.policy = policy
        self._lists: "OrderedDict[object, np.ndarray]" = OrderedDict()
        self._hot: "OrderedDict[object, np.ndarray]" = OrderedDict()
        self._hot_bytes = 0
        self.bytes = 0
        self.hits = 0
        self.decodes = 0
        self.evictions = 0
        self.promotions = 0

    def __len__(self) -> int:
        return len(self._lists) + len(self._hot)

    def _evict(self) -> None:
        # probation (or the sole LRU segment) drains first; the protected
        # segment is only touched once probation is empty
        while self.bytes > self.max_bytes and len(self) > 1:
            if self._lists:
                _, old = self._lists.popitem(last=False)
            else:
                _, old = self._hot.popitem(last=False)
                self._hot_bytes -= old.nbytes
            self.bytes -= old.nbytes
            self.evictions += 1

    def _shrink_hot(self) -> None:
        cap = self.HOT_FRACTION * self.max_bytes
        while self._hot_bytes > cap and len(self._hot) > 1:
            key, old = self._hot.popitem(last=False)
            self._hot_bytes -= old.nbytes
            self._lists[key] = old          # demote to probation MRU

    def get(self, key, decode: Callable[[], np.ndarray]) -> np.ndarray:
        hot = self._hot.get(key)
        if hot is not None:
            self._hot.move_to_end(key)
            self.hits += 1
            return hot
        hit = self._lists.get(key)
        if hit is not None:
            self.hits += 1
            if self.policy == "2q":
                del self._lists[key]        # second touch: promote
                self._hot[key] = hit
                self._hot_bytes += hit.nbytes
                self.promotions += 1
                self._shrink_hot()
            else:
                self._lists.move_to_end(key)
            return hit
        arr = np.asarray(decode())
        self.decodes += 1
        self._lists[key] = arr
        self.bytes += arr.nbytes
        self._evict()
        return arr

    def invalidate(self, key) -> None:
        """Drop one entry (not counted as an eviction); no-op if absent."""
        old = self._lists.pop(key, None)
        if old is None:
            old = self._hot.pop(key, None)
            if old is not None:
                self._hot_bytes -= old.nbytes
        if old is not None:
            self.bytes -= old.nbytes

    def clear(self) -> None:
        self._lists.clear()
        self._hot.clear()
        self._hot_bytes = 0
        self.bytes = 0

    def set_budget(self, max_bytes: int) -> None:
        """Change the byte budget, evicting entries down to it."""
        self.max_bytes = int(max_bytes)
        self._evict()
        if self.policy == "2q":
            self._shrink_hot()

    def stats(self) -> Dict[str, int]:
        out = {
            "entries": len(self),
            "bytes": self.bytes,
            "hits": self.hits,
            "decodes": self.decodes,
            "evictions": self.evictions,
        }
        if self.policy == "2q":
            out["promotions"] = self.promotions
            out["protected_entries"] = len(self._hot)
        return out


class CacheOwnerMixin:
    """Cache plumbing of an index that owns a :class:`DecodedListCache`.

    Builds the cache from the owner's ``cache_bytes`` / ``cache_policy``
    fields, and re-attaches one on unpickle (``__setstate__``).
    """

    def _new_cache(self) -> DecodedListCache:
        budget = getattr(self, "cache_bytes", None)
        policy = getattr(self, "cache_policy", None) or "lru"
        if budget is not None:
            return DecodedListCache(max_bytes=int(budget), policy=policy)
        return DecodedListCache(policy=policy)

    @property
    def decoded_cache(self) -> DecodedListCache:
        return self._decoded_cache

    def __getstate__(self) -> dict:
        state = dict(self.__dict__)
        state.pop("_decoded_cache", None)   # transient derived state
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        if "_decoded_cache" not in self.__dict__:
            self._decoded_cache = self._new_cache()


# ---------------------------------------------------------------------------
# vectorized late id resolution (§4.1)
# ---------------------------------------------------------------------------

def resolve_ids_batch(index, clusters: np.ndarray,
                      offsets: np.ndarray) -> np.ndarray:
    """Resolve all ``(cluster, offset)`` pairs in one pass through the
    index's epoch store (stream codecs decode each distinct ``(epoch,
    cluster)`` at most once per call via the index's cache)."""
    return index._ids.resolve(clusters, offsets, index.decoded_cache)


# ---------------------------------------------------------------------------
# device-side candidate gather + segmented top-k
# ---------------------------------------------------------------------------

def _bucket(n: int, floor: int = 1024) -> int:
    """Next power-of-two >= n (floored)."""
    b = floor
    while b < n:
        b *= 2
    return b


def _device_select(dmat: torch.Tensor, probes: torch.Tensor,
                   start_of: torch.Tensor, size_of: torch.Tensor,
                   c_pad: int, k: int):
    """Candidate gather + segmented top-k on the block's device.

    From the per-block metadata (probed clusters per query, arena span
    start/size per cluster) the candidate -> arena-position map is
    recomputed on device, the scored block is gathered in place, and
    ``seg_topk`` cuts each row to its ``k`` smallest ``(value, column)``
    pairs — so the ``(qb, c_pad)`` block never reaches the host; only
    ``(qb, k)`` values, candidate columns and arena positions do.
    """
    qb, n_probe = probes.shape
    pp = size_of[probes]                               # (qb, P)
    cum = torch.cumsum(pp, dim=1)
    col = torch.arange(c_pad, dtype=torch.int64, device=dmat.device)
    # probe owning each candidate column: count of probe-end offsets <= col
    # (right=True skips zero-size probes, matching the host concatenation)
    pidx = torch.searchsorted(cum, col.expand(qb, c_pad).contiguous(),
                              right=True)
    total = cum[:, -1:]
    valid = col[None, :] < total
    pc = pidx.clamp(max=n_probe - 1)
    prev = torch.where(pidx > 0, cum.gather(1, pidx.clamp(min=1) - 1),
                       torch.zeros_like(pidx))
    cl = probes.gather(1, pc)
    pos = (start_of[cl] + (col[None, :] - prev)).clamp(0, dmat.shape[1] - 1)
    d = torch.where(valid, dmat.gather(1, pos),
                    torch.full((), float("inf"), device=dmat.device))
    lens = total[:, 0].clamp(max=c_pad).to(torch.int32)
    vals, cols = seg_topk(d.contiguous(), lens.contiguous(), k)
    pos_sel = pos.gather(1, cols.to(torch.int64))
    return vals, cols, pos_sel


def _resolve_select(select: str, c_pad: int, select_min: int) -> bool:
    """True when this block's top-k runs on device (see ``batched_search``)."""
    if select == "host":
        return False
    if select == "device":
        return True
    if select != "auto":
        raise ValueError(f"unknown select mode {select!r} "
                         "(options: auto, host, device)")
    return c_pad >= select_min


def _resolve_engine(engine: str, device: torch.device) -> str:
    """Engine name for an index on ``device``; raises on a mismatch."""
    if engine not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown scan engine {engine!r}")
    if device.type == "cuda":
        if engine == "xla":
            raise ValueError("engine='xla' is the plain torch path of a CPU "
                             "index; a CUDA index runs the Hopper kernels "
                             "(engine='auto' or 'pallas')")
        return "pallas"
    if engine == "pallas":
        raise ValueError("engine='pallas' launches the Hopper kernels, which "
                         "need a CUDA index (device='cuda'); a CPU index runs "
                         "engine='auto' or 'xla'")
    return "xla"


# ---------------------------------------------------------------------------
# the batched search
# ---------------------------------------------------------------------------

def _spans_concat(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """concat(arange(s, s+l) for s, l in zip(starts, lens)) without a loop."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    cum = np.cumsum(lens) - lens
    idx = np.arange(total, dtype=np.int64)
    return np.repeat(starts - cum, lens) + idx


MERGE_KEY_PAD = np.uint64(np.iinfo(np.uint64).max)

# merge-key layout: (probe_rank << 40) | in-cluster offset.  40 offset bits
# cap any single cluster at 2^40 rows; the remaining 24 rank bits cap nprobe
# at 2^24.  A silent wrap would corrupt a sharded merge order, so packing
# checks explicitly.
MERGE_KEY_OFFSET_BITS = 40
MERGE_KEY_RANK_BITS = 64 - MERGE_KEY_OFFSET_BITS


def pack_merge_keys(ranks: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """``(probe_rank << 40) | offset`` uint64 tie-order keys, overflow-checked."""
    ranks = np.asarray(ranks, np.uint64)
    offs = np.asarray(offs, np.uint64)
    if offs.size and int(offs.max()) >= (1 << MERGE_KEY_OFFSET_BITS):
        raise OverflowError(
            f"in-cluster offset {int(offs.max())} needs more than "
            f"{MERGE_KEY_OFFSET_BITS} merge-key bits")
    if ranks.size and int(ranks.max()) >= (1 << MERGE_KEY_RANK_BITS):
        raise OverflowError(
            f"probe rank {int(ranks.max())} needs more than "
            f"{MERGE_KEY_RANK_BITS} merge-key bits")
    return (ranks << np.uint64(MERGE_KEY_OFFSET_BITS)) | offs


def batched_search(index, queries: np.ndarray, nprobe: int = 16,
                   topk: int = 10, engine: str = "auto",
                   query_block: int = DEFAULT_QUERY_BLOCK,
                   with_keys: bool = False, select: str = "auto",
                   select_min: int | None = None):
    """Batched IVF search; bit-identical to ``index.search_ref``.

    Returns ``(ids (nq, topk) int64, dists (nq, topk) f32, SearchStats)``.

    ``index`` is a :class:`repro_torch.ann.ivf.IVFIndex`: the engine reads
    its host arrays (``centroids``, ``offsets``, ``sizes``, ``vecs`` /
    ``codes``, ``pq``) and its device payload (``payload_dev``).

    ``select`` places the top-k cut: ``"host"`` pulls the scored block and
    argsorts in numpy; ``"device"`` runs the candidate gather +
    ``seg_topk`` on the index's device so only ``(qb, K)`` short-lists
    cross to the host; ``"auto"`` takes the device path when the candidate
    row is at least ``select_min`` wide (default: ``SELECT_MIN_CPU`` on a
    CPU index, always on a CUDA index).  Both cuts produce the same
    short-list set, so results are bit-identical across ``select``; only
    ``stats.host_block_bytes`` / ``stats.device_select`` differ.

    ``with_keys=True`` fills ``stats.merge_keys`` with (nq, topk) uint64
    ``(probe_rank << 40) | in-cluster offset`` keys (``MERGE_KEY_PAD`` in
    padding slots): each result's position in the monolithic stable
    candidate order.
    """
    dev = index.torch_device
    engine = _resolve_engine(engine, dev)
    if select not in ("auto", "host", "device"):
        raise ValueError(f"unknown select mode {select!r} "
                         "(options: auto, host, device)")
    t0 = time.perf_counter()
    queries = np.asarray(queries)
    nq = queries.shape[0]
    all_ids = np.zeros((nq, topk), np.int64)
    all_d = np.full((nq, topk), np.inf, np.float32)
    probes = coarse_probes(queries, index.centroids, nprobe)
    tables = index.pq.adc_tables(queries) if index.pq is not None else None
    use_pq = index.pq is not None
    if select_min is None:
        select_min = SELECT_MIN_CPU if dev.type == "cpu" else 1
    payload = index.payload_dev
    scorer = pq_adc if use_pq else l2_dist

    offsets, sizes = index.offsets, index.sizes
    ndis = 0
    nbatches = 0
    host_block_bytes = 0
    n_dev_select = 0
    distinct: set = set()
    decodes_before = index.decoded_cache.decodes
    # winning (cluster, offset) pairs across the whole call, resolved in one
    # pass at the end
    res_q: List[np.ndarray] = []
    res_slot: List[np.ndarray] = []
    res_cluster: List[np.ndarray] = []
    res_offset: List[np.ndarray] = []
    res_key: List[np.ndarray] = []
    all_keys = (np.full((nq, topk), MERGE_KEY_PAD, np.uint64)
                if with_keys else None)

    for q0 in range(0, nq, query_block):
        q1 = min(nq, q0 + query_block)
        qb = q1 - q0
        nbatches += 1
        blk_probes = probes[q0:q1]
        # --- dedup probed clusters; build the arena ------------------------
        uniq = np.unique(blk_probes)
        uniq_sizes = sizes[uniq].astype(np.int64)
        keep = uniq_sizes > 0
        uniq, uniq_sizes = uniq[keep], uniq_sizes[keep]
        distinct.update(int(k) for k in uniq)
        arena_start = np.cumsum(uniq_sizes) - uniq_sizes
        arena_rows = _spans_concat(offsets[uniq], uniq_sizes)
        # cluster id -> arena span start (dense map over probed ids only)
        start_of = np.full(index.nlist, -1, dtype=np.int64)
        size_of = np.zeros(index.nlist, dtype=np.int64)
        start_of[uniq] = arena_start
        size_of[uniq] = uniq_sizes
        if with_keys:
            # probe rank of each cluster per query
            rank_of = np.zeros((qb, index.nlist), np.uint64)
            rank_of[np.arange(qb)[:, None], blk_probes] = np.arange(
                blk_probes.shape[1], dtype=np.uint64)[None]

        # --- per-query padded candidate rows (probe order == oracle order) -
        pp_sizes = size_of[blk_probes]              # (qb, P)
        cand_lens = pp_sizes.sum(axis=1)
        ndis += int(cand_lens.sum())
        c_pad = int(cand_lens.max()) if qb else 0
        if c_pad == 0:
            continue

        # --- arena gather + blocked scoring on the index's device ----------
        arena = payload.index_select(
            0, torch.from_numpy(arena_rows).to(dev))
        if use_pq:
            dmat = scorer(torch.from_numpy(tables[q0:q1]).to(dev), arena)
        else:
            dmat = scorer(torch.from_numpy(
                np.ascontiguousarray(queries[q0:q1], np.float32)).to(dev),
                arena)
            qn_host = np.einsum("qd,qd->q",
                                queries[q0:q1].astype(np.float32),
                                queries[q0:q1].astype(np.float32))

        def finish(i, qi, pos):
            # exact re-score of one query's short-list; ``pos`` holds the
            # selected arena positions in candidate (oracle concat) order,
            # so select_topk's stable tie-break reproduces the oracle's.
            rows = arena_rows[pos]
            if use_pq:
                d_exact = ProductQuantizer.adc_score(
                    index.codes[rows], tables[qi])
            else:
                d_exact = score_rows_flat(index.vecs[rows], queries[qi])
            best = select_topk(d_exact, topk)
            n_found = best.shape[0]
            all_d[qi, :n_found] = d_exact[best]
            # (cluster, offset) from arena position
            p = pos[best]
            span = np.searchsorted(arena_start, p, side="right") - 1
            res_q.append(np.full(n_found, qi, np.int64))
            res_slot.append(np.arange(n_found, dtype=np.int64))
            res_cluster.append(uniq[span])
            res_offset.append(p - arena_start[span])
            if with_keys:
                res_key.append(pack_merge_keys(rank_of[i, uniq[span]],
                                               p - arena_start[span]))

        if _resolve_select(select, c_pad, select_min):
            # --- device-side segmented top-k -------------------------------
            # the (qb, C_pad) block stays on device: gather + seg_topk return
            # (qb, K) shortlist values / candidate columns / arena positions,
            # the host recomputes the SAME short-list threshold the host path
            # uses (bound of the take-th smallest kernel value + rescore_eps,
            # in float64 over identical f32 values), and K doubles while any
            # row's shortlist might extend past it — so the cut set matches
            # the host path exactly.
            n_dev_select += 1
            c_pad_b = _bucket(c_pad, floor=128)
            probes_dev = torch.from_numpy(
                np.ascontiguousarray(blk_probes, np.int64)).to(dev)
            start_dev = torch.from_numpy(np.maximum(start_of, 0)).to(dev)
            size_dev = torch.from_numpy(size_of).to(dev)
            K = min(_bucket(min(topk + RESCORE_SLACK, c_pad), floor=16),
                    c_pad_b)
            while True:
                vals_d, cols_d, pos_d = _device_select(
                    dmat, probes_dev, start_dev, size_dev, c_pad_b, K)
                vals = vals_d.cpu().numpy()
                sel_cols = cols_d.cpu().numpy()
                sel_pos = pos_d.cpu().numpy()
                host_block_bytes += (vals.nbytes + sel_cols.nbytes
                                     + sel_pos.nbytes)
                thr = np.full(qb, -np.inf)
                retry = False
                for i in range(qb):
                    nvalid = int(cand_lens[i])
                    if nvalid == 0:
                        continue
                    take = min(topk + RESCORE_SLACK, nvalid)
                    bound = float(vals[i, take - 1])
                    eps = rescore_eps(index.d, bound,
                                      0.0 if use_pq else float(qn_host[i]))
                    thr[i] = bound + eps
                    if nvalid > K and vals[i, K - 1] <= thr[i]:
                        retry = True    # band may extend past the K cut
                if not retry or K >= c_pad_b:
                    break
                K = min(2 * K, c_pad_b)
            for i in range(qb):
                qi = q0 + i
                nvalid = int(cand_lens[i])
                if nvalid == 0:
                    continue
                # vals are ascending: count the entries inside the band,
                # drop padding columns (>= nvalid; real +inf hits keep
                # their column < nvalid), restore oracle concat order
                cnt = int(np.searchsorted(vals[i], thr[i], side="right"))
                cc, pp_sel = sel_cols[i, :cnt], sel_pos[i, :cnt]
                real = cc < nvalid
                cc, pp_sel = cc[real], pp_sel[real]
                finish(i, qi, pp_sel[np.argsort(cc)].astype(np.int64))
            continue

        # --- host-side stable top-k over the pulled block ------------------
        flat_pos = _spans_concat(start_of[blk_probes].ravel(),
                                 pp_sizes.ravel())
        cand_pos = np.full((qb, c_pad), -1, dtype=np.int64)
        row_ids = np.repeat(np.arange(qb), cand_lens)
        col_ids = np.concatenate([np.arange(c) for c in cand_lens])
        cand_pos[row_ids, col_ids] = flat_pos
        dmat = dmat.cpu().numpy()
        host_block_bytes += dmat.nbytes
        safe_pos = np.clip(cand_pos, 0, dmat.shape[1] - 1)
        d_blk = np.where(
            cand_pos >= 0,
            np.take_along_axis(dmat, safe_pos, axis=1),
            np.inf,
        ).astype(np.float32)
        order = np.argsort(d_blk, axis=1, kind="stable")
        for i in range(qb):
            qi = q0 + i
            nvalid = int(cand_lens[i])
            take = min(topk + RESCORE_SLACK, nvalid)
            if take == 0:
                continue
            # kernel distances only have to get the top-k *set* right; the
            # expanded qn-2qc+cn form cancels for near-duplicate vectors, so
            # extend the shortlist through that error band so the exact
            # re-score sees every potential top-k member.
            row = d_blk[i]
            bound = float(row[order[i, take - 1]])
            eps = rescore_eps(index.d, bound,
                              0.0 if use_pq else float(qn_host[i]))
            while take < nvalid and row[order[i, take]] <= bound + eps:
                take += 1
            # candidate *row positions* are the oracle's concat positions:
            # sorting them restores the oracle's stable tie order.
            sel = np.sort(order[i, :take])
            finish(i, qi, cand_pos[i, sel])

    # --- late id resolution: one pass over every winning pair --------------
    t_res = time.perf_counter()
    if res_q:
        rq = np.concatenate(res_q)
        rs = np.concatenate(res_slot)
        ids = resolve_ids_batch(
            index, np.concatenate(res_cluster), np.concatenate(res_offset))
        all_ids[rq, rs] = ids
        if with_keys:
            all_keys[rq, rs] = np.concatenate(res_key)
    resolve_s = time.perf_counter() - t_res
    index._last_resolve_s = resolve_s

    stats = SearchStats(
        wall_s=time.perf_counter() - t0,
        ndis=ndis,
        id_resolve_s=resolve_s,
        decodes=index.decoded_cache.decodes - decodes_before,
        distinct_probed=len(distinct),
        batches=nbatches,
        engine=engine,
        host_block_bytes=host_block_bytes,
        device_select=n_dev_select,
        merge_keys=all_keys,
    )
    return all_ids, all_d, stats


# ---------------------------------------------------------------------------
# batched flat (brute-force) search
# ---------------------------------------------------------------------------

def padded_base(vecs: np.ndarray, device) -> torch.Tensor:
    """``vecs`` as the (``_bucket(n)``, d) f32 base that
    :func:`batched_flat_search` scores against: on ``device``, zero rows
    past ``n``."""
    n, d = vecs.shape
    base = torch.zeros((_bucket(max(n, 1)), d), dtype=torch.float32,
                       device=device)
    base[:n] = torch.from_numpy(np.ascontiguousarray(vecs, np.float32)).to(
        device)
    return base


def batched_flat_search(vecs: np.ndarray, base_dev: torch.Tensor,
                        queries: np.ndarray, topk: int = 10,
                        engine: str = "auto",
                        query_block: int = DEFAULT_QUERY_BLOCK):
    """Kernel-scored brute-force search; bit-identical to the numpy loop.

    ``vecs`` is the (n, d) f32 base on the host and ``base_dev`` the same
    rows on the device, padded with zero rows to ``n_pad = _bucket(n)``
    (:func:`padded_base`; a caller that searches the same rows again keeps
    it rather than uploading it per call).  Its device picks the engine.
    Each query block is scored against the whole base with
    ``l2_dist`` (the Hopper kernel on a CUDA base, its plain torch version
    on a CPU one), the ``(qb, n_pad)`` block stays on the device and is cut
    by ``seg_topk`` (``lens = n``), and only ``(qb, K)`` short-lists reach
    the host; K doubles while a row's ``rescore_eps`` band may run past the
    cut.  The short-list is re-scored with the oracle's numpy scalar path
    (``score_rows_flat`` + ``select_topk``), so ids **and** distances equal
    ``np.argsort(score_rows_flat(...))``'s, ties to the lower row, on either
    device.

    Returns ``(ids (nq, topk) int64, dists (nq, topk) f32, SearchStats)``
    with ``engine="flat-pallas"`` (CUDA base) or ``"flat-xla"`` (CPU).
    """
    dev = base_dev.device
    engine = _resolve_engine(engine, dev)
    t0 = time.perf_counter()
    queries = np.asarray(queries, np.float32)
    nq, d = queries.shape
    n = vecs.shape[0]
    topk_eff = min(topk, n)
    all_ids = np.zeros((nq, topk), np.int64)
    all_d = np.full((nq, topk), np.inf, np.float32)
    base = base_dev
    n_pad = base.shape[0]
    nbatches = 0
    host_block_bytes = 0
    n_dev_select = 0
    for q0 in range(0, nq if n else 0, query_block):
        q1 = min(nq, q0 + query_block)
        qb = q1 - q0
        nbatches += 1
        n_dev_select += 1
        qblk = np.ascontiguousarray(queries[q0:q1])
        qn_host = np.einsum("qd,qd->q", qblk, qblk)
        dmat = l2_dist(torch.from_numpy(qblk).to(dev), base)
        lens = torch.full((qb,), n, dtype=torch.int32, device=dev)
        take = min(topk_eff + RESCORE_SLACK, n)
        K = min(_bucket(take, floor=16), n_pad)
        while True:
            vals_d, cols_d = seg_topk(dmat, lens, K)
            vals = vals_d.cpu().numpy()
            cols = cols_d.cpu().numpy()
            host_block_bytes += vals.nbytes + cols.nbytes
            thr = np.empty(qb)
            retry = False
            for i in range(qb):
                bound = float(vals[i, take - 1])
                thr[i] = bound + rescore_eps(d, bound, float(qn_host[i]))
                if n > K and vals[i, K - 1] <= thr[i]:
                    retry = True        # band may extend past the K cut
            if not retry or K >= n_pad:
                break
            K = min(2 * K, n_pad)
        for i in range(qb):
            qi = q0 + i
            cnt = int(np.searchsorted(vals[i], thr[i], side="right"))
            rows = cols[i, :cnt]
            rows = np.sort(rows[rows < n]).astype(np.int64)
            d_exact = score_rows_flat(vecs[rows], queries[qi])
            best = select_topk(d_exact, topk)
            n_found = best.shape[0]
            all_ids[qi, :n_found] = rows[best]
            all_d[qi, :n_found] = d_exact[best]

    stats = SearchStats(
        wall_s=time.perf_counter() - t0,
        ndis=n * nq,
        id_resolve_s=0.0,
        batches=nbatches,
        engine=f"flat-{engine}",
        host_block_bytes=host_block_bytes,
        device_select=n_dev_select,
    )
    return all_ids, all_d, stats
