"""IVF index with pluggable id/code compression — the port of ``repro.ann.ivf``.

Build: k-means coarse quantizer (K clusters, on the index's device),
vectors stored per cluster (flat f32 or PQ codes, PQ codes optionally
Pólya-coded per Eq. 6-7), ids stored through any
:mod:`repro_torch.core.codecs` codec (one stream per cluster) or jointly
through a wavelet tree (§4.1), epoched for O(Δ) ingest
(:class:`repro_torch.core.epoch.EpochStore`).

State on the device: the centroids and the scanned payload (``vecs`` f32
or PQ ``codes`` u8) live on ``device`` (``centroids_dev``,
``payload_dev``), and the scan gathers each block's arena there.  The
host numpy copies stay: the exact re-score and id resolution decide with
them ("kernels prune, numpy decides"), which keeps results bit-identical
to ``search_ref``.

:meth:`IVFIndex.from_arrays` carries a built index across from its plain
arrays (the reference's, say), re-encoding the ids and Pólya codes with
the port's own codec copies — byte-identical blobs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Mapping, Optional

import numpy as np
import torch

from ..core.epoch import EpochStore
from ..core.polya import PolyaCodec
from ..device import resolve_device
from .kmeans import assign, assign_t, kmeans
from .pq import ProductQuantizer
from .scan import (CacheOwnerMixin, batched_search, coarse_probes,
                   resolve_ids_batch, score_rows_flat, select_topk)
from .stats import SearchStats

__all__ = ["IVFIndex", "SearchStats"]


@dataclasses.dataclass
class IVFIndex(CacheOwnerMixin):
    nlist: int
    id_codec: str = "roc"
    pq: Optional[ProductQuantizer] = None
    code_codec: Optional[str] = None     # None | "polya"
    cache_bytes: Optional[int] = None    # DecodedListCache budget (None = default)
    cache_policy: str = "lru"            # "lru" | "2q"
    max_epochs: Optional[int] = None     # auto-compact past this epoch count
    device: str = "cuda"                 # where the payload lives and is scanned

    def __post_init__(self) -> None:
        self.torch_device = resolve_device(self.device)
        if self.pq is not None:
            self.pq.device = self.device
        self.payload_dev: Optional[torch.Tensor] = None
        self.centroids_dev: Optional[torch.Tensor] = None

    def _to_device(self) -> None:
        """Refresh the device-resident payload and centroids from the
        host copies."""
        host = self.codes if self.pq is not None else self.vecs
        self.payload_dev = torch.from_numpy(
            np.ascontiguousarray(host)).to(self.torch_device)
        self.centroids_dev = torch.from_numpy(np.ascontiguousarray(
            self.centroids, np.float32)).to(self.torch_device)

    def build(self, x: np.ndarray, seed: int = 0,
              centroids: Optional[np.ndarray] = None) -> "IVFIndex":
        self.n, self.d = x.shape
        self.centroids = (centroids if centroids is not None
                          else kmeans(x, self.nlist, iters=8, seed=seed,
                                      device=self.device))
        assign_ = assign(x, self.centroids, device=self.device)
        order = np.argsort(assign_, kind="stable")
        self.cluster_of = assign_
        sizes = np.bincount(assign_, minlength=self.nlist)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.sizes = sizes
        ids_sorted = order.astype(np.int64)
        lists = [ids_sorted[self.offsets[k]: self.offsets[k + 1]]
                 for k in range(self.nlist)]
        # --- vectors / codes, cluster-grouped ---------------------------------
        if self.pq is not None:
            if self.pq.codebooks is None:
                self.pq.train(x)
            codes = self.pq.encode(x)
            self.codes = codes[order]          # grouped by cluster
            self.vecs = None
        else:
            self.codes = None
            self.vecs = x[order].astype(np.float32)
        return self._seal_single_epoch(lists)

    def _seal_single_epoch(self, lists: List[np.ndarray]) -> "IVFIndex":
        """Encode ``lists`` (and Pólya codes) as one epoch over [0, n)."""
        self._lists = lists
        self._ids = EpochStore(self.nlist, self.id_codec)
        self._ids.append(self._lists, 0, self.n)
        if self.code_codec == "polya" and self.codes is not None:
            self._polya = PolyaCodec()
            self._code_blobs = [self._polya.encode(self._per_cluster_codes())]
        else:
            self._code_blobs = None
        self._decoded_cache = self._new_cache()
        self._to_device()
        return self

    def _per_cluster_codes(self) -> List[np.ndarray]:
        return [self.codes[self.offsets[k]: self.offsets[k + 1]]
                for k in range(self.nlist)]

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, object], *, id_codec: str,
                    pq_m: int = 0, code_codec: Optional[str] = None,
                    device="cuda", **fields) -> "IVFIndex":
        """A searchable index from a built index's plain arrays.

        ``arrays`` holds numpy arrays: ``centroids`` (nlist, d),
        ``offsets`` (nlist + 1,), ``sizes`` (nlist,), ``vecs`` (n, d) f32
        or ``codes`` (n, m) u8 grouped by cluster, ``codebooks`` (m, 256,
        d/m) when ``pq_m``, ``lists`` (the per-cluster sorted global id
        lists), and the ints ``n`` and ``d``.  The ids (and Pólya codes)
        are re-encoded here as one epoch over ``[0, n)``; ``fields`` are
        the remaining dataclass fields (``cache_bytes``, ...).
        """
        centroids = np.asarray(arrays["centroids"], np.float32)
        pq = None
        if pq_m:
            pq = ProductQuantizer(m=pq_m, bits=8, codebooks=np.asarray(
                arrays["codebooks"], np.float32))
        self = cls(nlist=centroids.shape[0], id_codec=id_codec, pq=pq,
                   code_codec=code_codec, device=device, **fields)
        self.n, self.d = int(arrays["n"]), int(arrays["d"])
        self.centroids = centroids
        self.offsets = np.asarray(arrays["offsets"], np.int64)
        self.sizes = np.asarray(arrays["sizes"], np.int64)
        if not np.array_equal(self.offsets,
                              np.concatenate([[0], np.cumsum(self.sizes)])):
            raise ValueError("offsets must be the running sum of sizes")
        lists = [np.asarray(lst, np.int64) for lst in arrays["lists"]]
        if len(lists) != self.nlist or any(
                len(lst) != s for lst, s in zip(lists, self.sizes)):
            raise ValueError("need one id list per cluster, sized as sizes")
        self.cluster_of = np.zeros(self.n, np.int64)
        for k, lst in enumerate(lists):
            self.cluster_of[lst] = k
        if pq is not None:
            self.codes = np.asarray(arrays["codes"], np.uint8)
            self.vecs = None
        else:
            self.codes = None
            self.vecs = np.asarray(arrays["vecs"], np.float32)
        return self._seal_single_epoch(lists)

    @classmethod
    def from_state(cls, state: Mapping[str, object], *, device="cuda",
                   **fields) -> "IVFIndex":
        """A searchable index from its sealed state, as a container holds it.

        ``fields`` are the dataclass fields (``nlist``, ``id_codec``,
        ``pq`` with trained codebooks, ``code_codec``, cache and epoch
        options); ``state`` holds the host arrays and encoded ids: ``n``,
        ``d``, ``centroids``, ``sizes``, ``cluster_of``, ``lists`` (global
        sorted ids per cluster), ``ids`` (the :class:`EpochStore`), ``vecs``
        or ``codes`` (cluster-grouped), ``code_blobs`` (Pólya blobs per
        epoch, or None).  The payload and centroids are uploaded to
        ``device`` last, so the index serves from there.
        """
        self = cls(device=device, **fields)
        self.n, self.d = int(state["n"]), int(state["d"])
        self.centroids = np.asarray(state["centroids"], np.float32)
        self.sizes = np.asarray(state["sizes"], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(
            np.int64)
        self.cluster_of = np.asarray(state["cluster_of"], np.int64)
        self._lists = list(state["lists"])
        self._ids = state["ids"]
        self.vecs = state.get("vecs")
        self.codes = state.get("codes")
        self._code_blobs = state.get("code_blobs")
        if self._code_blobs is not None:
            self._polya = PolyaCodec()
        self._decoded_cache = self._new_cache()
        self._to_device()
        return self

    # -- online ingest (epoch scheme) ---------------------------------------------
    def add(self, x: np.ndarray) -> "IVFIndex":
        """Append new vectors to a built index (ids ``n .. n+len(x)-1``).

        Seals one new epoch over exactly the appended rows: only Δ ids
        (and Δ PQ codes) are entropy-coded.  New ids are larger than every
        existing id, so appending to each cluster's tail keeps storage
        order == sorted order across epochs.
        """
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        m = x.shape[0]
        if m == 0:
            return self
        self.append_epoch(x, np.arange(self.n, self.n + m, dtype=np.int64), m)
        return self

    def append_epoch(self, x_new: np.ndarray, new_ids: np.ndarray,
                     count: int) -> "IVFIndex":
        """Seal the epoch ``[n, n + count)`` holding the given rows.

        ``new_ids`` must be strictly ascending global ids inside the epoch
        range; ``count`` may exceed the rows given (a shard holds only the
        rows of the clusters it owns, with the global epoch boundaries).
        """
        base = self.n
        x_new = np.asarray(x_new, np.float32).reshape(-1, self.d)
        new_ids = np.asarray(new_ids, np.int64)
        if x_new.shape[0] != new_ids.shape[0]:
            raise ValueError("one id per appended row")
        if new_ids.size and (
                int(new_ids[0]) < base
                or int(new_ids[-1]) >= base + count
                or np.any(np.diff(new_ids) <= 0)):
            raise ValueError(
                f"epoch ids must be strictly ascending within "
                f"[{base}, {base + count})")
        if new_ids.size:
            assign_new = assign_t(torch.from_numpy(x_new).to(
                self.torch_device), self.centroids_dev).cpu().numpy()
            new_codes = self.pq.encode(x_new) if self.pq is not None else None
        else:
            assign_new = np.zeros(0, np.int64)
            new_codes = None
        # regroup per-cluster storage with the new rows appended in id order
        rel_lists: List[np.ndarray] = []
        epoch_codes: List[np.ndarray] = []
        vec_parts: List[np.ndarray] = []
        for k in range(self.nlist):
            sel = assign_new == k
            rel_lists.append(new_ids[sel] - base)
            self._lists[k] = np.concatenate([self._lists[k], new_ids[sel]])
            lo, hi = self.offsets[k], self.offsets[k + 1]
            if self.pq is not None:
                vec_parts.append(self.codes[lo:hi])
                if sel.any():
                    vec_parts.append(new_codes[sel])
                epoch_codes.append(
                    new_codes[sel] if new_codes is not None
                    else np.zeros((0, self.pq.m), np.uint8))
            else:
                vec_parts.append(self.vecs[lo:hi])
                if sel.any():
                    vec_parts.append(x_new[sel])
        self.sizes = self.sizes + np.bincount(assign_new, minlength=self.nlist)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)]).astype(np.int64)
        if self.pq is not None:
            self.codes = np.concatenate(vec_parts, axis=0)
        else:
            self.vecs = np.concatenate(vec_parts, axis=0)
        ext = np.zeros(count, np.int64)
        ext[new_ids - base] = assign_new
        self.cluster_of = np.concatenate(
            [np.asarray(self.cluster_of, np.int64), ext])
        self._ids.append(rel_lists, base, count)
        if self._code_blobs is not None:
            self._code_blobs.append(self._polya.encode(epoch_codes))
        self.n = base + count
        self._to_device()
        # appends never alias warm (epoch, cluster) cache keys, so no cache
        # invalidation here; compaction renumbers epochs and must clear
        if self.max_epochs is not None and self._ids.n_epochs > self.max_epochs:
            self.compact()
        return self

    @property
    def n_epochs(self) -> int:
        return self._ids.n_epochs

    def compact(self) -> "IVFIndex":
        """Fold every epoch into one ``[0, n)`` blob set (single-universe
        compression rates again, at O(n) cost)."""
        self._ids.compact(self._lists, self.n)
        if self._code_blobs is not None:
            self._code_blobs = [self._polya.encode(self._per_cluster_codes())]
        # epoch indices restarted at 0: stale (epoch, cluster) keys would alias
        self.decoded_cache.clear()
        return self

    # -- sizes -------------------------------------------------------------------
    def id_bits(self) -> int:
        return self._ids.id_bits()

    def bits_per_id(self) -> float:
        return self.id_bits() / self.n

    def code_bits_per_element(self) -> float:
        if self._code_blobs is None:
            return 8.0
        bits = sum(int(b["bits"]) for b in self._code_blobs)
        elems = sum(int(sum(b["sizes"])) * int(b["m"])
                    for b in self._code_blobs)
        return bits / max(1, elems)

    @property
    def _code_blob(self):
        # legacy single-blob view (v1 RIVF container): exact for one epoch,
        # re-encoded from the global grouping otherwise
        if self._code_blobs is None:
            return None
        if len(self._code_blobs) == 1:
            return self._code_blobs[0]
        return self._polya.encode(self._per_cluster_codes())

    # -- id resolution (the §4.1 trick) --------------------------------------------
    def resolve_ids(self, clusters: np.ndarray, offsets: np.ndarray) -> np.ndarray:
        """(cluster, offset) pairs -> database ids, decoding lazily."""
        t0 = time.perf_counter()
        out = resolve_ids_batch(self, clusters, offsets)
        self._last_resolve_s = time.perf_counter() - t0
        return out

    # -- search ---------------------------------------------------------------------
    def search(self, queries: np.ndarray, nprobe: int = 16, topk: int = 10,
               engine: str = "auto", query_block: int = 64,
               with_keys: bool = False, select: str = "auto",
               select_min: int | None = None):
        """Batched search (:func:`repro_torch.ann.scan.batched_search`).
        Returns (ids, dists, SearchStats), bit-identical to
        :meth:`search_ref`.  On a CUDA index ``engine`` ``auto``/``pallas``
        runs the Hopper kernels (``xla`` raises); on a CPU index
        ``auto``/``xla`` runs their plain torch versions (``pallas``
        raises)."""
        return batched_search(self, queries, nprobe=nprobe, topk=topk,
                              engine=engine, query_block=query_block,
                              with_keys=with_keys, select=select,
                              select_min=select_min)

    def search_ref(self, queries: np.ndarray, nprobe: int = 16,
                   topk: int = 10):
        """Reference per-query/per-probe scan in numpy — the batched
        engine's oracle (shared coarse probe, stable top-k, scalar
        scoring).  Test/debug use only."""
        t0 = time.perf_counter()
        nq = queries.shape[0]
        probes = coarse_probes(queries, self.centroids, nprobe)
        tables = self.pq.adc_tables(queries) if self.pq is not None else None
        all_ids = np.zeros((nq, topk), np.int64)
        all_d = np.full((nq, topk), np.inf, np.float32)
        ndis = 0
        res_s = 0.0
        distinct: set = set()
        decodes0 = self.decoded_cache.decodes
        for qi in range(nq):
            cand_d: List[np.ndarray] = []
            cand_k: List[np.ndarray] = []
            cand_o: List[np.ndarray] = []
            for k in probes[qi]:
                lo, hi = self.offsets[k], self.offsets[k + 1]
                if hi == lo:
                    continue
                distinct.add(int(k))
                if self.pq is not None:
                    d = ProductQuantizer.adc_score(self.codes[lo:hi], tables[qi])
                else:
                    d = score_rows_flat(self.vecs[lo:hi], queries[qi])
                ndis += hi - lo
                cand_d.append(d)
                cand_k.append(np.full(hi - lo, k, np.int32))
                cand_o.append(np.arange(hi - lo, dtype=np.int32))
            if not cand_d:
                continue
            d = np.concatenate(cand_d)
            kk = np.concatenate(cand_k)
            oo = np.concatenate(cand_o)
            sel = select_topk(d, topk)
            # late id resolution (paper §4.1)
            ids = self.resolve_ids(kk[sel], oo[sel])
            res_s += self._last_resolve_s
            n_found = len(sel)
            all_ids[qi, :n_found] = ids
            all_d[qi, :n_found] = d[sel]
        wall = time.perf_counter() - t0
        return all_ids, all_d, SearchStats(
            wall_s=wall, ndis=ndis, id_resolve_s=res_s,
            decodes=self.decoded_cache.decodes - decodes0,
            distinct_probed=len(distinct), batches=0, engine="ref")
