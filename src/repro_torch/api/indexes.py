"""Concrete :class:`repro_torch.api.Index` implementations.

Adapters presenting the port's index structures through the one protocol
(faiss ``(dists, ids)`` order, uniform :class:`SearchStats`, uniform
memory ledger):

* :class:`FlatIndex`   — exact brute-force baseline (no compression),
  the recall oracle of every other index.
* :class:`IVFApiIndex` — wraps :class:`repro_torch.ann.ivf.IVFIndex` (all
  id codecs + wavelet tree, optional PQ / Pólya codes).
* :class:`GraphApiIndex` — wraps :class:`repro_torch.ann.graph.GraphIndex`
  (NSG / HNSW, friend lists through any per-list id codec).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ann.graph import GraphIndex, build_hnsw, build_nsg
from ..ann.ivf import IVFIndex
from ..ann.pq import ProductQuantizer
from ..ann.scan import (batched_flat_search, padded_base, score_rows_flat,
                        select_topk)
from ..ann.stats import SearchStats
from ..device import resolve_device
from .protocol import Index
from .spec import IndexSpec, parse_spec

__all__ = ["FlatIndex", "IVFApiIndex", "GraphApiIndex", "as_api_index",
           "make_index"]


def _cache_bytes(spec: IndexSpec) -> Optional[int]:
    if spec.cache_mb is None:
        return None
    return int(spec.cache_mb * (1 << 20))


def _ingest_fields(spec: IndexSpec) -> dict:
    """Constructor kwargs of the inner index that the spec carries."""
    return dict(cache_bytes=_cache_bytes(spec),
                cache_policy=spec.cache_policy or "lru",
                max_epochs=spec.max_epochs)


class FlatIndex:
    """Exact brute-force search over raw f32 vectors (the recall oracle).

    ``id_map`` (set by the shard planner, serialized in the RIDX
    container) remaps local row indices to global database ids: a
    hash-partitioned shard holds a row subset but still answers with the
    unsharded id space.  Rows are kept in ascending global-id order, so the
    stable local tie-break (smaller row first) coincides with the
    monolithic one (smaller id first) and sharded merges stay
    bit-identical.

    ``device`` (default ``"cuda"``) is where the kernel path scores: the
    base, padded to ``_bucket(n)`` rows, is uploaded there once at the
    first kernel search (``base_dev``) and dropped whenever ``add`` or
    ``append_rows`` changes the rows.
    """

    def __init__(self, spec: Optional[IndexSpec] = None, device="cuda"):
        self.index_spec = spec or IndexSpec(kind="flat")
        self.torch_device = resolve_device(device)
        self.id_map: Optional[np.ndarray] = None
        self._base_dev: Optional[torch.Tensor] = None

    @property
    def spec(self) -> str:
        """Canonical factory string (``index_factory(idx.spec)`` rebuilds)."""
        return str(self.index_spec)

    @property
    def device(self):
        """The ``torch.device`` the kernel path scores on."""
        return self.torch_device

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(spec={self.spec!r}, "
                f"n={getattr(self, 'n', None)}, device={self.device})")

    def _set_rows(self, vecs: np.ndarray) -> None:
        self.vecs = vecs
        self.n, self.d = vecs.shape
        self._base_dev = None               # stale: re-upload on next use

    @property
    def base_dev(self) -> torch.Tensor:
        """The (``_bucket(n)``, d) f32 base on the index's device, zero rows
        past ``n``; uploaded at first use and kept until the rows change."""
        if self._base_dev is None:
            self._base_dev = padded_base(self.vecs, self.torch_device)
        return self._base_dev

    def build(self, x: np.ndarray, seed: int = 0) -> "FlatIndex":
        """Store ``x`` as the (n, d) f32 base matrix; no trained state."""
        del seed  # no trained state; accepted for protocol uniformity
        self._set_rows(np.ascontiguousarray(x, np.float32))
        return self

    def add(self, x: np.ndarray) -> "FlatIndex":
        """Append rows (dense ids ``n..n+m-1``); planner shards must route
        ingest through :meth:`append_rows` instead."""
        if self.id_map is not None:
            raise ValueError("cannot add() to a planner-made Flat shard: "
                             "its global-id mapping is fixed by the plan")
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        self._set_rows(np.concatenate([self.vecs, x], axis=0))
        return self

    def append_rows(self, x: np.ndarray,
                    global_ids: np.ndarray) -> "FlatIndex":
        """Routed ingest for a planner-made shard: append the owned rows
        and extend ``id_map``.  New global ids exceed every existing one,
        so ascending order (the sharded tie-break invariant) is kept."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        global_ids = np.asarray(global_ids, np.int64)
        if x.shape[0] != global_ids.shape[0]:
            raise ValueError("one global id per appended row")
        if x.shape[0] == 0:
            return self
        if self.id_map is None:
            if np.any(global_ids != self.n + np.arange(global_ids.size)):
                raise ValueError("unsharded Flat ingest must be dense "
                                 "(ids n..n+m-1); use add()")
            self._set_rows(np.concatenate([self.vecs, x], axis=0))
            return self
        if self.id_map.size and int(global_ids[0]) <= int(self.id_map[-1]):
            raise ValueError("appended global ids must exceed existing ones")
        self._set_rows(np.concatenate([self.vecs, x], axis=0))
        self.id_map = np.concatenate([self.id_map, global_ids])
        return self

    def search(self, queries: np.ndarray, k: int = 10,
               engine: Optional[str] = None, query_block: int = 64, **opts):
        """Exact k-NN.

        ``engine`` (or ``Flat,engine=...`` in the spec) routes scoring
        through the kernel path
        (:func:`repro_torch.ann.scan.batched_flat_search`: ``l2_dist`` +
        device-side ``seg_topk``); ``auto``/``pallas`` on a CUDA index,
        ``auto``/``xla`` on a CPU one.  Without an engine a CUDA index
        takes the kernel path too (``engine="auto"``), while a CPU index
        runs the per-query numpy loop (``stats.engine == "flat"``) as the
        reference's ``FlatIndex`` does: a CUDA index never serves from the
        host loop.  Results are bit-identical either way — the kernel path
        re-scores its short-list with the same scalar numpy expression —
        only ``stats.engine`` and the select counters tell them apart."""
        if opts:
            raise TypeError(f"FlatIndex.search got unknown options {sorted(opts)}")
        engine = engine or self.index_spec.engine
        if engine is None and self.torch_device.type == "cuda":
            engine = "auto"
        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        if engine is not None:
            ids, dists, stats = batched_flat_search(
                self.vecs, self.base_dev, queries, topk=k, engine=engine,
                query_block=query_block)
        else:
            t0 = time.perf_counter()
            k_eff = min(k, self.n)
            ids = np.zeros((nq, k), np.int64)
            dists = np.full((nq, k), np.inf, np.float32)
            # scalar numpy scoring per query: deterministic, stable ties
            for qi in range(nq):
                d = score_rows_flat(self.vecs, queries[qi])
                sel = select_topk(d, k_eff)
                ids[qi, :k_eff] = sel
                dists[qi, :k_eff] = d[sel]
            stats = SearchStats(wall_s=time.perf_counter() - t0,
                                ndis=self.n * nq, id_resolve_s=0.0,
                                engine="flat")
        if self.id_map is not None:
            # remap valid slots only: padding must stay id 0 / dist inf
            ids = np.where(np.isfinite(dists), self.id_map[ids], 0)
        return dists, ids, stats

    def memory_ledger(self) -> Dict[str, float]:
        """Bytes by component (vectors + optional id_map); flat stores no
        compressed ids, so all three id layouts coincide."""
        map_bytes = (float(self.id_map.nbytes) if self.id_map is not None
                     else 0.0)
        return {
            "n": self.n,
            "ids_bytes": map_bytes,
            "ids_bytes_unc64": map_bytes,
            "ids_bytes_compact": map_bytes,
            "payload_bytes": float(self.vecs.nbytes),
            "payload_bytes_unc": float(self.vecs.nbytes),
            "centroid_bytes": 0.0,
            "decoded_cache_bytes": 0.0,
            "total_bytes": float(self.vecs.nbytes) + map_bytes,
        }


class IVFApiIndex:
    """Protocol adapter over the batched compressed-IVF index."""

    def __init__(self, spec: IndexSpec, device="cuda"):
        self.index_spec = spec
        pq = (ProductQuantizer(m=spec.pq_m, bits=spec.pq_bits)
              if spec.pq_m else None)
        self.ivf = IVFIndex(nlist=spec.nlist, id_codec=spec.ids, pq=pq,
                            code_codec=spec.codes, device=device,
                            **_ingest_fields(spec))

    @classmethod
    def from_built(cls, ivf: IVFIndex,
                   spec: Optional[IndexSpec] = None) -> "IVFApiIndex":
        """Wrap a built :class:`IVFIndex` (its spec is derived unless given)."""
        self = cls.__new__(cls)
        policy = ivf.cache_policy
        self.index_spec = spec or IndexSpec(
            kind="ivf", nlist=ivf.nlist, ids=ivf.id_codec,
            pq_m=ivf.pq.m if ivf.pq else 0, codes=ivf.code_codec,
            cache_mb=(ivf.cache_bytes / (1 << 20) if ivf.cache_bytes
                      else None),
            cache_policy=None if policy in (None, "lru") else policy,
            max_epochs=ivf.max_epochs)
        self.ivf = ivf
        return self

    @property
    def spec(self) -> str:
        """Canonical factory string (``index_factory(idx.spec)`` rebuilds)."""
        return str(self.index_spec)

    @property
    def device(self):
        """The ``torch.device`` the index's payload lives and is scanned on."""
        return self.ivf.torch_device

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(spec={self.spec!r}, "
                f"n={getattr(self.ivf, 'n', None)}, device={self.device})")

    @property
    def n(self) -> int:
        """Size of the id universe."""
        return self.ivf.n

    def build(self, x: np.ndarray, seed: int = 0,
              centroids: Optional[np.ndarray] = None) -> "IVFApiIndex":
        """Train + populate the inner :class:`IVFIndex` (k-means coarse
        quantizer unless ``centroids`` is given; one sealed epoch)."""
        self.ivf.build(np.asarray(x, np.float32), seed=seed,
                       centroids=centroids)
        return self

    def add(self, x: np.ndarray) -> "IVFApiIndex":
        """Append rows as one new epoch (dense ids ``n..n+m-1``)."""
        self.ivf.add(x)
        return self

    def append_rows(self, x: np.ndarray, global_ids: np.ndarray,
                    count: Optional[int] = None) -> "IVFApiIndex":
        """Routed ingest: seal the epoch holding these (possibly partial)
        rows.  A cluster shard passes only its owned rows plus the global
        epoch ``count`` so epoch boundaries stay universe-wide; see
        :meth:`IVFIndex.append_epoch`."""
        global_ids = np.asarray(global_ids, np.int64)
        if count is None:
            count = (int(global_ids.max()) + 1 - self.ivf.n
                     if global_ids.size else 0)
        if count > 0:
            self.ivf.append_epoch(x, global_ids, count)
        return self

    def compact(self) -> "IVFApiIndex":
        """Fold all epochs back into one (recovers single-universe rates)."""
        self.ivf.compact()
        return self

    @property
    def n_epochs(self) -> int:
        """Number of sealed ingest epochs currently stored."""
        return self.ivf.n_epochs

    def search(self, queries: np.ndarray, k: int = 10, nprobe: int = 16,
               engine: Optional[str] = None, query_block: int = 64,
               with_keys: bool = False, select: str = "auto",
               select_min: Optional[int] = None):
        """Compressed-domain IVF search (faiss ``(dists, ids)`` order).

        ``engine`` (``auto``/``xla``/``pallas``) must suit the index's
        device and ``select`` places the top-k cut (``host``/``device``/
        ``auto``) — results are bit-identical, see
        :mod:`repro_torch.ann.scan`."""
        ids, dists, stats = self.ivf.search(
            np.asarray(queries, np.float32), nprobe=nprobe, topk=k,
            engine=engine or self.index_spec.engine or "auto",
            query_block=query_block, with_keys=with_keys, select=select,
            select_min=select_min)
        return dists, ids, stats

    def memory_ledger(self) -> Dict[str, float]:
        """Bytes by component: compressed ids vs the uncompressed-64 and
        ceil(log2 n) baselines, payload (PQ/Pólya or raw), centroids,
        decoded-list cache."""
        idx = self.ivf
        n = int(idx.sizes.sum())
        id_bytes = idx.id_bits() / 8.0
        if idx.codes is not None:
            payload = idx.codes.shape[1] * n * idx.code_bits_per_element() / 8.0
            payload_unc = idx.codes.nbytes
        else:
            payload = payload_unc = idx.vecs.nbytes
        cache = idx.decoded_cache.stats()
        return {
            "n": n,
            "epochs": float(idx.n_epochs),
            "ids_bytes": id_bytes,
            "ids_bytes_unc64": 8.0 * n,
            "ids_bytes_compact": float(np.ceil(np.log2(max(2, idx.n)))) * n / 8.0,
            "payload_bytes": payload,
            "payload_bytes_unc": payload_unc,
            "centroid_bytes": idx.centroids.nbytes,
            "decoded_cache_bytes": cache["bytes"],
            "total_bytes": id_bytes + payload + idx.centroids.nbytes
            + cache["bytes"],
        }


class GraphApiIndex:
    """Protocol adapter over the NSG/HNSW graph index."""

    def __init__(self, spec: IndexSpec, device="cuda"):
        self.index_spec = spec
        self.graph = GraphIndex(id_codec=spec.ids, device=device,
                                **_ingest_fields(spec))
        self.build_s: Dict[str, float] = {}

    @classmethod
    def from_built(cls, graph: GraphIndex,
                   spec: Optional[IndexSpec] = None) -> "GraphApiIndex":
        """Wrap a built :class:`GraphIndex`; a raw graph does not know its
        builder, so the spec defaults to NSG with the observed degree cap
        (callers with the truth pass ``spec``)."""
        self = cls.__new__(cls)
        self.index_spec = spec or IndexSpec(
            kind="nsg", degree=max((len(a) for a in graph.adj_raw), default=1),
            ids=graph.id_codec)
        self.graph = graph
        self.build_s = {}
        return self

    @property
    def spec(self) -> str:
        """Canonical factory string (``index_factory(idx.spec)`` rebuilds)."""
        return str(self.index_spec)

    @property
    def device(self):
        """The ``torch.device`` the base lives and is scored on."""
        return self.graph.torch_device

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(spec={self.spec!r}, "
                f"n={getattr(self.graph, 'n', None)}, device={self.device})")

    @property
    def n(self) -> int:
        """Size of the id universe (global row count, not rows held)."""
        return self.graph.n

    def build(self, x: np.ndarray, seed: int = 0,
              adj: Optional[List[np.ndarray]] = None) -> "GraphApiIndex":
        """Build the NSG/HNSW adjacency for ``x`` on the index's device (or
        take ``adj`` as given) and code each friend list with the spec's id
        codec.  ``build_s`` holds the seconds of the kNN graph
        (``knn_s``), the prune (``prune_s``) and the coding (``encode_s``,
        with the medoid and the base's upload)."""
        x = np.asarray(x, np.float32)
        self.build_s = {}
        if adj is None:
            builder = build_nsg if self.index_spec.kind == "nsg" else build_hnsw
            adj = builder(x, self.index_spec.degree, seed=seed,
                          device=self.device, timings=self.build_s)
        t = time.perf_counter()
        self.graph.build(x, adj)
        self.build_s["encode_s"] = time.perf_counter() - t
        return self

    def add(self, x: np.ndarray) -> "GraphApiIndex":
        """Append rows as a new epoch, wiring them into the graph with
        degree-capped greedy edges (dense ids ``n..n+m-1``)."""
        if self.graph.id_map is not None:
            raise ValueError("cannot add() to a planner-made graph shard: "
                             "its global-id mapping is fixed by the plan; "
                             "route ingest through append_rows()")
        self.graph.add(x, r=self.index_spec.degree)
        return self

    def append_rows(self, x: np.ndarray,
                    global_ids: np.ndarray) -> "GraphApiIndex":
        """Routed ingest for a planner-made shard: insert the rows this
        shard owns and extend ``id_map``.  New global ids exceed every
        existing one, so the map stays ascending and the sharded-merge
        tie order stays aligned with the monolithic one."""
        x = np.asarray(x, np.float32).reshape(-1, self.graph.x.shape[1])
        global_ids = np.asarray(global_ids, np.int64)
        if x.shape[0] != global_ids.shape[0]:
            raise ValueError("one global id per appended row")
        if x.shape[0] == 0:
            return self
        id_map = self.graph.id_map
        if id_map is None:
            if np.any(global_ids != self.graph.n
                      + np.arange(global_ids.size)):
                raise ValueError("unsharded graph ingest must be dense "
                                 "(ids n..n+m-1); use add()")
            self.graph.add(x, r=self.index_spec.degree)
            return self
        if global_ids.size and int(global_ids[0]) <= int(id_map[-1]):
            raise ValueError("appended global ids must exceed existing ones")
        self.graph.add(x, r=self.index_spec.degree)
        self.graph.id_map = np.concatenate([id_map, global_ids])
        return self

    def compact(self) -> "GraphApiIndex":
        """Fold all epochs back into one (recovers single-universe rates)."""
        self.graph.compact()
        return self

    @property
    def n_epochs(self) -> int:
        """Number of distinct encoding universes currently stored."""
        return self.graph.n_epochs

    def search(self, queries: np.ndarray, k: int = 10,
               ef: Optional[int] = None, engine: Optional[str] = None,
               query_block: int = 64, select: str = "auto",
               kernel_min: Optional[int] = None):
        """Beam (best-first) graph search with compressed adjacency.

        ``ef`` is the beam width (default ``max(16, 2k)``); ``engine``
        (``auto``/``xla``/``pallas``) must suit the index's device,
        ``select`` places the per-step candidate-distance gather and
        ``kernel_min`` gates the tiles that take the kernel — results are
        bit-identical either way, see :mod:`repro_torch.ann.graph_scan`."""
        ids, dists, stats = self.graph.search(
            np.asarray(queries, np.float32),
            ef=ef if ef is not None else max(16, 2 * k), topk=k,
            engine=engine or self.index_spec.engine or "auto",
            query_block=query_block, kernel_min=kernel_min, select=select)
        if self.graph.id_map is not None:
            # shard planner remap (local node -> global id); padding slots
            # (dist inf) must stay id 0, matching the monolithic convention
            ids = np.where(np.isfinite(dists), self.graph.id_map[ids], 0)
        return dists, ids, stats

    def memory_ledger(self) -> Dict[str, float]:
        """Bytes by component: compressed adjacency ids vs uncompressed-64
        and ceil(log2 n) baselines, raw vectors, decoded-list cache."""
        g = self.graph
        edges = sum(len(a) for a in g.adj_raw)
        id_bytes = g.id_bits() / 8.0
        map_bytes = float(g.id_map.nbytes) if g.id_map is not None else 0.0
        cache = g.decoded_cache.stats()
        return {
            "n": g.n,
            "epochs": float(g.n_epochs),
            "edges": edges,
            "ids_bytes": id_bytes + map_bytes,
            "ids_bytes_unc64": 8.0 * edges + map_bytes,
            "ids_bytes_compact": float(np.ceil(np.log2(max(2, g.n)))) * edges / 8.0
            + map_bytes,
            "payload_bytes": float(g.x.nbytes),
            "payload_bytes_unc": float(g.x.nbytes),
            "centroid_bytes": 0.0,
            "decoded_cache_bytes": cache["bytes"],
            "total_bytes": id_bytes + map_bytes + g.x.nbytes + cache["bytes"],
        }


def as_api_index(index):
    """Upgrade a raw :class:`IVFIndex` / :class:`GraphIndex` to the
    protocol (identity otherwise)."""
    if isinstance(index, (FlatIndex, IVFApiIndex, GraphApiIndex)):
        return index
    if isinstance(index, IVFIndex):
        return IVFApiIndex.from_built(index)
    if isinstance(index, GraphIndex):
        return GraphApiIndex.from_built(index)
    if isinstance(index, Index):
        return index  # already protocol-shaped
    raise TypeError(f"cannot adapt {type(index).__name__} to "
                    "repro_torch.api.Index")


def make_index(spec, device="cuda"
               ) -> "FlatIndex | IVFApiIndex | GraphApiIndex":
    """Spec (string or IndexSpec) -> empty index of the right class on
    ``device``."""
    spec = parse_spec(spec)
    if spec.kind == "flat":
        return FlatIndex(spec, device=device)
    if spec.kind == "ivf":
        return IVFApiIndex(spec, device=device)
    return GraphApiIndex(spec, device=device)
