"""Concrete :class:`repro_torch.api.Index` implementations.

:class:`IVFApiIndex` wraps :class:`repro_torch.ann.ivf.IVFIndex` (all id
codecs + wavelet tree, optional PQ / Pólya codes) behind the one
protocol: faiss ``(dists, ids)`` order, uniform :class:`SearchStats`,
uniform memory ledger.  Flat, NSG and HNSW specs parse (the grammar is
shared with the reference) but their indexes are not ported yet: building
one raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..ann.ivf import IVFIndex
from ..ann.pq import ProductQuantizer
from .protocol import Index
from .spec import IndexSpec, parse_spec

__all__ = ["IVFApiIndex", "as_api_index", "make_index"]

_NOT_PORTED = {
    "flat": "Flat search (ROADMAP.md, queue 1: 'Flat index and "
            "batched_flat_search')",
    "nsg": "graph indexes (ROADMAP.md, queue 1: 'Graph indexes')",
    "hnsw": "graph indexes (ROADMAP.md, queue 1: 'Graph indexes')",
}


def _cache_bytes(spec: IndexSpec) -> Optional[int]:
    if spec.cache_mb is None:
        return None
    return int(spec.cache_mb * (1 << 20))


def _ingest_fields(spec: IndexSpec) -> dict:
    """Constructor kwargs of the inner index that the spec carries."""
    return dict(cache_bytes=_cache_bytes(spec),
                cache_policy=spec.cache_policy or "lru",
                max_epochs=spec.max_epochs)


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


def as_api_index(index):
    """Upgrade a raw :class:`IVFIndex` to the protocol (identity otherwise)."""
    if isinstance(index, IVFApiIndex):
        return index
    if isinstance(index, IVFIndex):
        return IVFApiIndex.from_built(index)
    if isinstance(index, Index):
        return index  # already protocol-shaped
    raise TypeError(f"cannot adapt {type(index).__name__} to "
                    "repro_torch.api.Index")


def make_index(spec, device="cuda") -> IVFApiIndex:
    """Spec (string or IndexSpec) -> empty index on ``device``."""
    spec = parse_spec(spec)
    if spec.kind != "ivf":
        raise NotImplementedError(
            f"{spec} is not ported to repro_torch yet: "
            f"{_NOT_PORTED[spec.kind]}")
    return IVFApiIndex(spec, device=device)
