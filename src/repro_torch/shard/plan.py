"""Shard planner: split one built index into N servable shard artifacts.

The port of ``repro.shard.plan``.  The paper's compression argument is a
per-machine capacity argument — compressed ids mean more of the database
fits in one process.  Past one machine the database must be partitioned,
and the ``repro_torch.api`` seam makes the shard unit trivial: each shard
is itself a factory-spec index, serialized as a standalone RIDX blob,
described by one JSON manifest (``ridx-shards`` v1, the reference's
format: either package loads the other's plans).

Partitioning schemes (all deterministic, as in the reference):

* **IVF — cluster granularity** (``by="range"`` contiguous cluster
  ranges, ``by="hash"`` splitmix-hashed cluster ids).  Every shard keeps
  the **full coarse quantizer** (all ``nlist`` centroids) but owns only
  its clusters' lists/vectors; unowned clusters are empty.  Because the
  scan skips empty clusters, each shard probes the *globally* nearest
  ``nprobe`` centroids and scores exactly the owned subset of the
  monolithic candidate set — so the router's ``(dist, key)`` merge is
  bit-identical to the unsharded search (:mod:`repro_torch.shard.service`).
  Shards keep the global id universe ``n``: their streams decode straight
  to database ids, no remap.
* **Flat / NSG / HNSW — vector-id hash** (``by="hash"``).  Each shard
  holds a row subset in ascending global-id order plus an explicit
  ``id_map`` (serialized in the RIDX blob).  Graph shards rebuild their
  spec's graph over the subset on the source's device; sharded graph
  search equals monolithic search whenever both are exhaustive (``ef >=
  n``, every node reachable from the entry) and otherwise trades recall
  for capacity like any partitioned HNSW deployment.

``assignments=`` overrides the scheme with an explicit owner array
(clusters for IVF, ids otherwise) — how tests build pathologically
uneven shards.

Shards made by :func:`plan_shards` live on the source index's device (a
shard's payload is uploaded there when it is made); :meth:`ShardPlan.load`
puts a saved plan on ``device`` (default ``"cuda"``, which raises without
a card).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from ..ann.graph import GraphIndex, build_hnsw, build_nsg
from ..ann.ivf import IVFIndex
from ..ann.scan import _spans_concat
from ..api.container import load_index, save_index
from ..api.indexes import (FlatIndex, GraphApiIndex, IVFApiIndex,
                           _ingest_fields, as_api_index)
from ..api.spec import parse_spec
from ..core.polya import PolyaCodec

__all__ = ["ShardInfo", "ShardPlan", "plan_shards", "MANIFEST_NAME"]

MANIFEST_NAME = "shards.json"
MANIFEST_FORMAT = "ridx-shards"
MANIFEST_VERSION = 1


def _hash_owner(keys: np.ndarray, nshards: int) -> np.ndarray:
    """splitmix64 finalizer -> shard owner per key (deterministic)."""
    x = np.asarray(keys, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(nshards)).astype(np.int64)


@dataclasses.dataclass
class ShardInfo:
    """One row of the shard manifest."""

    shard_id: int
    spec: str                        # canonical factory spec of the shard
    n_local: int                     # vectors held by this shard
    clusters: Optional[list] = None  # IVF: [lo, hi) range or explicit list
    id_range: Optional[list] = None  # [min, max] global ids held
    ledger: dict = dataclasses.field(default_factory=dict)
    path: Optional[str] = None       # RIDX artifact, relative to the manifest

    def to_json(self) -> dict:
        """The manifest row as a JSON-ready dict."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShardInfo":
        """A manifest row back from its dict."""
        return cls(**d)


@dataclasses.dataclass
class ShardPlan:
    """A partitioning of one index: manifest rows + the live shard indexes."""

    kind: str                        # "ivf" | "flat" | "nsg" | "hnsw"
    by: str                          # "range" | "hash" | "custom"
    nshards: int
    source_spec: str
    n: int                           # global id universe
    shards: List[ShardInfo]
    indexes: List[object]            # repro_torch.api indexes, by shard

    def manifest(self) -> dict:
        """The JSON manifest (``ridx-shards`` v1) as a dict."""
        return {
            "format": MANIFEST_FORMAT,
            "version": MANIFEST_VERSION,
            "kind": self.kind,
            "by": self.by,
            "nshards": self.nshards,
            "source_spec": self.source_spec,
            "n": self.n,
            "shards": [s.to_json() for s in self.shards],
        }

    def cluster_owner(self) -> np.ndarray:
        """IVF plans: owner shard id per cluster (``(nlist,)`` int64).

        The routing table for online ingest — a new vector goes to the
        shard owning its nearest centroid's cluster."""
        if self.kind != "ivf":
            raise ValueError("cluster_owner() applies to IVF plans only")
        nlist = parse_spec(self.source_spec).nlist
        owner = np.full(nlist, -1, np.int64)
        for info in self.shards:
            c = info.clusters
            if c is None:
                continue
            if self.by == "range":
                owner[int(c[0]):int(c[1])] = info.shard_id
            else:
                owner[np.asarray(c, np.int64)] = info.shard_id
        return owner

    def id_owner(self, ids: np.ndarray) -> np.ndarray:
        """Flat/graph hash plans: owner shard per (new) global id."""
        if self.kind == "ivf":
            raise ValueError("IVF ingest routes by cluster_owner()")
        if self.by != "hash":
            raise ValueError(
                f"by={self.by!r} plans have no rule for unseen ids")
        return _hash_owner(np.asarray(ids, np.int64), self.nshards)

    def save(self, out_dir) -> Path:
        """Write per-shard RIDX artifacts + ``shards.json``; returns
        the manifest path."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        for info, idx in zip(self.shards, self.indexes):
            info.path = f"shard_{info.shard_id:03d}.ridx"
            save_index(idx, out / info.path)
        mpath = out / MANIFEST_NAME
        mpath.write_text(json.dumps(self.manifest(), indent=1))
        return mpath

    @classmethod
    def load(cls, src, device="cuda") -> "ShardPlan":
        """Load a saved plan from a manifest path or its directory, every
        shard onto ``device`` (default ``"cuda"``, which raises when no
        CUDA device is present; pass ``device="cpu"`` for the plain
        torch path)."""
        p = Path(src)
        if p.is_dir():
            p = p / MANIFEST_NAME
        m = json.loads(p.read_text())
        if m.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"{p} is not a {MANIFEST_FORMAT} manifest")
        if m.get("version") != MANIFEST_VERSION:
            raise ValueError(f"unsupported shard-manifest version "
                             f"{m.get('version')}")
        shards = [ShardInfo.from_json(d) for d in m["shards"]]
        indexes = [load_index(p.parent / s.path, device=device)
                   for s in shards]
        return cls(kind=m["kind"], by=m["by"], nshards=m["nshards"],
                   source_spec=m["source_spec"], n=m["n"],
                   shards=shards, indexes=indexes)


# ---------------------------------------------------------------------------
# splitters
# ---------------------------------------------------------------------------

def _split_ivf(src: IVFIndex, owner: np.ndarray,
               nshards: int) -> List[IVFIndex]:
    """Cluster-granular split; every shard keeps the full quantizer, the
    global id universe AND the global epoch boundaries (see module doc
    and :mod:`repro_torch.core.epoch` for why that buys bit-parity).
    Each shard's payload and centroids are uploaded to the source's
    device."""
    out = []
    starts = src.offsets[:-1]
    for s in range(nshards):
        mask = owner == s
        sh = IVFIndex(nlist=src.nlist, id_codec=src.id_codec, pq=src.pq,
                      code_codec=src.code_codec, cache_bytes=src.cache_bytes,
                      cache_policy=src.cache_policy,
                      max_epochs=src.max_epochs, device=src.torch_device)
        sh.n, sh.d = src.n, src.d
        sh.centroids = src.centroids          # shared coarse quantizer
        sh.cluster_of = src.cluster_of
        sh.sizes = np.where(mask, src.sizes, 0)
        sh.offsets = np.concatenate([[0], np.cumsum(sh.sizes)]).astype(np.int64)
        sh._lists = [src._lists[k] if mask[k] else np.zeros(0, np.int64)
                     for k in range(src.nlist)]
        rows = _spans_concat(starts[mask].astype(np.int64),
                             src.sizes[mask].astype(np.int64))
        if src.codes is not None:
            sh.codes, sh.vecs = src.codes[rows], None
        else:
            sh.codes, sh.vecs = None, src.vecs[rows]
        # owned epoch blobs are the monolithic ones verbatim (same relative
        # list, same universe -> same bytes); unowned clusters empty
        sh._ids = src._ids.split(mask, src._lists)
        if getattr(src, "_code_blobs", None) is not None:
            # per-epoch polya over the owned rows (cluster rows are stored
            # epoch-ascending, so each epoch is a contiguous sub-span)
            cum = sh._ids._cum
            sh._polya = PolyaCodec()
            sh._code_blobs = [
                sh._polya.encode(
                    [sh.codes[sh.offsets[k] + cum[e, k]:
                              sh.offsets[k] + cum[e + 1, k]]
                     for k in range(sh.nlist)])
                for e in range(sh._ids.n_epochs)]
        else:
            sh._code_blobs = None
        sh._decoded_cache = sh._new_cache()
        sh._to_device()                       # payload_dev, centroids_dev
        out.append(sh)
    return out


def _split_flat(src: FlatIndex, owner: np.ndarray,
                nshards: int) -> List[FlatIndex]:
    src_map = getattr(src, "id_map", None)
    out = []
    for s in range(nshards):
        ids = np.flatnonzero(owner == s).astype(np.int64)  # ascending
        sh = FlatIndex(src.index_spec, device=src.device).build(src.vecs[ids])
        sh.id_map = ids if src_map is None else src_map[ids]
        out.append(sh)
    return out


def _split_graph(src: GraphApiIndex, owner: np.ndarray, nshards: int,
                 seed: int) -> List[GraphApiIndex]:
    spec = src.index_spec
    g = src.graph
    dev = g.torch_device
    builder = build_nsg if spec.kind == "nsg" else build_hnsw
    out = []
    for s in range(nshards):
        ids = np.flatnonzero(owner == s).astype(np.int64)
        if ids.size == 0:
            raise ValueError(
                f"graph shard {s} would be empty ({nshards} shards over "
                f"{g.n} vectors); use fewer shards or pass assignments=")
        if ids.size == g.n:
            sub = g                            # whole index: serve as-is
        else:
            xs = g.x[ids]
            if ids.size < 2:
                adj = [np.zeros(0, np.int64) for _ in range(ids.size)]
            else:
                adj = builder(xs, spec.degree, seed=seed, device=dev)
            sub = GraphIndex(id_codec=spec.ids, device=dev,
                             **_ingest_fields(spec)).build(xs, adj)
            sub.id_map = ids
        out.append(GraphApiIndex.from_built(sub, spec))
    return out


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def plan_shards(index, nshards: int, by: Optional[str] = None,
                boundaries: Optional[Sequence[int]] = None,
                assignments: Optional[np.ndarray] = None,
                seed: int = 0) -> ShardPlan:
    """Split a built index into ``nshards`` servable shards.

    ``by``: ``"range"`` (IVF default — contiguous cluster ranges, optionally
    at explicit ``boundaries``, a sorted ``nshards+1`` edge list) or
    ``"hash"`` (IVF clusters / Flat-graph vector ids, splitmix64).
    ``assignments`` overrides both: an owner array over clusters (IVF) or
    ids (Flat/graph) with values in ``[0, nshards)``.

    Returns a :class:`ShardPlan` holding live api indexes (on the source
    index's device) plus the manifest rows; ``plan.save(dir)`` persists
    RIDX artifacts + JSON.
    """
    if nshards <= 0:
        raise ValueError("nshards must be positive")
    index = as_api_index(index)
    spec = parse_spec(index.spec)
    kind = spec.kind

    if kind == "ivf":
        ivf = index.ivf
        nunits, unit = ivf.nlist, "cluster"
    else:
        nunits, unit = index.n, "id"

    if assignments is not None:
        owner = np.asarray(assignments, np.int64)
        if owner.shape != (nunits,):
            raise ValueError(f"assignments must map each {unit} "
                             f"(shape ({nunits},), got {owner.shape})")
        if owner.size and (owner.min() < 0 or owner.max() >= nshards):
            raise ValueError("assignments out of range for nshards")
        by = "custom"
    elif kind == "ivf":
        by = by or "range"
        if by == "range":
            edges = (np.asarray(boundaries, np.int64) if boundaries is not None
                     else np.linspace(0, nunits, nshards + 1).astype(np.int64))
            if (edges.shape != (nshards + 1,) or edges[0] != 0
                    or edges[-1] != nunits or np.any(np.diff(edges) < 0)):
                raise ValueError(
                    f"boundaries must be a sorted edge list 0..{nunits} "
                    f"of length {nshards + 1}")
            owner = np.repeat(np.arange(nshards, dtype=np.int64),
                              np.diff(edges))
        elif by == "hash":
            if boundaries is not None:
                raise ValueError("boundaries only apply to by='range'")
            owner = _hash_owner(np.arange(nunits), nshards)
        else:
            raise ValueError(f"unknown IVF partition scheme {by!r} "
                             "(options: range, hash)")
    else:
        by = by or "hash"
        if by != "hash":
            raise ValueError(f"{kind} indexes shard by vector-id hash only "
                             f"(got by={by!r})")
        owner = _hash_owner(np.arange(nunits), nshards)

    # -- build per-shard indexes -------------------------------------------
    if kind == "ivf":
        parts = _split_ivf(index.ivf, owner, nshards)
        shard_indexes = [IVFApiIndex.from_built(p, spec) for p in parts]
    elif kind == "flat":
        shard_indexes = _split_flat(index, owner, nshards)
    else:
        shard_indexes = _split_graph(index, owner, nshards, seed)

    # -- manifest rows ------------------------------------------------------
    infos = []
    for s, sh in enumerate(shard_indexes):
        if kind == "ivf":
            held = np.flatnonzero(owner == s)
            lists = [sh.ivf._lists[int(k)] for k in held
                     if len(sh.ivf._lists[int(k)])]
            all_ids = np.concatenate(lists) if lists else np.zeros(0, np.int64)
            n_local = int(sh.ivf.sizes.sum())
            if by == "range":
                lo = int(held[0]) if held.size else 0
                hi = int(held[-1]) + 1 if held.size else 0
                clusters = [lo, hi]
            else:
                clusters = [int(k) for k in held]
        else:
            all_ids = (getattr(sh, "id_map", None)
                       if kind == "flat"
                       else getattr(sh.graph, "id_map", None))
            if all_ids is None:          # whole-index graph shard
                all_ids = np.arange(index.n, dtype=np.int64)
            n_local = int(all_ids.size)
            clusters = None
        infos.append(ShardInfo(
            shard_id=s,
            spec=str(spec),
            n_local=n_local,
            clusters=clusters,
            id_range=([int(all_ids.min()), int(all_ids.max())]
                      if all_ids.size else None),
            ledger={k: float(v) for k, v in sh.memory_ledger().items()},
        ))

    return ShardPlan(kind=kind, by=by, nshards=nshards,
                     source_spec=str(spec), n=int(index.n),
                     shards=infos, indexes=shard_indexes)
