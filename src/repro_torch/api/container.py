"""RIDX v3 — the reference's one versioned container, for the port's indexes.

The port of ``repro.api.container``: the same manifest-of-sections bytes
(``RIDX`` magic, version 3, the index's canonical factory spec in the
manifest), so a blob that either package writes loads into the other,
and ``load_index(save_index(idx))`` returns an index whose search
results are **bit-identical** to the original:

* centroids / vectors / PQ codebooks are stored as exact f32;
* IVF id lists ride in joint exact-ANS ROC streams, one per epoch, with
  the epoch table (``[base, count]`` rows) in the manifest and per-epoch
  ``ids{e}`` / ``esizes`` sections, so an index mid-ingest round-trips
  with its epoch structure and its exact ``id_bits()``.  The port packs
  and unpacks each stream by halving
  (:func:`repro_torch.core.container.pack_joint_ids`), the same bytes as
  the reference's one-op-at-a-time coder without its cost quadratic in
  the ids;
* PQ codes go through the Pólya coder when the index carries one, one
  blob per epoch (``code{e}_*`` sections);
* graph edge lists go through the offline path — webgraph-lite by
  default, Random Edge Coding (``graph_codec="rec"``, static degree
  model + shipped degree table) on request; per-node encoding universes
  (the graph ingest analogue of epochs) ride as an RLE section;
* per-list online blobs (ROC/EF/...) and the wavelet tree are *not*
  stored: they are deterministic functions of (lists, universe) and are
  re-encoded per epoch (per node's universe, for a graph) on load.

v2 containers (single implicit epoch, all graph universes = n) still
load; new blobs are always written as v3.  A blob carries no device, so
:func:`unpack_index` and :func:`load_index` take ``device=`` (default
``"cuda"``, raising without a card): the loaded index's payload (a
graph's base) is uploaded there.
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

import numpy as np

from ..ann.graph import GraphIndex
from ..ann.ivf import IVFIndex
from ..ann.pq import ProductQuantizer
from ..core.ans import StreamANS
from ..core.container import (SectionReader, SectionWriter,
                              pack_joint_ids, pack_polya_sections,
                              unpack_joint_ids, unpack_polya_sections)
from ..core.epoch import EpochStore
from ..core.polya import PolyaCodec
from ..core.rec import RECResult, _degree_table, rec_decode, rec_encode
from ..core.webgraph_lite import webgraph_decode, webgraph_encode
from .indexes import (FlatIndex, GraphApiIndex, IVFApiIndex,
                      _ingest_fields, as_api_index)
from .spec import IndexSpec, parse_spec

__all__ = ["pack_index", "unpack_index", "save_index", "load_index",
           "RIDX_MAGIC", "RIDX_VERSION"]

RIDX_MAGIC = b"RIDX"
RIDX_VERSION = 3


# ---------------------------------------------------------------------------
# pack
# ---------------------------------------------------------------------------

def pack_index(index, graph_codec: str = "webgraph") -> bytes:
    """Serialize a factory-built (or raw IVF / graph) index to one blob —
    the bytes the reference's ``pack_index`` writes for the same index.
    ``graph_codec`` (``webgraph`` or ``rec``) codes a graph's edges."""
    index = as_api_index(index)
    spec = parse_spec(index.spec)
    meta = {"spec": str(spec), "kind": spec.kind}
    w = SectionWriter()
    if isinstance(index, FlatIndex):
        meta.update(n=int(index.n), d=int(index.d))
        w.add("vecs", index.vecs.astype(np.float32).tobytes())
        if index.id_map is not None:
            meta["id_map"] = True
            w.add("id_map", np.asarray(index.id_map, np.int64).tobytes())
    elif isinstance(index, IVFApiIndex):
        _pack_ivf_sections(w, meta, index.ivf)
    elif isinstance(index, GraphApiIndex):
        _pack_graph_sections(w, meta, index.graph, graph_codec)
    else:  # pragma: no cover - as_api_index guarantees one of the above
        raise TypeError(f"cannot pack {type(index).__name__}")
    return w.finish(RIDX_MAGIC, RIDX_VERSION, meta)


def _pack_ivf_sections(w: SectionWriter, meta: dict, ivf: IVFIndex) -> None:
    meta.update(n=int(ivf.n), d=int(ivf.d), nlist=int(ivf.nlist))
    w.add("sizes", ivf.sizes.astype(np.int64).tobytes())
    w.add("centroids", ivf.centroids.astype(np.float32).tobytes())
    # epoch table + one joint ROC stream per epoch (relative ids, epoch
    # universe) — lossless for an index mid-ingest
    store: EpochStore = ivf._ids
    meta["epochs"] = [[int(ep.base), int(ep.count)] for ep in store.epochs]
    w.add("esizes", np.stack(
        [ep.sizes for ep in store.epochs]).astype(np.int64).tobytes())
    for e, ep in enumerate(store.epochs):
        rel = store.rel_lists(e, ivf._lists)
        w.add(f"ids{e}", pack_joint_ids(rel, ep.count))
    meta["pq"] = ({"m": int(ivf.pq.m), "bits": int(ivf.pq.bits)}
                  if ivf.pq is not None else None)
    if ivf.pq is not None:
        w.add("pq_codebooks", ivf.pq.codebooks.astype(np.float32).tobytes())
    if ivf._code_blobs is not None:
        meta["code"] = {
            "m": int(ivf._code_blobs[0]["m"]),
            "epochs": [pack_polya_sections(w, blob, prefix=f"code{e}")
                       for e, blob in enumerate(ivf._code_blobs)],
        }
    elif ivf.codes is not None:
        w.add("codes_raw", ivf.codes.tobytes())
        meta["code"] = {"m": int(ivf.codes.shape[1]), "raw": True}
    else:
        meta["code"] = None
        w.add("vecs", ivf.vecs.astype(np.float32).tobytes())


def _rle(a: np.ndarray):
    """(values, run_lengths) run-length encoding of a 1-d array."""
    a = np.asarray(a, np.int64)
    if a.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    starts = np.concatenate([[0], np.flatnonzero(np.diff(a)) + 1])
    lens = np.diff(np.concatenate([starts, [a.size]]))
    return a[starts], lens.astype(np.int64)


def _pack_graph_sections(w: SectionWriter, meta: dict, g: GraphIndex,
                         graph_codec: str) -> None:
    meta.update(n=int(g.n), d=int(g.x.shape[1]), entry=int(g.entry),
                graph_codec=graph_codec)
    w.add("vecs", g.x.astype(np.float32).tobytes())
    if g.id_map is not None:
        meta["id_map"] = True
        w.add("id_map", np.asarray(g.id_map, np.int64).tobytes())
    # per-node encoding universes, RLE (one run per ingest generation): the
    # loader re-encodes each blob at its own universe, so id_bits
    # round-trips mid-ingest
    vals, lens = _rle(g._universes)
    meta["universe_runs"] = int(vals.size)
    w.add("universes", np.concatenate([vals, lens]).tobytes())
    if graph_codec == "webgraph":
        head, tail = webgraph_encode(g.adj_raw, g.n).tobytes()
        w.add("graph_head", head)
        w.add("graph_tail", tail)
    elif graph_codec == "rec":
        edges = _edge_list(g.adj_raw)
        meta["n_edges"] = int(edges.shape[0])
        res = rec_encode(edges, g.n, model="degree")
        head, tail = res.state.tobytes()
        w.add("graph_head", head)
        w.add("graph_tail", tail)
        degrees = np.bincount(edges.reshape(-1), minlength=g.n)
        w.add("degrees", degrees.astype(np.int64).tobytes())
    else:
        raise ValueError(f"unknown graph_codec {graph_codec!r} "
                         "(options: webgraph, rec)")


def _edge_list(adj: List[np.ndarray]) -> np.ndarray:
    """Per-node adjacency -> (E, 2) int64 ``(src, dst)`` rows, node order."""
    src = np.concatenate([np.full(len(a), i, np.int64)
                          for i, a in enumerate(adj)] or
                         [np.zeros(0, np.int64)])
    dst = (np.concatenate(adj) if any(len(a) for a in adj)
           else np.zeros(0, np.int64))
    return np.stack([src.astype(np.int64), dst.astype(np.int64)], axis=1)


def _group_edges(edges: np.ndarray, n: int) -> List[np.ndarray]:
    """Lexicographically sorted (src, dst) rows -> per-node sorted adjacency."""
    counts = np.bincount(edges[:, 0], minlength=n) if edges.size else \
        np.zeros(n, np.int64)
    bounds = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return [edges[bounds[i]:bounds[i + 1], 1].astype(np.int64)
            for i in range(n)]


# ---------------------------------------------------------------------------
# unpack
# ---------------------------------------------------------------------------

def unpack_index(raw: bytes, device="cuda"):
    """Inverse of :func:`pack_index`: a ready-to-search api index on
    ``device``; reads v2 and v3 blobs of either package."""
    r = SectionReader(raw, RIDX_MAGIC)
    if r.version not in (2, RIDX_VERSION):
        raise ValueError(f"unsupported RIDX version {r.version}")
    m = r.manifest
    spec = parse_spec(m["spec"])
    if spec.kind == "flat":
        idx = FlatIndex(spec, device=device)
        idx.build(_f32(r.section("vecs"), (m["n"], m["d"])))
        if m.get("id_map"):
            idx.id_map = np.frombuffer(r.section("id_map"), np.int64).copy()
        return idx
    if spec.kind == "ivf":
        return IVFApiIndex.from_built(_unpack_ivf(r, spec, device), spec)
    return GraphApiIndex.from_built(_unpack_graph(r, spec, device), spec)


def _f32(raw: bytes, shape) -> np.ndarray:
    return np.frombuffer(raw, np.float32).reshape(shape).copy()


def _unpack_ivf(r: SectionReader, spec: IndexSpec, device) -> IVFIndex:
    m = r.manifest
    n, d, nlist = m["n"], m["d"], m["nlist"]
    pq = None
    if m["pq"]:
        pq = ProductQuantizer(m=m["pq"]["m"], bits=m["pq"]["bits"])
        pq.codebooks = _f32(r.section("pq_codebooks"),
                            (pq.m, pq.ksub, d // pq.m))
    sizes = np.frombuffer(r.section("sizes"), np.int64).copy()
    # id lists + epoch structure; online blobs / the wavelet tree are
    # deterministic re-encodes from the decoded lists (per epoch), so
    # size_bits bookkeeping matches the pre-save index exactly
    ids = EpochStore(nlist, spec.ids)
    if r.version == 2:                     # v2: one implicit epoch [0, n)
        epochs = [[0, n]]
        esizes = sizes[None, :]
        rel_of = {0: unpack_joint_ids(r.section("ids"), sizes, n)}
    else:
        epochs = m["epochs"]
        esizes = np.frombuffer(r.section("esizes"), np.int64).reshape(
            len(epochs), nlist)
        rel_of = {
            e: unpack_joint_ids(r.section(f"ids{e}"), esizes[e],
                                     int(count))
            for e, (_, count) in enumerate(epochs)
        }
    per_epoch_abs = []
    for e, (base, count) in enumerate(epochs):
        ids.append(rel_of[e], int(base), int(count))
        per_epoch_abs.append([lst + int(base) for lst in rel_of[e]])
    lists = [
        np.concatenate([per_epoch_abs[e][k] for e in range(len(epochs))])
        for k in range(nlist)
    ]
    # assignment string (id -> cluster); also the storage permutation source
    cluster_of = np.zeros(n, np.int64)
    if n and int(sizes.sum()):
        cluster_of[np.concatenate(lists)] = np.repeat(
            np.arange(nlist, dtype=np.int64), sizes)
    state = dict(n=n, d=d, centroids=_f32(r.section("centroids"), (nlist, d)),
                 sizes=sizes, cluster_of=cluster_of, lists=lists, ids=ids)
    # payload (cluster-grouped storage order)
    cm = m["code"]
    if cm is None:
        # shards store fewer rows than the global universe n
        state["vecs"] = _f32(r.section("vecs"), (int(sizes.sum()), d))
    elif cm.get("raw"):
        state["codes"] = np.frombuffer(r.section("codes_raw"),
                                       np.uint8).reshape(-1, cm["m"]).copy()
    else:
        if r.version == 2:
            blobs = [unpack_polya_sections(r, [int(s) for s in sizes], cm)]
        else:
            blobs = [unpack_polya_sections(r, [int(s) for s in esizes[e]],
                                           cm["epochs"][e],
                                           prefix=f"code{e}")
                     for e in range(len(epochs))]
        per_epoch_codes = [PolyaCodec().decode(blob) for blob in blobs]
        # epoch-major per-cluster chunks -> global cluster-grouped rows
        state["codes"] = np.concatenate(
            [per[k] for k in range(nlist) for per in per_epoch_codes], axis=0)
        state["code_blobs"] = blobs
    return IVFIndex.from_state(
        state, device=device, nlist=nlist, id_codec=spec.ids, pq=pq,
        code_codec=spec.codes, **_ingest_fields(spec))


def _unpack_graph(r: SectionReader, spec: IndexSpec, device) -> GraphIndex:
    m = r.manifest
    n, d = m["n"], m["d"]
    ans = StreamANS.frombytes(r.section("graph_head"), r.section("graph_tail"))
    if m["graph_codec"] == "webgraph":
        adj = [a.astype(np.int64) for a in webgraph_decode(ans, n, n)]
    else:  # rec
        degrees = np.frombuffer(r.section("degrees"), np.int64)
        res = RECResult(payload_bits=0, aux_bits=0, model="degree",
                        state=ans, aux=_degree_table(degrees))
        adj = _group_edges(rec_decode(res, n, m["n_edges"]), n)
    if r.version == 2 or "universes" not in r:
        universes = None                   # every node sealed at n
    else:
        runs = int(m["universe_runs"])
        flat = np.frombuffer(r.section("universes"), np.int64)
        universes = np.repeat(flat[:runs], flat[runs:])
    id_map = (np.frombuffer(r.section("id_map"), np.int64).copy()
              if m.get("id_map") else None)
    return GraphIndex.from_arrays(
        dict(x=_f32(r.section("vecs"), (n, d)), adj=adj, entry=m["entry"],
             universes=universes, id_map=id_map),
        id_codec=spec.ids, device=device, **_ingest_fields(spec))


# ---------------------------------------------------------------------------
# file conveniences
# ---------------------------------------------------------------------------

def save_index(index, path: Optional[Union[str, os.PathLike]] = None,
               graph_codec: str = "webgraph") -> bytes:
    """Pack ``index``; also write the blob to ``path`` when given."""
    raw = pack_index(index, graph_codec=graph_codec)
    if path is not None:
        with open(path, "wb") as f:
            f.write(raw)
    return raw


def load_index(src: Union[bytes, str, os.PathLike], device="cuda"):
    """Load an index from a blob or a file path onto ``device``."""
    if isinstance(src, (bytes, bytearray)):
        return unpack_index(bytes(src), device=device)
    with open(src, "rb") as f:
        return unpack_index(f.read(), device=device)
