"""Offline index containers: manifest-of-sections binary artifacts.

The paper's *offline* setting (§4.3) — the index is stored or transmitted
as a binary artifact and decompressed on load.  Two layers live here:

* :class:`SectionWriter` / :class:`SectionReader` — the generic
  manifest-of-sections framing every container version shares::

      magic | u32 version | u32 json_manifest_len | manifest |
      payload sections (offsets in the manifest["sections"] table)

  ``repro.api.container`` builds the RIDX-v2 any-index format on these.

* ``pack_joint_ids`` / ``unpack_joint_ids`` — every cluster's ids as one
  joint exact-ANS ROC stream.  The bytes are the reference's; the port
  computes them by halving the cluster range (the comment above
  :func:`pack_joint_ids` says how), not one op at a time.

* ``pack_ivf`` / ``unpack_ivf`` — the original v1 ``RIVF`` IVF-only blob
  (ids of all clusters share a single exact-ANS stream, PQ codes through
  the Pólya coder, centroids as f16), kept for backward compatibility and
  as the Table-4 "index" sizing unit.
"""

from __future__ import annotations

import io
import json
import math
from typing import Dict, List, Tuple

import numpy as np

from .ans import BigANS
from .polya import polya_decode_clusters
from .roc import roc_pop_set, roc_push_set

__all__ = [
    "pack_ivf", "unpack_ivf", "SectionWriter", "SectionReader",
    "pack_joint_ids", "unpack_joint_ids",
    "pack_polya_sections", "unpack_polya_sections",
]

_MAGIC = b"RIVF"
_VERSION = 1


class SectionWriter:
    """Accumulates named payload sections behind a JSON manifest.

    ``add(name, raw)`` appends bytes and records ``[offset, length]``;
    ``finish(magic, version, meta)`` frames the whole container.  The
    manifest is ``meta`` plus the ``sections`` table.
    """

    def __init__(self) -> None:
        self._payload = io.BytesIO()
        self._sections: Dict[str, list] = {}

    def add(self, name: str, raw: bytes) -> None:
        if name in self._sections:
            raise ValueError(f"duplicate section {name!r}")
        self._sections[name] = [self._payload.tell(), len(raw)]
        self._payload.write(raw)

    def finish(self, magic: bytes, version: int, meta: dict) -> bytes:
        manifest = dict(meta)
        manifest["sections"] = self._sections
        mraw = json.dumps(manifest).encode()
        out = io.BytesIO()
        out.write(magic)
        out.write(np.uint32(version).tobytes())
        out.write(np.uint32(len(mraw)).tobytes())
        out.write(mraw)
        out.write(self._payload.getvalue())
        return out.getvalue()


class SectionReader:
    """Parses a manifest-of-sections container produced by SectionWriter."""

    def __init__(self, raw: bytes, magic: bytes) -> None:
        if raw[: len(magic)] != magic:
            raise ValueError(f"not a {magic.decode(errors='replace')} container")
        p = len(magic)
        self.version = int(np.frombuffer(raw[p: p + 4], np.uint32)[0])
        mlen = int(np.frombuffer(raw[p + 4: p + 8], np.uint32)[0])
        self.manifest = json.loads(raw[p + 8: p + 8 + mlen].decode())
        self._base = p + 8 + mlen
        self._raw = raw

    def __contains__(self, name: str) -> bool:
        return name in self.manifest["sections"]

    def section(self, name: str) -> bytes:
        off, ln = self.manifest["sections"][name]
        return self._raw[self._base + off: self._base + off + ln]


# The joint id stream is computed by halving, not one op at a time.
#
# Pushing every cluster's ROC set code onto one exact-ANS state, an
# unbounded integer, one op at a time reads and writes the whole state in
# each op, so n ids cost O(n^2) digit operations.  The halving computes
# the same state, bit for bit, from a few large multiplications and
# divisions.  Pushing cluster k's set of m ids over the alphabet ``[n)``
# pops ``j = s mod i`` and pushes one id under the uniform model,
# ``s <- (s div i) * n + x``, for i = m .. 1.  Write ``s = q * m! + r``:
# every ``i`` divides ``m!``, so the ``q`` part passes through each step
# untouched but for the radix, and
#
#     F_k(s) = (s div D_k) * U_k + F_k(s mod D_k),   D_k = m!,  U_k = n^m.
#
# Maps of this form compose into the same form, so a range of clusters is
# one such map with ``D = prod m_k!`` and ``U = n^(sum m_k)``: split the
# range in halves, apply the first half to ``s`` (one divmod by its ``D``,
# one product with its ``U``, and the half's own map on the small
# remainder, recursively), then the second half to the result.  Popping is
# the mirror image, ``G_k(s) = (s div U_k) * D_k + G_k(s mod U_k)``, the
# clusters taken last to first.  A leaf (one cluster, or a run of small
# ones) runs the sequential coder on a small state.  CPython divides huge
# integers in subquadratic time, so the stream costs a few large products
# and divisions per level of the halving.

# a leaf runs the sequential coder over at most this many ids (one cluster
# is always a leaf, whatever its size); above the total id count, the whole
# stream is one leaf and the coder is the sequential one
LEAF_IDS = 512


def _halving_plan(sizes, n: int):
    """The halving tree over the clusters: ``{(a, b): (D, U)}`` for every
    node but the root (whose radices no step uses), and the leaf ranges."""
    cum = np.concatenate([[0], np.cumsum(np.asarray(sizes, np.int64))])
    radix: Dict[Tuple[int, int], Tuple[int, int]] = {}
    leaves = set()

    def build(a: int, b: int, root: bool = False) -> None:
        if b - a == 1 or int(cum[b] - cum[a]) <= LEAF_IDS:
            d = 1
            for k in range(a, b):
                d *= math.factorial(int(sizes[k]))
            radix[(a, b)] = (d, n ** int(cum[b] - cum[a]))
            leaves.add((a, b))
            return
        mid = (a + b) // 2
        build(a, mid)
        build(mid, b)
        if not root:
            (d0, u0), (d1, u1) = radix[(a, mid)], radix[(mid, b)]
            radix[(a, b)] = (d0 * d1, u0 * u1)

    if len(sizes):
        build(0, len(sizes), root=True)
    return radix, leaves


def pack_joint_ids(lists, n: int) -> bytes:
    """Ids of all clusters as one joint exact-ANS stream (clusters in order)."""
    lists = [np.asarray(ids) for ids in lists]
    radix, leaves = _halving_plan([len(ids) for ids in lists], n)

    def push(a: int, b: int, s: int) -> int:
        if (a, b) in leaves:
            ans = BigANS(s)
            for ids in lists[a:b]:
                if len(ids):
                    roc_push_set(ans, ids, n)
            return ans.state
        mid = (a + b) // 2
        for lo, hi in ((a, mid), (mid, b)):
            d, u = radix[(lo, hi)]
            q, r = divmod(s, d)
            s = q * u + push(lo, hi, r)
        return s

    return BigANS(push(0, len(lists), 0) if lists else 0).tobytes()


def unpack_joint_ids(raw: bytes, sizes, n: int):
    """Inverse of :func:`pack_joint_ids`: per-cluster sorted id arrays."""
    sizes = [int(s) for s in sizes]
    radix, leaves = _halving_plan(sizes, n)
    lists: List[np.ndarray] = [np.zeros(0, np.int64)] * len(sizes)

    def pop(a: int, b: int, s: int) -> int:
        if (a, b) in leaves:
            ans = BigANS(s)
            # stack order: last pushed, first out
            for k in range(b - 1, a - 1, -1):
                if sizes[k]:
                    lists[k] = roc_pop_set(ans, sizes[k], n)
            return ans.state
        mid = (a + b) // 2
        for lo, hi in ((mid, b), (a, mid)):
            d, u = radix[(lo, hi)]
            q, r = divmod(s, u)
            s = q * d + pop(lo, hi, r)
        return s

    if sizes:
        pop(0, len(sizes), BigANS.frombytes(raw).state)
    return lists


def pack_polya_sections(w: SectionWriter, blob, prefix: str = "code") -> dict:
    """Write a PolyaCodec blob's arrays as sections; returns its meta dict."""
    w.add(f"{prefix}_heads", blob["heads"].astype(np.uint64).tobytes())
    words = blob["words"]
    lens = np.array([len(x) for x in words], np.int64)
    w.add(f"{prefix}_word_lens", lens.tobytes())
    w.add(f"{prefix}_words", np.concatenate(
        [x for x in words] or [np.zeros(0, np.uint32)]).tobytes())
    return {"m": blob["m"], "bits": int(blob["bits"])}


def unpack_polya_sections(r: SectionReader, sizes, meta: dict,
                          prefix: str = "code"):
    """Inverse of :func:`pack_polya_sections`: the reconstructed blob dict."""
    heads = np.frombuffer(r.section(f"{prefix}_heads"), np.uint64)
    lens = np.frombuffer(r.section(f"{prefix}_word_lens"), np.int64)
    flat = np.frombuffer(r.section(f"{prefix}_words"), np.uint32)
    words, off = [], 0
    for ln in lens:
        words.append(flat[off:off + ln].copy())
        off += ln
    return {"heads": heads.copy(), "words": words, "bits": meta["bits"],
            "sizes": [int(s) for s in sizes], "m": meta["m"]}


def pack_ivf(index) -> bytes:
    """Serialize a built repro.ann.ivf.IVFIndex into one v1 RIVF blob."""
    sizes = [int(s) for s in index.sizes]
    w = SectionWriter()
    w.add("ids", pack_joint_ids(index._lists, index.n))
    w.add("centroids", index.centroids.astype(np.float16).tobytes())
    code_meta = None
    if getattr(index, "_code_blob", None) is not None:
        # v1 manifests carry only {"m"} for the polya payload
        code_meta = {"m": pack_polya_sections(w, index._code_blob)["m"]}
    elif index.codes is not None:
        w.add("codes_raw", index.codes.tobytes())
        code_meta = {"m": int(index.codes.shape[1]), "raw": True}
    return w.finish(_MAGIC, _VERSION, {
        "n": int(index.n), "d": int(index.d), "nlist": int(index.nlist),
        "sizes": sizes, "code": code_meta,
        "pq_m": int(index.pq.m) if index.pq else 0,
    })


def unpack_ivf(raw: bytes):
    """Returns (manifest, lists, centroids, codes|None)."""
    r = SectionReader(raw, _MAGIC)
    assert r.version == _VERSION
    manifest = r.manifest
    n, nlist = manifest["n"], manifest["nlist"]
    sizes = manifest["sizes"]
    lists = unpack_joint_ids(r.section("ids"), sizes, n)
    cents = np.frombuffer(r.section("centroids"), np.float16).reshape(
        nlist, manifest["d"]).astype(np.float32)
    codes = None
    cm = manifest["code"]
    if cm and cm.get("raw"):
        codes = np.frombuffer(r.section("codes_raw"), np.uint8).reshape(-1, cm["m"])
    elif cm:
        heads = np.frombuffer(r.section("code_heads"), np.uint64)
        lens = np.frombuffer(r.section("code_word_lens"), np.int64)
        flat = np.frombuffer(r.section("code_words"), np.uint32)
        words, off = [], 0
        for ln in lens:
            words.append(flat[off:off + ln])
            off += ln
        per = polya_decode_clusters(heads, words, sizes, cm["m"])
        codes = np.concatenate([c for c in per], axis=0)
    return manifest, lists, cents, codes
