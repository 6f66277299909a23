"""Epoched id storage — O(Δ) online ingest for the paper's codecs.

Every codec in :mod:`repro.core.codecs` (and the joint wavelet tree)
encodes a list against a *fixed universe*: growing the id space from
``n`` to ``n + Δ`` changes every blob's rate and decode, which is why a
naive ``IVFIndex.add`` had to re-encode the entire index per append.

The epoch scheme decouples freshly-ingested data from the compacted
store (the "Decoupling Vector Data and Index Storage" architecture,
arXiv:2604.09173): each **epoch** owns a contiguous global-id range
``[base, base + count)`` and encodes its per-cluster id lists *relative
to its base* with universe ``count``.  Appending a batch of Δ vectors
creates one new epoch and touches nothing else — encoding work is
O(Δ), and previously-encoded epochs (including their wavelet trees)
are immutable until **compaction** folds all epochs back into a single
``[0, n)`` epoch, recovering the single-universe compression rate.

The logical per-cluster list is the concatenation of the per-epoch
lists in epoch order.  Because epoch ranges are ascending and disjoint
and each per-epoch list is sorted, the concatenation is *globally
sorted* — so storage order == sorted order, the invariant the batched
scanner's late id resolution (§4.1) and the sharded merge keys rely
on, holds across epochs by construction.

Shards reuse the scheme unchanged: a cluster shard keeps the global
epoch boundaries (``base``/``count`` are universe-wide) but only its
owned clusters' blobs — which are byte-identical to the monolithic
epoch's blobs, since both encode the same relative list against the
same universe.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .codecs import get_codec
from .wavelet_tree import WaveletTree

__all__ = ["Epoch", "EpochStore", "wt_sequence"]


def wt_sequence(lists: List[np.ndarray], n: int, nlist: int):
    """``(sequence, nsyms)`` for the wavelet tree over ``lists``.

    Monolithically the lists partition ``[0, n)`` and the sequence is the
    plain cluster-assignment string over ``nlist`` symbols.  A
    planner-made cluster shard covers only part of the universe: absent
    ids map to the sentinel symbol ``nlist`` (alphabet ``nlist + 1``),
    which no search ever selects on, so ``select(k, off)`` still returns
    ids for every owned cluster.  The rule is a pure function of
    ``(lists, n, nlist)`` — the planner and the RIDX loader apply it
    independently and agree, so ``id_bits()`` bookkeeping round-trips
    through save/load for shards too.
    """
    seq = np.full(n, nlist, np.int64)
    for k, lst in enumerate(lists):
        if len(lst):
            seq[lst] = k
    covered = int(sum(len(lst) for lst in lists))
    return seq, (nlist if covered == n else nlist + 1)


@dataclasses.dataclass
class Epoch:
    """One immutable ingest generation: ids in ``[base, base + count)``.

    ``sizes[k]`` counts the *locally held* members of cluster ``k`` (all
    of them monolithically, the owned subset on a shard).  ``blobs[k]``
    is cluster ``k``'s relative-id blob (stream codecs), or ``wt`` is the
    joint wavelet tree over the epoch's relative assignment string.
    """

    base: int
    count: int                               # relative universe of this epoch
    sizes: np.ndarray                        # (nlist,) int64 local counts
    blobs: Optional[List[object]] = None     # per-cluster codec blobs
    wt: Optional[WaveletTree] = None         # joint wt (ids=wt/wt1)

    @property
    def end(self) -> int:
        return self.base + self.count


class EpochStore:
    """Per-cluster id lists stored as a sequence of epochs.

    The owner (``IVFIndex`` / the shard planner / the RIDX loader) feeds
    it *relative, sorted* per-cluster lists per epoch; the store answers
    ``resolve`` queries over logical per-cluster offsets (the scanner's
    late-resolution pairs), reports ``id_bits`` across epochs, and
    rebuilds itself on ``compact``.
    """

    def __init__(self, nlist: int, id_codec: str):
        self.nlist = int(nlist)
        self.id_codec = id_codec
        self.is_wt = id_codec in ("wt", "wt1")
        self.codec = None if self.is_wt else get_codec(id_codec)
        self.epochs: List[Epoch] = []
        # (n_epochs + 1, nlist) cumulative per-cluster local counts: epoch e
        # holds logical offsets [cum[e, k], cum[e + 1, k]) of cluster k
        self._cum = np.zeros((1, self.nlist), np.int64)

    # -- bookkeeping ---------------------------------------------------------
    @property
    def n_epochs(self) -> int:
        return len(self.epochs)

    @property
    def end(self) -> int:
        """One past the largest id any epoch may hold (0 when empty)."""
        return self.epochs[-1].end if self.epochs else 0

    def id_bits(self) -> int:
        total = 0
        for ep in self.epochs:
            if self.is_wt:
                total += ep.wt.size_bits if ep.wt is not None else 0
            else:
                total += int(sum(self.codec.size_bits(b) for b in ep.blobs))
        return total

    # -- growth --------------------------------------------------------------
    def append(self, rel_lists: Sequence[np.ndarray], base: int,
               count: int) -> Epoch:
        """Seal one epoch: per-cluster *relative* sorted lists over
        universe ``count``, owning global range ``[base, base + count)``."""
        if base != self.end:
            raise ValueError(
                f"epoch base {base} does not extend the store (end "
                f"{self.end}); epochs must tile the id space")
        if count <= 0:
            raise ValueError("epoch count must be positive")
        if len(rel_lists) != self.nlist:
            raise ValueError(f"need one list per cluster ({self.nlist})")
        rel_lists = [np.asarray(lst, np.int64) for lst in rel_lists]
        sizes = np.array([len(lst) for lst in rel_lists], np.int64)
        if self.is_wt:
            seq, nsyms = wt_sequence(rel_lists, count, self.nlist)
            wt = WaveletTree.build(seq, nsyms,
                                   compressed=(self.id_codec == "wt1"))
            ep = Epoch(base=base, count=count, sizes=sizes, wt=wt)
        else:
            blobs = [self.codec.encode(lst, count) for lst in rel_lists]
            ep = Epoch(base=base, count=count, sizes=sizes, blobs=blobs)
        self.epochs.append(ep)
        self._cum = np.vstack([self._cum, self._cum[-1] + sizes])
        return ep

    def compact(self, lists: Sequence[np.ndarray], n: int) -> None:
        """Fold every epoch into one ``[0, n)`` epoch re-encoded from the
        *global* per-cluster lists (single-universe rates again).  The
        owner must invalidate its decoded-list cache afterwards — epoch
        indices restart at 0, so stale entries would alias."""
        self.epochs = []
        self._cum = np.zeros((1, self.nlist), np.int64)
        self.append([np.asarray(lst, np.int64) for lst in lists], 0, n)

    # -- derived views -------------------------------------------------------
    def rel_lists(self, e: int, lists: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Epoch ``e``'s relative per-cluster lists, sliced out of the
        *global* sorted lists (epoch members are contiguous in them)."""
        lo, hi = self._cum[e], self._cum[e + 1]
        base = self.epochs[e].base
        return [np.asarray(lists[k][lo[k]:hi[k]], np.int64) - base
                for k in range(self.nlist)]

    def split(self, mask: np.ndarray, lists: Sequence[np.ndarray]
              ) -> "EpochStore":
        """Shard view: owned clusters (``mask``) keep their blobs verbatim
        (same relative list, same universe -> same bytes), unowned ones
        hold an empty stream; wavelet trees rebuild per epoch with the
        sentinel rule.  Epoch boundaries stay global."""
        out = EpochStore(self.nlist, self.id_codec)
        for e, ep in enumerate(self.epochs):
            rel = self.rel_lists(e, lists)
            rel = [rel[k] if mask[k] else np.zeros(0, np.int64)
                   for k in range(self.nlist)]
            if self.is_wt:
                out.append(rel, ep.base, ep.count)
            else:
                sizes = np.where(mask, ep.sizes, 0).astype(np.int64)
                empty = self.codec.encode(np.zeros(0, np.int64), ep.count)
                blobs = [ep.blobs[k] if mask[k] else empty
                         for k in range(self.nlist)]
                sh = Epoch(base=ep.base, count=ep.count, sizes=sizes,
                           blobs=blobs)
                out.epochs.append(sh)
                out._cum = np.vstack([out._cum, out._cum[-1] + sizes])
        return out

    # -- queries -------------------------------------------------------------
    def resolve(self, clusters: np.ndarray, offsets: np.ndarray,
                cache) -> np.ndarray:
        """Logical ``(cluster, offset)`` pairs -> global ids.

        Offsets index the concatenated-across-epochs cluster list; each
        pair is routed to its epoch by a searchsorted over the per-cluster
        cumulative counts, then resolved inside the epoch — per-epoch
        decode through ``cache`` for stream codecs (keyed ``(epoch,
        cluster)``, so appends never invalidate warm entries), random
        ``gather`` for EF/compact/uncompressed, ``select`` for wavelet
        trees — and shifted by the epoch base.
        """
        clusters = np.asarray(clusters, np.int64)
        offsets = np.asarray(offsets, np.int64)
        out = np.empty(clusters.shape[0], np.int64)
        if clusters.shape[0] == 0:
            return out
        order = np.argsort(clusters, kind="stable")
        bounds = np.flatnonzero(np.diff(clusters[order])) + 1
        for grp in np.split(order, bounds):
            k = int(clusters[grp[0]])
            offs = offsets[grp]
            cum_k = self._cum[:, k]
            e_idx = np.searchsorted(cum_k, offs, side="right") - 1
            for e in np.unique(e_idx):
                ep = self.epochs[int(e)]
                sel = e_idx == e
                rel = offs[sel] - cum_k[e]
                if self.is_wt:
                    vals = ep.wt.select_batch([k] * int(sel.sum()), rel)
                else:
                    blob = ep.blobs[k]
                    vals = self.codec.gather(blob, rel)
                    if vals is None:
                        ids_rel = cache.get(
                            (int(e), k),
                            lambda: np.asarray(
                                self.codec.decode(blob, ep.count)))
                        vals = ids_rel[rel]
                out[grp[sel]] = np.asarray(vals, np.int64) + ep.base
        return out
