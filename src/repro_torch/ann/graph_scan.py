"""Beam-batched graph search on PyTorch — the port of ``repro.ann.graph_scan``.

``GraphIndex.search_ref`` walks one query at a time with Python heaps;
this module advances a *batch* of beams in lockstep, with the same
results bit for bit (ids and distances) and the same steps as the
reference's engine:

1. **Lockstep pop**: every active beam pops its best frontier node in one
   vectorized masked argmin over the frontier arrays (oracle tie order:
   distance, then node id).
2. **Shared frontier gather**: the popped nodes are deduped across beams
   and their friend lists decoded once through the index's shared
   :class:`~repro_torch.ann.scan.DecodedListCache` (``dedup_hits``).
3. **One blocked distance computation per step**: the union of new
   candidates is gathered *on the index's device* from the base uploaded
   once (``index_select``) and scored against the step's queries by
   ``l2_dist`` — the Hopper kernel on a CUDA index, its plain torch
   version on a CPU one (``engine``, resolved as the scan resolves it).
   With ``select="device"`` (the ``auto`` choice on a CUDA index) the
   per-candidate distances ``dmat[step_row, arange]`` are gathered on the
   device and only an ``(n_pad,)`` f32 vector crosses to the host.
4. **Exact beam admission**: kernel distances only *prune* (drop
   candidates beyond the beam bound plus the ``rescore_eps`` band);
   survivors are re-scored with the oracle's own numpy expression and
   admitted in closed form (:meth:`_BeamState.admit_all`).
5. **Array bookkeeping**: visited sets, frontiers and beams live in
   masked numpy arrays, one row per query; :class:`SearchStats` carries
   ``steps`` / ``frontier_size`` / ``dedup_hits`` / ``host_block_bytes``
   / ``device_select``.

Batching contract: results are a pure function of (index, queries, ef,
topk) — independent of ``query_block``, ``kernel_min``, ``select`` and
cache state.  Only the stats differ.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from ..kernels.l2_topk import l2_dist
from .scan import _bucket, _resolve_engine, rescore_eps
from .stats import SearchStats

__all__ = ["batched_graph_search", "score_step", "GRAPH_BLOCK_N",
           "KERNEL_MIN_CPU", "KERNEL_MIN_CUDA"]

DEFAULT_QUERY_BLOCK = 64
# a step's candidate tile is padded to a power of two of at least this
# many columns, its query rows to at least 8
GRAPH_BLOCK_N = 128
# the smallest candidate tile that takes the device scorer (the gate never
# changes results).  A CPU index scores with plain torch, which competes
# with the host re-score it cannot replace, so only a wide tile pays (the
# reference's CPU default).  On a CUDA index the value comes from the card
# (H100 80GB HBM3, 700 W; tools/graph_ladder.py, NSG32 on deep-like at
# 20,000-50,000 vectors, navigable graphs, ten warm passes a gate in
# turns), the passes' median against no kernel: every step on the card
# (gate 128) 8-21% slower, from 512 candidates level to 8% slower, from
# 1024 (2-6% of the steps) within 1%, as is 2048, inside the passes'
# spread of about 15%.  One step's device path (copies, gather, l2_dist,
# copy back) takes ~0.13-0.19 ms at every tile, the host re-score 0.186
# ms for 1024 candidates and 0.42 ms for 2048 (chip_smoke.py), so 1024
# is where the device path starts to pay.
KERNEL_MIN_CPU = GRAPH_BLOCK_N * 8
KERNEL_MIN_CUDA = 1024
# wider headroom than the IVF shortlist (factor 16): beam admission has no
# slack entries to absorb a near-boundary mis-rank, so prune conservatively
PRUNE_EPS_FACTOR = 32.0

_VMAX = np.iinfo(np.int64).max


def score_step(index, qblk: np.ndarray, idx_pad: np.ndarray,
               step_row: np.ndarray | None = None) -> np.ndarray:
    """One step's kernel distances on the index's device.

    ``qblk`` (qb_pad, d) f32 holds the step's query rows, ``idx_pad``
    (n_pad,) the candidate node ids.  The candidates are gathered from the
    device base (``index.base_dev``) and scored by ``l2_dist``.  Without
    ``step_row`` the whole ``(qb_pad, n_pad)`` block comes back; with it
    (the query row of each candidate) only ``dmat[step_row, arange]``,
    gathered on the device, does."""
    dev = index.torch_device
    if step_row is None:
        idx = torch.from_numpy(idx_pad.astype(np.int64)).to(dev)
    else:
        both = torch.from_numpy(np.stack(
            [idx_pad.astype(np.int64), step_row.astype(np.int64)])).to(dev)
        idx, srow = both[0], both[1]
    q = torch.from_numpy(qblk).to(dev)
    dmat = l2_dist(q, index.base_dev.index_select(0, idx))
    if step_row is not None:
        dmat = dmat.gather(0, srow[None, :])[0]
    return dmat.cpu().numpy()


class _BeamState:
    """Masked-array bookkeeping for one block of beams (no Python heaps).

    Per query row: a frontier (unordered array + vectorized argmin pops;
    slots past ``f_len`` hold +inf), a beam of at most ``ef`` results
    with a cached row maximum (worst entry evicted on overflow, oracle
    tie order), and a visited bitmap.  Floats are stored at full width so
    comparisons reproduce the oracle's Python-float semantics exactly.
    """

    def __init__(self, qb: int, n: int, ef: int):
        self.qb, self.n, self.ef = qb, n, ef
        cap = 64
        self.f_d = np.full((qb, cap), np.inf, np.float64)
        self.f_v = np.zeros((qb, cap), np.int64)
        self.f_len = np.zeros(qb, np.int64)
        bcap = max(ef, 1) + 1           # one overflow slot for evict-on-push
        self.b_d = np.zeros((qb, bcap), np.float64)
        self.b_v = np.zeros((qb, bcap), np.int64)
        self.b_len = np.zeros(qb, np.int64)
        self.b_max = np.zeros(qb, np.float64)
        self.visited = np.zeros((qb, n), bool)
        self.active = np.ones(qb, bool)

    def seed(self, entry: int, d0: np.ndarray) -> None:
        """Every beam starts at the entry point (oracle init)."""
        self.f_d[:, 0] = d0
        self.f_v[:, 0] = entry
        self.f_len[:] = 1
        self.b_d[:, 0] = d0
        self.b_v[:, 0] = entry
        self.b_len[:] = 1
        self.b_max[:] = d0
        self.visited[:, entry] = True

    def pop_all(self):
        """One lockstep pop: every active beam removes its frontier minimum
        (ties: lower id); beams whose minimum can no longer improve a full
        beam — or whose frontier is empty — deactivate (oracle stop rule).
        Returns (rows, nodes) of the successful pops."""
        act = np.flatnonzero(self.active)
        alive = self.f_len[act] > 0
        self.active[act[~alive]] = False
        act = act[alive]
        if act.size == 0:
            return act, act
        # steady state has every beam live: skip the row-gather copy
        sub_d = self.f_d if act.size == self.qb else self.f_d[act]
        sub_v = self.f_v if act.size == self.qb else self.f_v[act]
        m = sub_d.min(axis=1)           # inf padding keeps slots inert
        # column of the lexicographic (d, v) minimum per row
        vm = np.where(sub_d == m[:, None], sub_v, _VMAX)
        j = np.argmin(vm, axis=1)
        stop = (self.b_len[act] >= self.ef) & (m > self.b_max[act])
        self.active[act[stop]] = False
        act, m, j = act[~stop], m[~stop], j[~stop]
        if act.size == 0:
            return act, act
        u = self.f_v[act, j]
        last = self.f_len[act] - 1      # swap-with-last removal
        self.f_d[act, j] = self.f_d[act, last]
        self.f_v[act, j] = self.f_v[act, last]
        self.f_d[act, last] = np.inf
        self.f_len[act] = last
        return act, u

    def admit_all(self, rows: np.ndarray, vs: np.ndarray, ds: np.ndarray,
                  rank: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                  beams: np.ndarray, erow: np.ndarray) -> None:
        """Exact sequential admission for a whole step, in closed form.

        The oracle processes each beam's survivors in friend-list order:
        accept when the beam is short or the distance beats the beam
        maximum, then evict the worst entry (ties: lower id).  Two facts
        replace that loop with vectorized counting + one row sort:

        * A rejected survivor is, when processed, >= the beam's ef-th
          smallest distance, and that threshold only tightens afterwards
          — so pooling rejected survivors with the accepted ones never
          changes the ef-th smallest VALUE.  Hence survivor j is accepted
          iff fewer than ef elements of (live beam entries ∪ ALL earlier
          survivors of its beam this step) are <= it: a pure counting
          test with no dependence on the acceptance sequence.
        * Every evicted entry is, at eviction time, the (d asc, id desc)
          maximum of its beam, and later arrivals are strictly better —
          so the final beam is exactly the ef smallest elements of
          (old beam ∪ accepted) under (d asc, id desc).

        ``rank``/``starts``/``counts``/``beams``/``erow`` describe the
        per-beam contiguous runs of (rows, vs, ds).
        """
        ef = self.ef
        B = beams.shape[0]
        live = np.arange(ef)[None, :] < self.b_len[beams][:, None]
        oldm = np.where(live, self.b_d[beams, :ef], np.inf)
        cnt_old = (oldm[erow] <= ds[:, None]).sum(axis=1)
        mm = int(counts.max())
        dvp = np.full((B, mm), np.inf)
        dvp[erow, rank] = ds
        tri = np.arange(mm)[:, None] > np.arange(mm)[None, :]
        pc = ((dvp[:, None, :] <= dvp[:, :, None]) & tri[None]).sum(axis=-1)
        acc = cnt_old + pc[erow, rank] < ef
        # frontier pushes: accepted survivors, within-beam order preserved
        csum = np.cumsum(acc)
        acnt = csum[starts + counts - 1] - csum[starts] + acc[starts]
        aoff = csum - 1 - (csum[starts] - acc[starts])[erow]
        rows_a = rows[acc]
        fpos = self.f_len[rows_a] + aoff[acc]
        self.f_d[rows_a, fpos] = ds[acc]
        self.f_v[rows_a, fpos] = vs[acc]
        self.f_len[beams] += acnt
        # beams: one (d asc, id desc) row sort of old ∪ accepted; slots
        # past the new length come out as +inf and are never read
        d_mrg = np.full((B, ef + mm), np.inf)
        d_mrg[:, :ef] = oldm
        v_mrg = np.full((B, ef + mm), -1, np.int64)
        v_mrg[:, :ef] = self.b_v[beams, :ef]
        d_mrg[erow, ef + rank] = np.where(acc, ds, np.inf)
        v_mrg[erow, ef + rank] = vs
        order = np.lexsort((-v_mrg, d_mrg), axis=-1)[:, :ef]
        brow = np.arange(B)[:, None]
        d_keep = d_mrg[brow, order]
        self.b_d[beams, :ef] = d_keep
        self.b_v[beams, :ef] = v_mrg[brow, order]
        newlen = np.minimum(self.b_len[beams] + acnt, ef)
        self.b_len[beams] = newlen
        self.b_max[beams] = d_keep[np.arange(B), newlen - 1]

    def reserve(self, beams: np.ndarray, counts: np.ndarray) -> None:
        """One capacity check per step: after this, every insert path may
        push up to ``counts`` entries per beam without further checks.
        Compaction is tried before growing — it usually wins, keeping the
        frontier arrays (and every pop's scan width) small."""
        need = int((self.f_len[beams] + counts).max())
        if need <= self.f_d.shape[1]:
            return
        self.compact()
        need = int((self.f_len[beams] + counts).max())
        while need > self.f_d.shape[1]:
            self.f_d = np.concatenate(
                [self.f_d, np.full_like(self.f_d, np.inf)], axis=1)
            self.f_v = np.concatenate(
                [self.f_v, np.zeros_like(self.f_v)], axis=1)

    def compact(self) -> None:
        """Drop frontier entries that can never be popped.  Once a beam is
        full its stop/admission threshold (the beam maximum) only
        tightens, so entries strictly worse than it are dead weight: a pop
        that would select one deactivates the beam first — and an emptied
        frontier deactivates it the same way."""
        thr = np.where(self.b_len >= self.ef, self.b_max, np.inf)
        keep = self.f_d <= thr[:, None]
        cols = np.arange(self.f_d.shape[1])[None, :]
        keep &= cols < self.f_len[:, None]   # padding is not a real entry
        order = np.argsort(~keep, axis=1, kind="stable")
        self.f_d = np.take_along_axis(self.f_d, order, axis=1)
        self.f_v = np.take_along_axis(self.f_v, order, axis=1)
        self.f_len = keep.sum(axis=1)
        self.f_d[cols >= self.f_len[:, None]] = np.inf

    def insert_bulk(self, rows: np.ndarray, vs: np.ndarray, ds: np.ndarray,
                    off: np.ndarray, beams: np.ndarray,
                    counts: np.ndarray) -> None:
        """All survivors of beams that cannot overflow this step
        (``b_len + count <= ef``): every insert runs with a short beam, so
        the oracle accepts unconditionally and never evicts — one
        vectorized append replaces the whole sequential loop.  ``off`` is
        each element's position within its beam's group."""
        fl = self.f_len[rows] + off
        self.f_d[rows, fl] = ds
        self.f_v[rows, fl] = vs
        bl = self.b_len[rows] + off
        self.b_d[rows, bl] = ds
        self.b_v[rows, bl] = vs
        self.f_len[beams] += counts
        self.b_len[beams] += counts
        gmax = np.maximum.reduceat(ds, np.cumsum(counts) - counts)
        self.b_max[beams] = np.maximum(self.b_max[beams], gmax)

    def results(self, i: int, topk: int):
        """(ids, dists) sorted by (distance, id) — the oracle's final sort."""
        bl = int(self.b_len[i])
        order = np.lexsort((self.b_v[i, :bl], self.b_d[i, :bl]))[:topk]
        return self.b_v[i, order], self.b_d[i, order]


def batched_graph_search(index, queries: np.ndarray, ef: int = 16,
                         topk: int = 10, engine: str = "auto",
                         query_block: int = DEFAULT_QUERY_BLOCK,
                         kernel_min: int | None = None,
                         select: str = "auto"):
    """Beam-batched search; bit-identical to ``index.search_ref``.

    ``kernel_min`` is the smallest candidate tile that takes the device
    scorer (kernel distances only prune, so the gate never changes
    results); default ``KERNEL_MIN_CUDA`` on a CUDA index and
    ``KERNEL_MIN_CPU`` on a CPU one.

    ``select`` places the per-step distance gather: ``"host"`` pulls the
    whole scored ``(qb_pad, n_pad)`` step block and gathers
    ``dmat[step_row, arange]`` in numpy; ``"device"`` gathers on the
    device so only the ``(n_pad,)`` candidate-distance vector crosses to
    the host (``stats.host_block_bytes`` / ``stats.device_select`` are the
    ledger); ``"auto"`` selects on the device on a CUDA index.  Either way
    the same floats feed the same prune, and the exact numpy re-score
    decides admission.

    Returns ``(ids (nq, topk) int64, dists (nq, topk) f32, SearchStats)``.
    """
    dev = index.torch_device
    engine = _resolve_engine(engine, dev)
    if select not in ("auto", "host", "device"):
        raise ValueError(f"unknown select mode {select!r} "
                         "(options: auto, host, device)")
    on_cpu = dev.type == "cpu"
    if kernel_min is None:
        kernel_min = KERNEL_MIN_CPU if on_cpu else KERNEL_MIN_CUDA
    dev_sel = select == "device" or (select == "auto" and not on_cpu)
    t0 = time.perf_counter()
    queries = np.asarray(queries)
    nq, n, d = queries.shape[0], index.n, index.x.shape[1]
    ids = np.zeros((nq, topk), np.int64)
    dists = np.full((nq, topk), np.inf, np.float32)
    q32 = queries.astype(np.float32, copy=False)
    qn_host = np.einsum("qd,qd->q", q32, q32)
    cache = index.decoded_cache
    decodes0 = cache.decodes
    ndis = hops = steps = frontier_size = dedup_hits = 0
    host_block_bytes = 0
    n_dev_select = 0
    # base term of scan.rescore_eps; vectorized below as
    # f32eps * (1 + |bound| + qn) == rescore_eps(d, bound, qn, factor)
    f32eps = rescore_eps(d, 0.0, 0.0, PRUNE_EPS_FACTOR)

    for q0 in range(0, nq, query_block):
        q1 = min(nq, q0 + query_block)
        qb = q1 - q0
        qblk_src = queries[q0:q1]
        state = _BeamState(qb, n, ef)
        # oracle init: per-query scalar entry distance (same numpy expression)
        d0 = np.empty(qb, np.float64)
        for i in range(qb):
            d0[i] = float(np.sum((index.x[index.entry] - qblk_src[i]) ** 2))
        ndis += qb
        state.seed(index.entry, d0)
        # per-block memo over the shared cache: a node expanded by ANY beam
        # at ANY step of this block is decoded at most once
        friends: Dict[int, np.ndarray] = {}

        while state.active.any():
            steps += 1
            frontier_size += int(state.active.sum())
            rows, nodes = state.pop_all()
            if rows.size == 0:
                continue
            hops += rows.size
            # -- shared frontier gather: decode each distinct node once -----
            fr_lists: List[np.ndarray] = []
            step_seen = set()
            for u in nodes:
                u = int(u)
                if u in step_seen:
                    dedup_hits += 1
                else:
                    step_seen.add(u)
                fl_ = friends.get(u)
                if fl_ is None:
                    fl_ = friends[u] = index._friends(u)
                fr_lists.append(fl_)
            # -- unvisited filter, all beams at once ------------------------
            # each beam pops exactly one node per step and friend lists hold
            # no repeats, so the (row, friend) pairs are unique and one
            # fancy-index pass filters + marks every beam (friend-list
            # order within each beam is preserved by the grouped concat)
            lens = np.fromiter((f.shape[0] for f in fr_lists), np.int64,
                               len(fr_lists))
            if not int(lens.sum()):
                continue
            all_v = np.concatenate(fr_lists)
            all_row = np.repeat(rows, lens)
            fresh = ~state.visited[all_row, all_v]
            cand_v, cand_row = all_v[fresh], all_row[fresh]
            if cand_v.size == 0:
                continue
            state.visited[cand_row, cand_v] = True
            ndis += cand_v.size
            # -- one blocked distance computation for the whole step --------
            # (only when the tile clears the kernel_min gate: the kernel
            # distances are a prune, never a decision, so narrow steps
            # skip the device round trip and go straight to the exact
            # host re-score)
            if cand_v.size >= kernel_min:
                # beams appear as ascending contiguous runs: run boundaries
                # give the query-tile row per candidate without a sort
                mark = np.empty(cand_row.shape[0], bool)
                mark[0] = True
                np.not_equal(cand_row[1:], cand_row[:-1], out=mark[1:])
                step_row = np.cumsum(mark) - 1
                beam_rows = cand_row[mark]
                # candidates go in as-is (a cross-beam repeat is scored
                # twice — cheaper than a sort-based dedup of the tile)
                idx_pad = np.zeros(
                    _bucket(cand_v.shape[0], floor=GRAPH_BLOCK_N), np.int32)
                idx_pad[:cand_v.shape[0]] = cand_v
                qblk = np.zeros((_bucket(beam_rows.shape[0], floor=8), d),
                                np.float32)
                qblk[:beam_rows.shape[0]] = q32[q0 + beam_rows]
                # -- exact admission: kernel prunes, numpy decides ----------
                # the admission bound only tightens as a step's survivors
                # are inserted, so the step-entry bound plus the kernel
                # error band is a sound prune for full beams; short beams
                # keep everything
                if dev_sel:
                    n_dev_select += 1
                    srow = np.zeros(idx_pad.shape[0], np.int64)
                    srow[:cand_v.shape[0]] = step_row
                    kd = score_step(index, qblk, idx_pad, srow)
                    host_block_bytes += kd.nbytes
                    kd = kd[:cand_v.shape[0]]
                else:
                    dmat = score_step(index, qblk, idx_pad)
                    host_block_bytes += dmat.nbytes
                    kd = dmat[step_row, np.arange(cand_v.shape[0])]
                full = state.b_len[cand_row] >= ef
                tau = state.b_max[cand_row]
                eps = f32eps * (1.0 + np.abs(tau) + qn_host[q0 + cand_row])
                keep = ~full | (kd <= tau + eps)
                cand_v, cand_row = cand_v[keep], cand_row[keep]
                if cand_v.size == 0:
                    continue
            # oracle's scalar path on the survivors (per-row reduction is
            # independent of which other rows are stacked with it)
            dv = np.sum((index.x[cand_v] - qblk_src[cand_row]) ** 2, axis=1)
            # -- admission ---------------------------------------------------
            # beams are independent: only WITHIN-beam order is semantic, and
            # the grouped concat keeps friend-list order per beam.  Beams
            # that cannot overflow this step take the bulk append (the
            # sequential loop degenerates to accept-all); everything else
            # goes through the closed-form admission (see admit_all)
            T = cand_v.shape[0]
            mark = np.empty(T, bool)
            mark[0] = True
            np.not_equal(cand_row[1:], cand_row[:-1], out=mark[1:])
            starts = np.flatnonzero(mark)
            counts = np.empty(starts.shape[0], np.int64)
            counts[:-1] = starts[1:] - starts[:-1]
            counts[-1] = T - starts[-1]
            beams = cand_row[starts]
            state.reserve(beams, counts)
            rank = np.arange(T) - np.repeat(starts, counts)
            no_ov = state.b_len[beams] + counts <= ef
            if no_ov.all():
                state.insert_bulk(cand_row, cand_v, dv, rank, beams, counts)
                continue
            erow = np.repeat(np.arange(beams.shape[0]), counts)
            state.admit_all(cand_row, cand_v, dv, rank, starts, counts,
                            beams, erow)

        for i in range(qb):
            rv, rd = state.results(i, topk)
            ids[q0 + i, :rv.shape[0]] = rv
            dists[q0 + i, :rd.shape[0]] = rd

    stats = SearchStats(
        wall_s=time.perf_counter() - t0,
        ndis=ndis,
        id_resolve_s=0.0,
        decodes=cache.decodes - decodes0,
        engine=f"graph-{engine}",
        visited=hops,
        steps=steps,
        frontier_size=frontier_size,
        dedup_hits=dedup_hits,
        host_block_bytes=host_block_bytes,
        device_select=n_dev_select,
    )
    return ids, dists, stats
