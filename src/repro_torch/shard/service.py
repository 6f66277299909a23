"""ShardedAnnService — scatter/merge router over per-shard AnnServices.

The port of ``repro.shard.service``.  Same request surface as
:class:`repro_torch.serve.AnnService`
(``submit``/``tick``/``flush``/``search``/``stats``/``memory_ledger``),
but the flushed query block fans out to N shard workers on a thread pool
and the per-shard top-k lists are k-way merged back into one answer.

**Bit-parity.**  With no faults the merged ``(dists, ids)`` are
bit-identical to searching the unsharded index, for every id codec and
scan engine.  Distances match because every shard scores its candidates
with the same kernels over the same stored vectors/codes; the subtle part
is *order under distance ties*.  The monolithic engines break ties by
candidate position (IVF: probe rank then in-cluster offset; Flat/graph:
vector id), so each IVF shard search runs ``with_keys=True`` and returns
a ``(probe_rank << 40) | offset`` merge key per result — globally
comparable because all shards share the coarse quantizer, hence see the
same probe ranking (:mod:`repro_torch.shard.plan`).  The router merges
per query by ``(dist, key)`` via a stable lexsort, reproducing the
monolithic order exactly.  Flat/graph shards merge by ``(dist, global id)``, their
monolithic tie convention.

**Degraded mode.**  Each shard attempt runs under the
:mod:`repro_torch.shard.faults` retry policy and a router-wide wall-clock
deadline.  A shard that exhausts retries, dies or misses the deadline is
dropped from the merge: the batch completes from the surviving shards'
results with ``stats.partial=True`` and ``stats.shards_failed`` set —
never an exception *for shard faults*.  Only the shard fault taxonomy is
degradable (``ShardTimeout``/``ShardDead``/timeouts); programming errors
inside a worker propagate so bugs can't hide as "partial" batches.
``FaultPolicy`` is the injection seam tests use to script kills and
delays.

**Device.**  The workers run on a thread pool and launch the shards'
kernels concurrently, all on the device's current (default) stream; a
kernel wrapper's launch counts are kept under one lock
(:mod:`repro_torch.kernels`).  ``device`` (default ``"cuda"``) names the
device every shard must live on (a saved plan is loaded there); a shard
elsewhere raises, so a service never silently serves from the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from pathlib import Path
from threading import Lock
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..ann.scan import MERGE_KEY_PAD
from ..ann.stats import SearchStats, combine_stats
from ..api.protocol import IvfBacked
from ..device import resolve_device
from ..serve.ann_service import AddTicket, AnnService, BatchPolicy
from .faults import FaultPolicy, RetryPolicy, ShardDead, ShardTimeout
from .plan import ShardPlan

__all__ = ["ShardedAnnService", "ShardTicket"]


@dataclasses.dataclass
class ShardTicket:
    """One request's handle; filled in when its batch is flushed."""

    request_id: int
    n_queries: int
    enqueued_at: float
    done: bool = False
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    stats: Optional[SearchStats] = None  # merged batch stats (shared)
    batch_id: int = -1
    batch_size: int = 0
    wait_s: float = 0.0
    latency_s: float = 0.0


@dataclasses.dataclass
class _ShardResult:
    ids: np.ndarray
    dists: np.ndarray
    keys: Optional[np.ndarray]
    stats: Optional[SearchStats]
    attempts: int                     # 1 = first try succeeded


class ShardedAnnService:
    """Scatter/merge front-end over shard indexes.

    ``shards`` may be a :class:`repro_torch.shard.ShardPlan`, a saved-plan
    directory/manifest path, or a plain sequence of indexes.  Each shard
    gets its own single-threaded :class:`AnnService` worker (guarded by a
    lock — a timed-out attempt may still be running when the router moves
    on); a ``cache_mb`` budget is split evenly across workers.

    ``deadline_s`` bounds each flush's scatter wall-clock; ``retry``
    and ``fault_policy`` come from :mod:`repro_torch.shard.faults`.
    ``device`` (default ``"cuda"``) is where the shards serve from.
    """

    def __init__(self, shards, topk: int = 10,
                 policy: Optional[BatchPolicy] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 cache_mb: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 fault_policy: Optional[FaultPolicy] = None,
                 device="cuda", **search_opts):
        from ..api.indexes import as_api_index

        self.plan: Optional[ShardPlan] = None
        if isinstance(shards, ShardPlan):
            self.plan = shards
            indexes = list(shards.indexes)
        elif isinstance(shards, (str, Path)):
            self.plan = ShardPlan.load(shards, device=device)
            indexes = list(self.plan.indexes)
        else:
            indexes = [as_api_index(s) for s in shards]
        if not indexes:
            raise ValueError("need at least one shard")
        self.nshards = len(indexes)
        self.topk = topk
        self.policy = policy or BatchPolicy()
        self.clock = clock
        self.deadline_s = deadline_s
        self.retry = retry or RetryPolicy()
        self.fault_policy = fault_policy
        self.device = resolve_device(device)
        per_cache = (cache_mb / self.nshards) if cache_mb is not None else None
        # workers never micro-batch on their own: the router owns batching
        worker_policy = BatchPolicy(max_batch=1 << 30, max_wait_s=float("inf"))
        self._workers: List[AnnService] = []
        for idx in indexes:
            opts = dict(search_opts)
            if isinstance(idx, IvfBacked):
                opts["with_keys"] = True   # IVF tie keys for the stable merge
            self._workers.append(AnnService(
                idx, topk=topk, policy=worker_policy, clock=clock,
                cache_mb=per_cache, device=self.device, **opts))
        self._locks = [Lock() for _ in range(self.nshards)]
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, 2 * self.nshards),
            thread_name_prefix="shard")
        self._pending: List[ShardTicket] = []
        self._pending_q: List[np.ndarray] = []
        self._pending_add: List[AddTicket] = []
        self._pending_add_x: List[np.ndarray] = []
        self._n = int(self.plan.n) if self.plan is not None else 0
        self._cluster_owner: Optional[np.ndarray] = None
        self._next_id = 0
        self.reset_stats()

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Shut down the scatter thread pool (also via context manager)."""
        self._pool.shutdown(wait=False)

    def __enter__(self) -> "ShardedAnnService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def reset_stats(self) -> None:
        """Zero the router counters (e.g. after a warm-up call that built
        the kernels)."""
        self.requests = 0
        self.queries = 0
        self.batches = 0
        self.adds = 0
        self.add_rows = 0
        self.add_batches = 0
        self.add_s = 0.0
        self.partial_batches = 0
        self.shards_failed = 0
        self.retries = 0
        self.search_s = 0.0
        self.merge_s = 0.0
        self.fault_log: "deque[tuple]" = deque(maxlen=256)
        self._batch_sizes: "deque[int]" = deque(maxlen=4096)
        self._waits: "deque[float]" = deque(maxlen=4096)
        self._lats: "deque[float]" = deque(maxlen=4096)
        for w in self._workers:
            w.reset_stats()

    # -- request path --------------------------------------------------------
    def submit(self, queries: np.ndarray) -> ShardTicket:
        """Enqueue one request (``(nq, d)`` or ``(d,)``); may trigger a flush."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None]
        t = ShardTicket(request_id=self._next_id,
                        n_queries=queries.shape[0],
                        enqueued_at=self.clock())
        self._next_id += 1
        self._pending.append(t)
        self._pending_q.append(queries)
        self.requests += 1
        self.queries += queries.shape[0]
        if self.pending() >= self.policy.max_batch:
            self.flush()
        else:
            self.tick()
        return t

    # -- ingest path ---------------------------------------------------------
    def submit_add(self, x: np.ndarray) -> AddTicket:
        """Enqueue rows for routed ingest (``(m, d)`` or ``(d,)``).

        Needs a :class:`ShardPlan` (the routing table).  Rows batch under
        the same micro-batching policy as queries and are applied by
        :meth:`flush_adds`: IVF plans assign each row to its nearest
        centroid's cluster and hand it to the shard owning that cluster —
        every shard seals the epoch with the *global* row count, so epoch
        boundaries (hence blob bytes) match the monolithic index.  Flat /
        graph hash plans route by the id-hash rule.  Query flushes apply
        pending adds first (read-your-writes).
        """
        if self.plan is None:
            raise ValueError("routed ingest needs a ShardPlan "
                             "(construct the service from a plan)")
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        t = AddTicket(request_id=self._next_id, n_rows=x.shape[0],
                      enqueued_at=self.clock())
        self._next_id += 1
        self._pending_add.append(t)
        self._pending_add_x.append(x)
        self.adds += 1
        self.add_rows += x.shape[0]
        if self.pending_adds() >= self.policy.max_batch:
            self.flush_adds()
        else:
            self.tick()
        return t

    def flush_adds(self) -> List[AddTicket]:
        """Route every pending add to its owning shard as one epoch."""
        if not self._pending_add:
            return []
        tickets, self._pending_add = self._pending_add, []
        xs, self._pending_add_x = self._pending_add_x, []
        now = self.clock()
        x = np.concatenate(xs, axis=0)
        m = x.shape[0]
        base = self._n
        ids = np.arange(base, base + m, dtype=np.int64)
        t0 = time.perf_counter()
        if m:
            if self.plan.kind == "ivf":
                from ..ann.kmeans import assign

                if self._cluster_owner is None:
                    self._cluster_owner = self.plan.cluster_owner()
                clusters = assign(
                    x, self._workers[0].index.ivf.centroids,
                    device=self.device)
                owner = self._cluster_owner[clusters]
                if np.any(owner < 0):
                    raise ValueError("plan does not own every cluster")
                # EVERY shard seals the epoch (global count), rows or not
                for s in range(self.nshards):
                    sel = owner == s
                    with self._locks[s]:
                        self._workers[s].index.append_rows(
                            x[sel], ids[sel], count=m)
            else:
                owner = self.plan.id_owner(ids)
                for s in range(self.nshards):
                    sel = owner == s
                    if not sel.any():
                        continue
                    with self._locks[s]:
                        self._workers[s].index.append_rows(x[sel], ids[sel])
            self._n = base + m
            self.plan.n = self._n
        apply_s = time.perf_counter() - t0
        self.add_batches += 1
        self.add_s += apply_s
        row = 0
        for t in tickets:
            t.ids = ids[row: row + t.n_rows]
            row += t.n_rows
            t.done = True
            t.batch_id = self.add_batches - 1
            t.batch_size = m
            t.wait_s = max(0.0, now - t.enqueued_at)
            t.apply_s = apply_s
        return tickets

    def add(self, x: np.ndarray) -> AddTicket:
        """Synchronous ingest convenience: submit + immediate apply."""
        t = self.submit_add(x)
        if not t.done:
            self.flush_adds()
        return t

    def pending_adds(self) -> int:
        """Rows currently queued for ingest (not yet routed to shards)."""
        return sum(t.n_rows for t in self._pending_add)

    def tick(self) -> bool:
        """Flush if the oldest pending request exceeded the wait budget."""
        fired = False
        if self._pending_add and (self.clock() - self._pending_add[0].enqueued_at
                                  >= self.policy.max_wait_s):
            self.flush_adds()
            fired = True
        if not self._pending:
            return fired
        if self.clock() - self._pending[0].enqueued_at >= self.policy.max_wait_s:
            self.flush()
            return True
        return fired

    def flush(self) -> List[ShardTicket]:
        """Scatter everything pending to all shards, merge, fill tickets."""
        # read-your-writes: rows submitted before these queries must be live
        self.flush_adds()
        if not self._pending:
            return []
        tickets, self._pending = self._pending, []
        qs, self._pending_q = self._pending_q, []
        now = self.clock()
        batch = np.concatenate(qs, axis=0)
        batch_id = self.batches

        t0 = time.perf_counter()
        results = self._scatter(batch, batch_id)
        scatter_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        dists, ids = self._merge(batch.shape[0],
                                 [r for r in results if r is not None])
        merge_s = time.perf_counter() - t0

        live = [r for r in results if r is not None]
        n_failed = self.nshards - len(live)
        st = combine_stats([r.stats for r in live if r.stats is not None],
                           wall_s=scatter_s + merge_s, merge_s=merge_s)
        st.shards = self.nshards
        st.shards_failed = n_failed
        st.partial = n_failed > 0
        st.retries = sum(r.attempts - 1 for r in live)

        done_at = self.clock()
        self.batches += 1
        self.partial_batches += int(st.partial)
        self.shards_failed += n_failed
        self.retries += st.retries
        self.search_s += scatter_s + merge_s
        self.merge_s += merge_s
        self._batch_sizes.append(batch.shape[0])
        row = 0
        for t in tickets:
            t.ids = ids[row: row + t.n_queries]
            t.dists = dists[row: row + t.n_queries]
            row += t.n_queries
            t.stats = st
            t.done = True
            t.batch_id = batch_id
            t.batch_size = batch.shape[0]
            t.wait_s = max(0.0, now - t.enqueued_at)
            t.latency_s = max(0.0, done_at - t.enqueued_at)
            self._waits.append(t.wait_s)
            self._lats.append(t.latency_s)
        return tickets

    def search(self, queries: np.ndarray,
               with_stats: bool = False):
        """Synchronous convenience: submit + immediate flush.

        Returns ``(ids, dists)`` like ``AnnService.search``; pass
        ``with_stats=True`` for ``(ids, dists, stats)`` with the merged
        :class:`SearchStats` (``partial``/``shards_failed``/``retries``).
        """
        t = self.submit(queries)
        if not t.done:
            self.flush()
        return (t.ids, t.dists, t.stats) if with_stats else (t.ids, t.dists)

    def pending(self) -> int:
        """Queries currently queued for search (not yet scattered)."""
        return sum(t.n_queries for t in self._pending)

    # -- scatter -------------------------------------------------------------
    def _scatter(self, batch: np.ndarray,
                 batch_id: int) -> List[Optional[_ShardResult]]:
        futs = [self._pool.submit(self._attempt_shard, s, batch, batch_id)
                for s in range(self.nshards)]
        end = (time.monotonic() + self.deadline_s
               if self.deadline_s is not None else None)
        out: List[Optional[_ShardResult]] = [None] * self.nshards
        for s, f in enumerate(futs):
            try:
                timeout = (max(0.0, end - time.monotonic())
                           if end is not None else None)
                out[s] = f.result(timeout=timeout)
            except (ShardTimeout, ShardDead, TimeoutError,
                    FuturesTimeout) as e:
                # degrade: drop the shard from the merge (stats.partial);
                # programming errors propagate instead of being swallowed
                self.fault_log.append((batch_id, s, repr(e)))
        return out

    def _attempt_shard(self, s: int, batch: np.ndarray,
                       batch_id: int) -> _ShardResult:
        """One shard's retry loop; runs on the pool.  The per-shard lock
        serializes attempts with any orphaned (timed-out) predecessor."""
        attempt = 0
        with self._locks[s]:
            while True:
                try:
                    if self.fault_policy is not None:
                        self.fault_policy.on_attempt(s, attempt, batch_id)
                    svc = self._workers[s]
                    t = svc.submit(batch)
                    if not t.done:
                        svc.flush()
                    return _ShardResult(ids=t.ids, dists=t.dists, keys=t.keys,
                                        stats=svc.last_stats,
                                        attempts=attempt + 1)
                except ShardDead:
                    raise                      # dead shards don't heal
                except (ShardTimeout, TimeoutError, FuturesTimeout):
                    attempt += 1
                    if attempt >= self.retry.max_attempts:
                        raise
                    self.retry.sleep(self.retry.backoff(attempt - 1))

    # -- merge ---------------------------------------------------------------
    def _merge(self, nq: int, live: List[_ShardResult]
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Stable per-query k-way merge of shard top-k by ``(dist, key)``."""
        k = self.topk
        if not live:
            return (np.full((nq, k), np.inf, np.float32),
                    np.zeros((nq, k), np.int64))
        dists = np.concatenate([r.dists for r in live], axis=1)
        ids = np.concatenate([r.ids for r in live], axis=1)
        keys = np.concatenate([
            r.keys if r.keys is not None else np.where(
                np.isfinite(r.dists), r.ids.astype(np.uint64), MERGE_KEY_PAD)
            for r in live], axis=1)
        # lexsort: last key is primary -> order by (dist, merge key) per row
        order = np.lexsort((keys, dists), axis=1)[:, :k]
        rq = np.arange(nq)[:, None]
        out_d, out_i = dists[rq, order], ids[rq, order]
        # fewer than k finite candidates: normalize pads to (inf, 0)
        pad = ~np.isfinite(out_d)
        out_i[pad] = 0
        return out_d, out_i

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Router counters + SLO accounting (same latency keys as
        ``AnnService.stats``), plus degradation totals:

        * ``shards`` — shard count.
        * ``partial_batches`` — flushes that completed degraded.
        * ``shards_failed`` / ``retries`` — cumulative failed shard
          attempts dropped from merges, and retry attempts that
          eventually succeeded.
        * ``merge_s`` — cumulative k-way merge wall time (``search_s``
          covers scatter + merge).
        """
        bs = np.asarray(self._batch_sizes, np.float64)
        ws = np.asarray(self._waits, np.float64)
        ls = np.asarray(self._lats, np.float64)
        return {
            "requests": self.requests,
            "queries": self.queries,
            "batches": self.batches,
            "adds": self.adds,
            "add_rows": self.add_rows,
            "add_batches": self.add_batches,
            "add_s": self.add_s,
            "shards": float(self.nshards),
            "partial_batches": float(self.partial_batches),
            "shards_failed": float(self.shards_failed),
            "retries": float(self.retries),
            "mean_batch": float(bs.mean()) if bs.size else 0.0,
            "max_batch": float(bs.max()) if bs.size else 0.0,
            "mean_wait_s": float(ws.mean()) if ws.size else 0.0,
            "p99_wait_s": float(np.quantile(ws, 0.99)) if ws.size else 0.0,
            "mean_latency_s": float(ls.mean()) if ls.size else 0.0,
            "p50_latency_s": float(np.quantile(ls, 0.50)) if ls.size else 0.0,
            "p95_latency_s": float(np.quantile(ls, 0.95)) if ls.size else 0.0,
            "search_s": self.search_s,
            "merge_s": self.merge_s,
            "resolve_s": sum(w.resolve_s for w in self._workers),
            "ndis": sum(w.ndis for w in self._workers),
            "decodes": sum(w.decodes for w in self._workers),
            "host_block_bytes": sum(w.host_block_bytes
                                    for w in self._workers),
            "device_selects": sum(w.device_selects for w in self._workers),
        }

    def worker_stats(self) -> List[Dict[str, float]]:
        """Per-shard ``AnnService.stats()`` dicts, by shard id."""
        return [w.stats() for w in self._workers]

    def memory_ledger(self) -> Dict[str, float]:
        """Aggregate of per-shard ledgers (numeric keys summed), plus the
        shard count.  Per-shard ledgers are in the plan manifest."""
        total: Dict[str, float] = {}
        for w in self._workers:
            for key, v in w.memory_ledger().items():
                total[key] = total.get(key, 0.0) + float(v)
        total["shards"] = float(self.nshards)
        return total
