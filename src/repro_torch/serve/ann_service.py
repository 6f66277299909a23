"""AnnService — request micro-batching over a ``repro_torch.api`` index.

The serving deployment the paper motivates: a RAM-resident ANN index with
losslessly-compressed ids answers nearest-neighbor requests from many
clients.  The service holds any :class:`repro_torch.api.Index` — IVF,
NSG/HNSW graph or flat — through the one protocol (a raw ``IVFIndex`` or
``GraphIndex`` is auto-wrapped).  Search knobs (IVF: ``nprobe``,
``engine``, ``query_block``, ``select``; graph: ``ef``, ``engine``,
``query_block``, ``select``, ``kernel_min``; flat: ``engine``,
``query_block``) ride in as keyword options; ``cache_mb`` overrides an
IVF or graph index's decoded-list cache budget.

Individual requests are small (often one query); the batched engines
(repro_torch.ann.scan, .graph_scan) only pay off when whole query blocks hit the kernels
together.  This service closes that gap with a max-batch/max-wait
micro-batching policy:

* ``submit(queries)`` enqueues a request and returns a :class:`Ticket`.
  A flush is triggered when the pending queue reaches ``max_batch``
  queries, or when the oldest pending request has waited ``max_wait_s``.
* ``flush()`` concatenates all pending requests into one query block,
  runs a single batched search, and splits ids/distances back per ticket
  (each ticket also records its wait time, batch id and batch size).
* ``tick()`` lets a driver loop enforce the max-wait deadline without new
  arrivals (the clock is injectable, so tests are deterministic).

Batching never changes results — the scan layer's batching contract
guarantees the answer for each query is independent of what it was
batched with.

The service also keeps a **memory ledger** (:meth:`memory_ledger`):
compressed id bytes vs the uncompressed/compact layouts, code/vector
payload, centroids, and the decoded-list LRU cache — the numbers a
capacity planner needs for "how many replicas fit in this RAM".
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from ..api.indexes import as_api_index
from ..device import resolve_device

__all__ = ["AnnService", "AddTicket", "BatchPolicy", "Ticket"]


@dataclasses.dataclass
class BatchPolicy:
    """Micro-batching knobs: flush at ``max_batch`` queued queries or when
    the oldest request has waited ``max_wait_s`` seconds."""

    max_batch: int = 64
    max_wait_s: float = 0.002


@dataclasses.dataclass
class Ticket:
    """One request's handle; filled in when its batch is flushed."""

    request_id: int
    n_queries: int
    enqueued_at: float
    done: bool = False
    ids: Optional[np.ndarray] = None
    dists: Optional[np.ndarray] = None
    batch_id: int = -1
    batch_size: int = 0            # total queries in the flushed batch
    wait_s: float = 0.0            # enqueue -> flush start
    search_s: float = 0.0          # batch search wall time (shared)
    latency_s: float = 0.0         # submit -> results ready (wait + search)
    keys: Optional[np.ndarray] = None  # stable-merge keys (with_keys searches)


@dataclasses.dataclass
class AddTicket:
    """One ingest request's handle; filled in when its batch is applied."""

    request_id: int
    n_rows: int
    enqueued_at: float
    done: bool = False
    ids: Optional[np.ndarray] = None   # global ids assigned to the rows
    batch_id: int = -1
    batch_size: int = 0                # total rows in the applied batch
    wait_s: float = 0.0
    apply_s: float = 0.0               # batch apply wall time (shared)


class AnnService:
    """Micro-batching front-end over a ``repro_torch.api.Index``.

    ``**search_opts`` are forwarded to every ``index.search`` call
    (IVF: ``nprobe``/``engine``/``query_block``/``select``; graph:
    ``ef``/``engine``/``query_block``/``select``/``kernel_min``; flat:
    ``engine``/``query_block``).  ``clock`` is injectable
    (defaults to ``time.perf_counter``) so the max-wait policy is
    testable without sleeping.  Beside :meth:`stats` (the reference's
    keys), a graph index's beam steps and same-step decode reuse are
    summed in the ``steps`` and ``dedup_hits`` attributes.

    ``device`` (default ``"cuda"``) names the device the caller expects
    the index to run on; a mismatch with the index's own device raises,
    so a service never silently serves from the CPU.
    """

    def __init__(self, index, topk: int = 10,
                 policy: Optional[BatchPolicy] = None,
                 clock: Callable[[], float] = time.perf_counter,
                 cache_mb: Optional[float] = None, device="cuda",
                 **search_opts):
        self.index = as_api_index(index)
        want = resolve_device(device)
        if self.index.device != want:
            raise ValueError(f"AnnService(device={str(device)!r}) over an "
                             f"index on {self.index.device}")
        self.topk = topk
        self.policy = policy or BatchPolicy()
        self.search_opts = search_opts
        self.clock = clock
        if cache_mb is not None:
            inner = getattr(self.index, "ivf", None) or getattr(
                self.index, "graph", None)
            if inner is None:
                raise ValueError(
                    f"index {self.index.spec!r} has no decoded-list cache "
                    "to budget")
            inner.decoded_cache.set_budget(int(cache_mb * (1 << 20)))
        self._pending: List[Ticket] = []
        self._pending_q: List[np.ndarray] = []
        self._pending_add: List[AddTicket] = []
        self._pending_add_x: List[np.ndarray] = []
        self._next_id = 0
        self.reset_stats()

    def reset_stats(self) -> None:
        """Zero the service counters (e.g. after a warm-up call that built the kernels)."""
        self.requests = 0
        self.queries = 0
        self.batches = 0
        self.adds = 0
        self.add_rows = 0
        self.add_batches = 0
        self.add_s = 0.0
        self.ndis = 0
        self.decodes = 0
        self.search_s = 0.0
        self.resolve_s = 0.0
        self.host_block_bytes = 0
        self.device_selects = 0
        self.steps = 0
        self.dedup_hits = 0
        self.last_stats = None         # SearchStats of the most recent flush
        # bounded: long-lived replicas must not grow per-request state
        self._batch_sizes: "deque[int]" = deque(maxlen=4096)
        self._waits: "deque[float]" = deque(maxlen=4096)
        self._lats: "deque[float]" = deque(maxlen=4096)

    # -- request path --------------------------------------------------------
    def submit(self, queries: np.ndarray) -> Ticket:
        """Enqueue one request (``(nq, d)`` or ``(d,)``); may trigger a flush."""
        queries = np.asarray(queries)
        if queries.ndim == 1:
            queries = queries[None]
        t = Ticket(request_id=self._next_id, n_queries=queries.shape[0],
                   enqueued_at=self.clock())
        self._next_id += 1
        self._pending.append(t)
        self._pending_q.append(queries)
        self.requests += 1
        self.queries += queries.shape[0]
        if self._pending_total() >= self.policy.max_batch:
            self.flush()
        else:
            self.tick()
        return t

    # -- ingest path ---------------------------------------------------------
    def submit_add(self, x: np.ndarray) -> AddTicket:
        """Enqueue rows for ingest (``(m, d)`` or ``(d,)``).

        Ingest micro-batches under the same policy as queries: appended
        rows are sealed into ONE epoch per flush (one entropy-coding pass
        per batch, not per request).  Any query flush applies pending adds
        first, so a submit -> search sequence always sees its own rows.
        """
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
        """Apply every pending add as one epoch; complete the tickets."""
        if not self._pending_add:
            return []
        tickets, self._pending_add = self._pending_add, []
        xs, self._pending_add_x = self._pending_add_x, []
        now = self.clock()
        x = np.concatenate(xs, axis=0)
        base = int(self.index.n)
        t0 = time.perf_counter()
        self.index.add(x)
        apply_s = time.perf_counter() - t0
        self.add_batches += 1
        self.add_s += apply_s
        row = 0
        for t in tickets:
            t.ids = np.arange(base + row, base + row + t.n_rows, dtype=np.int64)
            row += t.n_rows
            t.done = True
            t.batch_id = self.add_batches - 1
            t.batch_size = x.shape[0]
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
        """Rows currently queued for ingest (not yet applied)."""
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

    def flush(self) -> List[Ticket]:
        """Run one batched search over everything pending; complete tickets."""
        # read-your-writes: rows submitted before these queries must be live
        self.flush_adds()
        if not self._pending:
            return []
        tickets, self._pending = self._pending, []
        qs, self._pending_q = self._pending_q, []
        now = self.clock()
        batch = np.concatenate(qs, axis=0)
        dists, ids, st = self.index.search(batch, k=self.topk,
                                           **self.search_opts)
        done_at = self.clock()
        self.last_stats = st
        keys = getattr(st, "merge_keys", None)
        self.batches += 1
        self.ndis += st.ndis
        self.decodes += st.decodes
        self.search_s += st.wall_s
        self.resolve_s += st.id_resolve_s
        self.host_block_bytes += getattr(st, "host_block_bytes", 0)
        self.device_selects += getattr(st, "device_select", 0)
        self.steps += getattr(st, "steps", 0)
        self.dedup_hits += getattr(st, "dedup_hits", 0)
        self._batch_sizes.append(batch.shape[0])
        row = 0
        for t in tickets:
            t.ids = ids[row: row + t.n_queries]
            t.dists = dists[row: row + t.n_queries]
            if keys is not None:
                t.keys = keys[row: row + t.n_queries]
            row += t.n_queries
            t.done = True
            t.batch_id = self.batches - 1
            t.batch_size = batch.shape[0]
            t.wait_s = max(0.0, now - t.enqueued_at)
            t.search_s = st.wall_s
            t.latency_s = max(0.0, done_at - t.enqueued_at)
            self._waits.append(t.wait_s)
            self._lats.append(t.latency_s)
        return tickets

    def search(self, queries: np.ndarray):
        """Synchronous convenience: submit + immediate flush."""
        t = self.submit(queries)
        if not t.done:
            self.flush()
        return t.ids, t.dists

    def pending(self) -> int:
        """Queries currently queued for search (not yet flushed)."""
        return self._pending_total()

    def _pending_total(self) -> int:
        return sum(t.n_queries for t in self._pending)

    # -- accounting ----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """Service counters and SLO accounting.

        Keys — counters are lifetime totals (since ``reset_stats``);
        distributions cover the last 4096 samples (bounded window):

        * ``requests`` / ``queries`` / ``batches`` — totals.
        * ``mean_batch`` / ``max_batch`` — flushed-batch size distribution.
        * ``mean_wait_s`` / ``p99_wait_s`` — enqueue -> flush-start wait
          (the micro-batching cost in isolation).
        * ``p50_latency_s`` / ``p95_latency_s`` / ``mean_latency_s`` —
          per-ticket submit -> results-ready wall time (wait + batched
          search), the per-request SLO numbers the sharded router reports.
        * ``search_s`` / ``resolve_s`` — cumulative index search wall and
          late-id-resolution time.
        * ``ndis`` / ``decodes`` — distance evaluations and id-list decode
          events (LRU misses).
        * ``host_block_bytes`` / ``device_selects`` — device-select
          ledger: bytes of device-computed distance data pulled to the
          host, and query blocks / graph steps whose top-k cut or distance
          gather ran on device.
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
            "mean_batch": float(bs.mean()) if bs.size else 0.0,
            "max_batch": float(bs.max()) if bs.size else 0.0,
            "mean_wait_s": float(ws.mean()) if ws.size else 0.0,
            "p99_wait_s": float(np.quantile(ws, 0.99)) if ws.size else 0.0,
            "mean_latency_s": float(ls.mean()) if ls.size else 0.0,
            "p50_latency_s": float(np.quantile(ls, 0.50)) if ls.size else 0.0,
            "p95_latency_s": float(np.quantile(ls, 0.95)) if ls.size else 0.0,
            "search_s": self.search_s,
            "resolve_s": self.resolve_s,
            "ndis": self.ndis,
            "decodes": self.decodes,
            "host_block_bytes": self.host_block_bytes,
            "device_selects": self.device_selects,
        }

    def memory_ledger(self) -> Dict[str, float]:
        """Bytes by component, plus the uncompressed/compact baselines
        (delegated to the index — uniform across index types)."""
        return self.index.memory_ledger()
