"""Per-call search statistics, shared by every index type.

One stats shape for the whole index layer (IVF scan, graph best-first,
flat brute force) so ``repro.serve.AnnService`` and the benchmarks can
aggregate decode/latency counters without caring which structure served
the batch.  Fields that do not apply to a given index type stay at their
zero default (e.g. ``visited`` for IVF, ``batches`` for graphs).

The sharded router (``repro.shard.ShardedAnnService``) reports through
the same shape: :func:`combine_stats` sums the per-shard counters of one
scattered batch (wall time is the *max* across shards — they run in
parallel) and the fault layer fills ``shards`` / ``shards_failed`` /
``partial`` / ``retries`` so a degraded answer is visible in-band
instead of as an exception.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["SearchStats", "combine_stats"]


@dataclasses.dataclass
class SearchStats:
    wall_s: float
    ndis: int                  # distance evaluations this call
    id_resolve_s: float        # late id-resolution time (IVF §4.1; 0 for graphs)
    decodes: int = 0           # id-list decode events this call (LRU misses)
    distinct_probed: int = 0   # distinct clusters probed across the batch (IVF)
    batches: int = 0           # query blocks scanned (0 for search_ref/graphs)
    engine: str = "ref"        # "pallas" | "xla" | "ref" | "graph*" | "flat"
    visited: int = 0           # graph nodes expanded (0 for IVF/flat)
    steps: int = 0             # lockstep beam iterations (batched graph only)
    frontier_size: int = 0     # sum of active beams over steps (graph batched)
    dedup_hits: int = 0        # same-step friend-list fetches shared across beams
    # -- device-side top-k select ledger (repro.kernels.seg_topk) ------------
    # bytes of device-computed distance data copied to the host this call:
    # the full (qb, C_pad) block on the host-select path, only the (qb, K)
    # shortlists on the device-select path — the proof the block never
    # materialized host-side when device_select covers every block/step
    host_block_bytes: int = 0
    device_select: int = 0     # query blocks / graph steps selected on device
    # -- sharded-serving aggregation (repro.shard) ---------------------------
    shards: int = 0            # shards scattered to (0 = unsharded call)
    shards_failed: int = 0     # shards that missed the deadline / died
    partial: bool = False      # True when results merged from < all shards
    retries: int = 0           # per-shard attempts beyond the first
    # (nq, topk) uint64 stable-merge keys, only filled when the caller asked
    # for them (``with_keys=True``): the monolithic tie order of each result,
    # so a sharded merge can reproduce the unsharded output bit-for-bit.
    merge_keys: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)


def combine_stats(parts: Sequence[SearchStats], *, wall_s: float,
                  merge_s: float = 0.0) -> SearchStats:
    """Sum per-shard stats of one scattered batch into one report.

    Counters add; ``wall_s`` is supplied by the caller (shards run
    concurrently, so per-shard walls overlap — pass the scatter+merge
    wall clock); ``merge_s`` is folded into ``id_resolve_s`` as the
    router's post-search bookkeeping cost.  ``engine`` is taken from the
    first part (shards of one plan share an engine).
    """
    out = SearchStats(wall_s=wall_s, ndis=0, id_resolve_s=merge_s,
                      engine=parts[0].engine if parts else "ref")
    for s in parts:
        out.ndis += s.ndis
        out.id_resolve_s += s.id_resolve_s
        out.decodes += s.decodes
        out.distinct_probed += s.distinct_probed
        out.batches += s.batches
        out.visited += s.visited
        out.steps += s.steps
        out.frontier_size += s.frontier_size
        out.dedup_hits += s.dedup_hits
        out.host_block_bytes += s.host_block_bytes
        out.device_select += s.device_select
        out.retries += s.retries
    return out
