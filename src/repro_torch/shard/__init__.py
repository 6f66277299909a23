"""repro_torch.shard — sharded ANN serving: planner, scatter/merge router,
faults (the port of ``repro.shard``).

One machine's RAM bounds one :class:`repro_torch.serve.AnnService`; this
package is the capacity story past that bound.  ``plan_shards`` splits a
built index into N standalone shard artifacts (RIDX containers + a JSON
manifest, the reference's bytes and format),
:class:`ShardedAnnService` scatters query batches across per-shard
workers and k-way merges the answers bit-identically to the unsharded
index, and :mod:`repro_torch.shard.faults` degrades gracefully when
shards slow down or die.  Shards live on the source index's device; the
service and ``ShardPlan.load`` take ``device=`` (default ``"cuda"``).
"""

from .faults import (FaultPolicy, RandomFaults, RetryPolicy, ScriptedFaults,
                     ShardDead, ShardFault, ShardTimeout)
from .plan import ShardInfo, ShardPlan, plan_shards
from .service import ShardedAnnService, ShardTicket

__all__ = [
    "plan_shards", "ShardPlan", "ShardInfo",
    "ShardedAnnService", "ShardTicket",
    "FaultPolicy", "ScriptedFaults", "RandomFaults", "RetryPolicy",
    "ShardFault", "ShardTimeout", "ShardDead",
]
