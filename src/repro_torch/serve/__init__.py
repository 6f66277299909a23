"""Serving surface of the port: prefill/decode step builders, the KV cache,
and the ANN micro-batching service.

The LM step builders live next to their training counterparts
(``repro_torch.train.step``) and the cache constructor with the attention
(``repro_torch.models.attention``), as in the reference's ``repro.serve``.
"""

from ..models.attention import KVCache, init_cache
from ..train.step import make_prefill_step, make_serve_step
from .ann_service import AddTicket, AnnService, BatchPolicy, Ticket

__all__ = ["KVCache", "init_cache", "make_prefill_step", "make_serve_step",
           "AnnService", "AddTicket", "BatchPolicy", "Ticket"]
