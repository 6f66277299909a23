"""The one index contract every front door implements (as in ``repro.api``).

``repro_torch.api`` exposes its indexes through a single protocol so the
service (``repro_torch.serve.AnnService``) can hold any of them:

* ``build(x)`` — construct from a vector matrix, returns self.
* ``add(x)`` — append vectors to a built index (ids continue upward).
* ``search(queries, k, **opts) -> (dists, ids, stats)`` — faiss D/I
  order; ``stats`` is a :class:`repro_torch.ann.stats.SearchStats` whatever
  the structure.  Per-structure knobs ride in ``opts`` (IVF: ``nprobe``,
  ``engine``, ``query_block``; graph: ``ef``).
* ``memory_ledger()`` — bytes by component plus uncompressed baselines.
* ``spec`` — the canonical factory string; ``index_factory(idx.spec)``
  reconstructs an equivalent empty index.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, Tuple, runtime_checkable

import numpy as np

from ..ann.stats import SearchStats

__all__ = ["Index", "IvfBacked"]


@runtime_checkable
class Index(Protocol):
    """Structural type of every factory-built index."""

    @property
    def spec(self) -> str: ...

    def build(self, x: np.ndarray) -> "Index": ...

    def add(self, x: np.ndarray) -> "Index": ...

    def search(self, queries: np.ndarray, k: int = 10, **opts: Any
               ) -> Tuple[np.ndarray, np.ndarray, SearchStats]: ...

    def memory_ledger(self) -> Dict[str, float]: ...



@runtime_checkable
class IvfBacked(Protocol):
    """An api index backed by a core ``IVFIndex`` (exposes ``.ivf``).

    The sharded router keys merge behaviour on this: IVF shards return
    ``(probe_rank << 40) | offset`` merge keys, flat/graph shards merge
    by global id.  Checking the protocol (instead of ``hasattr`` on the
    hot path) keeps the seam explicit.
    """

    @property
    def ivf(self) -> Any: ...
