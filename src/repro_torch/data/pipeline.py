"""Deterministic, resumable, sharded token pipeline (a copy of the
reference's ``repro.data.pipeline``: numpy only, the same batches).

Synthetic Zipf token streams (offline container) with the properties a real
pipeline needs at scale: (a) the batch for step t is a pure function of
(seed, step) — restart-safe without data loss or duplication; (b) each data
shard draws a disjoint slice (host-sharded loading); (c) state is one
integer, carried in the checkpoint manifest.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    step: int = 0
    zipf_a: float = 1.3
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        b = self.batch // self.n_shards
        ranks = rng.zipf(self.zipf_a, size=(b, self.seq_len + 1))
        toks = np.minimum(ranks - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(self.step)
            self.step += 1

    def state(self) -> dict:
        return {"seed": self.seed, "step": self.step}

    def restore(self, state: dict) -> "TokenPipeline":
        self.seed = int(state["seed"])
        self.step = int(state["step"])
        return self
