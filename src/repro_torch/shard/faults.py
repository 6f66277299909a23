"""Fault layer for the sharded router: deadlines, retries, injection.

The port's own copy of ``repro.shard.faults`` (no device code).

A sharded service multiplies the ways one query batch can fail — any of
N shard workers can be slow, wedged or gone.  The router's contract is
**graceful degradation**: a failing shard costs recall (its partition's
candidates go missing) but never costs availability.  This module holds
the pieces the router composes:

* :class:`RetryPolicy` — attempts + exponential backoff between them
  (``sleep`` is injectable so tests never really wait).
* :class:`FaultPolicy` — the injection hook.  The router calls
  ``on_attempt(shard_id, attempt, batch_id)`` right before each per-shard
  search attempt; the hook may sleep (simulating a slow shard, tripping
  the router's deadline) or raise (simulating a dead or flaky one).  The
  default policy does nothing; tests use :class:`ScriptedFaults` to kill
  or delay specific shards deterministically, and :class:`RandomFaults`
  gives a seeded background failure rate.
* Exceptions — :class:`ShardTimeout` (retryable), :class:`ShardDead`
  (not retryable: a dead process won't heal between backoffs).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

__all__ = ["ShardFault", "ShardTimeout", "ShardDead", "RetryPolicy",
           "FaultPolicy", "ScriptedFaults", "RandomFaults"]


class ShardFault(Exception):
    """Base class for injected/observed per-shard failures."""


class ShardTimeout(ShardFault):
    """A shard attempt exceeded its deadline; retrying may succeed."""


class ShardDead(ShardFault):
    """A shard is gone; retrying is pointless (fail fast, degrade)."""


@dataclasses.dataclass
class RetryPolicy:
    """Per-shard retry-with-backoff knobs.

    ``max_attempts`` counts the first try (1 = no retries).  Attempt
    ``i`` (0-based) that fails retryably sleeps
    ``backoff_s * backoff_mult**i`` before attempt ``i+1``.
    """

    max_attempts: int = 2
    backoff_s: float = 0.005
    backoff_mult: float = 2.0
    sleep: Callable[[float], None] = time.sleep

    def backoff(self, attempt: int) -> float:
        return self.backoff_s * self.backoff_mult ** attempt


class FaultPolicy:
    """No-op injection hook; subclass to script failures.

    ``on_attempt`` runs in the shard's worker thread immediately before
    the search attempt.  Raise to fail the attempt (:class:`ShardDead`
    skips retries); sleep to simulate slowness against the router's
    ``deadline_s``.
    """

    def on_attempt(self, shard_id: int, attempt: int, batch_id: int) -> None:
        del shard_id, attempt, batch_id

    def reset(self) -> None:
        """Forget scripted state (e.g. between test phases)."""


class ScriptedFaults(FaultPolicy):
    """Deterministic per-shard faults for tests.

    * ``dead`` — shard ids that always raise :class:`ShardDead`.
    * ``flaky`` — shard id -> number of attempts that raise
      :class:`ShardTimeout` before succeeding (exercises the retry path).
    * ``delay_s`` — shard id -> real sleep before each attempt (trips the
      router's wall-clock deadline).
    """

    def __init__(self, dead=(), flaky: Optional[Dict[int, int]] = None,
                 delay_s: Optional[Dict[int, float]] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.dead = frozenset(dead)
        self.flaky = dict(flaky or {})
        self.delay_s = dict(delay_s or {})
        self._sleep = sleep
        self.injected = 0

    def on_attempt(self, shard_id: int, attempt: int, batch_id: int) -> None:
        if shard_id in self.dead:
            self.injected += 1
            raise ShardDead(f"shard {shard_id} scripted dead")
        if shard_id in self.delay_s:
            self._sleep(self.delay_s[shard_id])
        if self.flaky.get(shard_id, 0) > attempt:
            self.injected += 1
            raise ShardTimeout(
                f"shard {shard_id} scripted timeout (attempt {attempt})")


class RandomFaults(FaultPolicy):
    """Seeded Bernoulli(``rate``) retryable failure per attempt.

    Deterministic given ``seed``, so a run with a background fault rate
    reproduces run to run: each attempt draws from its own stream,
    ``SeedSequence([seed, batch_id, shard_id, attempt])``.  (The
    reference draws from one sequential stream, so which shard fails
    depends on the order in which the router's pool threads reach it.)
    """

    def __init__(self, rate: float, seed: int = 0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError("fault rate must be in [0, 1]")
        self.rate = float(rate)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self.injected = 0

    def on_attempt(self, shard_id: int, attempt: int, batch_id: int) -> None:
        draw = np.random.default_rng(
            [self.seed, batch_id, shard_id, attempt]).random()
        if draw < self.rate:
            with self._lock:
                self.injected += 1
            raise ShardTimeout(
                f"shard {shard_id} random fault (attempt {attempt})")
