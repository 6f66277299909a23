"""Exact stack ANS coders.

Two coders live here:

``BigANS``
    An *exact* asymmetric numeral system over an unbounded Python integer
    state.  ``push``/``pop`` are exact bijections, so the coder attains the
    information-theoretic rate with **zero** redundancy (no quantization, no
    renormalization slop).  This is the reference coder used by ROC
    (``repro.core.roc``) and by all oracles in the test-suite.  The paper's
    Eq. (1)-(3) are implemented verbatim; for uniform models we use the
    mixed-radix special case ``s' = s*n + x`` which is Eq. (1) with
    ``p_x = 1, r = n``.

``StreamANS``
    A fixed-width streaming rANS (64-bit head, 32-bit word renormalization)
    with power-of-two totals ``2^r`` (``r`` may vary per op).  With the
    global interval ``I = [2^32, 2^64)`` and symbol intervals
    ``I_s = [freq*2^(32-r), freq*2^(64-r))`` the coder is an exact bijection
    (Duda's b-uniqueness: ``2^r`` divides ``2^32`` for r <= 32), emitting /
    consuming at most one 32-bit word per op.  Adaptive models with
    non-power-of-two raw totals (REC urn, Polya PQ coder) quantize their
    counts to ``2^r`` before each op — both sides of the codec see identical
    counts, so the quantization is reproducible; the redundancy is
    ``O(alphabet/2^r)`` bits/op.  Exact arbitrary-total coding is available
    via ``BigANS``.

The vectorized (lane-parallel) coder lives in ``repro.core.vrans``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["BigANS", "StreamANS"]


class BigANS:
    """Exact ANS over an unbounded integer state.

    The state starts at 0; ``bits`` is the exact information content of
    everything pushed so far.  pops executed on a small state are still
    exact bijections (they simply return low-entropy values), which is what
    makes bits-back coding with ``s0 = 0`` work without an initial-bits
    overhead (see repro.core.roc).
    """

    __slots__ = ("state",)

    def __init__(self, state: int = 0):
        self.state = int(state)

    # -- uniform model: exact mixed-radix coding --------------------------
    def push_uniform(self, x: int, n: int) -> None:
        """Append symbol ``x`` under the uniform model over ``[n)``."""
        if not 0 <= x < n:
            raise ValueError(f"symbol {x} out of range [0, {n})")
        self.state = self.state * n + x

    def pop_uniform(self, n: int) -> int:
        """Pop a symbol under the uniform model over ``[n)`` (inverse of push)."""
        s = self.state
        x = s % n
        self.state = s // n
        return int(x)

    # -- general quantized pmf (paper Eq. (1)-(3)) ------------------------
    def push_pmf(self, cum: int, freq: int, total: int) -> None:
        """Append a symbol with quantized pmf ``freq/total`` and CDF ``cum``."""
        if freq <= 0:
            raise ValueError("zero-frequency symbol cannot be encoded")
        s = self.state
        self.state = (s // freq) * total + cum + (s % freq)

    def pop_cf(self, total: int) -> int:
        """Peek the cumulative-frequency slot of the next symbol (Eq. (2))."""
        return int(self.state % total)

    def pop_advance(self, cum: int, freq: int, total: int) -> None:
        """Advance the state after the symbol for ``pop_cf`` was identified."""
        s = self.state
        cf = s % total
        self.state = freq * (s // total) + cf - cum

    # -- serialization -----------------------------------------------------
    @property
    def bits(self) -> int:
        """Exact size, in bits, of the current state."""
        return self.state.bit_length()

    def tobytes(self) -> bytes:
        nbytes = (self.state.bit_length() + 7) // 8
        return self.state.to_bytes(nbytes, "little")

    @classmethod
    def frombytes(cls, raw: bytes) -> "BigANS":
        return cls(int.from_bytes(raw, "little"))

    def __repr__(self) -> str:  # pragma: no cover
        return f"BigANS(bits={self.bits})"


@dataclasses.dataclass
class StreamANS:
    """Fixed-width streaming rANS, power-of-two totals (64/32 single-renorm).

    Invariant: ``head in [2^32, 2^64)``.  Per op (precision ``r <= 32``):
    the encoder renormalizes into the symbol interval
    ``[freq*2^(32-r), freq*2^(64-r))`` by emitting at most one 32-bit word
    (``freq*2^(64-r) >= 2^32`` guarantees one suffices), then applies
    Eq. (1); the decoder applies Eq. (2)-(3) and consumes at most one word
    when the head drops below ``2^32``.  Exact bijection by b-uniqueness
    (``2^r | 2^32``).
    """

    head: int = 1 << 32          # seed; must be in [2^32, 2^64)
    tail: List[int] = dataclasses.field(default_factory=list)  # 32-bit words

    _WORD = 32
    _MASK = (1 << 32) - 1
    _LOW = 1 << 32

    def push(self, cum: int, freq: int, r: int) -> None:
        """Push a symbol with quantized pmf ``freq / 2^r`` and CDF ``cum``."""
        if freq <= 0:
            raise ValueError("zero-frequency symbol cannot be encoded")
        if r < 0 or r > 32:
            raise ValueError("precision must be in [0, 32]")
        if r == 0:               # zero-information symbol
            return
        if self.head >= freq << (64 - r):
            self.tail.append(self.head & self._MASK)
            self.head >>= self._WORD
        self.head = ((self.head // freq) << r) + cum + (self.head % freq)

    def pop_cf(self, r: int) -> int:
        return int(self.head & ((1 << r) - 1))

    def pop_advance(self, cum: int, freq: int, r: int) -> None:
        if r == 0:               # zero-information symbol
            return
        cf = self.head & ((1 << r) - 1)
        self.head = freq * (self.head >> r) + cf - cum
        if self.head < self._LOW:
            if not self.tail:
                raise ValueError("ANS stream underflow (corrupt or over-read)")
            self.head = (self.head << self._WORD) | self.tail.pop()

    def push_uniform_pow2(self, x: int, r: int) -> None:
        self.push(x, 1, r)

    def pop_uniform_pow2(self, r: int) -> int:
        x = self.pop_cf(r)
        self.pop_advance(x, 1, r)
        return x

    @property
    def bits(self) -> int:
        return len(self.tail) * self._WORD + self.head.bit_length()

    def tobytes(self) -> Tuple[bytes, bytes]:
        import numpy as np

        words = np.asarray(self.tail, dtype=np.uint32)
        nbytes = (self.head.bit_length() + 7) // 8
        return self.head.to_bytes(nbytes, "little"), words.tobytes()

    @classmethod
    def frombytes(cls, head_raw: bytes, tail_raw: bytes) -> "StreamANS":
        import numpy as np

        head = int.from_bytes(head_raw, "little")
        tail = np.frombuffer(tail_raw, dtype=np.uint32)
        return cls(head=head, tail=[int(w) for w in tail])
