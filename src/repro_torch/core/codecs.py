"""Pluggable id-list codec registry — the paper's Table 1/2 codec matrix.

Every codec exposes the same small interface over a *set of unique ids*
drawn from ``[universe)`` (one inverted list / one friend list):

    blob = codec.encode(ids, universe)
    ids' = codec.decode(blob, universe)       # sorted ascending
    bits = codec.size_bits(blob)              # paper-comparable payload

Codecs:
    unc64 / unc32 — FAISS defaults (64/32-bit machine words)      [paper Unc.]
    compact       — ceil(log2 N) bits per id                      [paper Comp.]
    ef            — Elias-Fano                                    [paper EF]
    roc           — Random Order Coding, exact ANS                [paper ROC]
    gap_ans       — sorted-gap + interleaved-lane rANS (TPU path) [beyond paper]

The wavelet tree is not in this registry because it is a *joint* structure
over all clusters (see repro.core.wavelet_tree / repro.ann.ivf).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np

from .ans import BigANS
from .elias_fano import EliasFano
from .gap_ans import GapAnsCodec
from .roc import roc_pop_set, roc_push_set

__all__ = ["get_codec", "CODEC_NAMES", "IdCodec"]


class IdCodec:
    """Codec contract (codified by tests/test_codec_edges.py):

    * ``encode`` accepts any array of unique ids from ``[universe)`` —
      including the empty set, a single id, and the full universe — in any
      order; ``decode`` returns them sorted ascending as int64.
    * ``size_bits(blob) >= 0``, and is 0 only for the empty set (modulo a
      codec's fixed per-list header).
    * ``gather(blob, offsets)`` returns the ids at the given sorted-order
      positions for random-access codecs (EF/compact/uncompressed) and
      ``None`` for stream codecs (ROC/gap-ANS), which the caller resolves
      by decoding the whole list once (see repro.ann.scan).
    """

    name: str = "base"

    def encode(self, ids: np.ndarray, universe: int):
        raise NotImplementedError

    def decode(self, blob, universe: int) -> np.ndarray:
        raise NotImplementedError

    def size_bits(self, blob) -> int:
        raise NotImplementedError

    def gather(self, blob, offsets: np.ndarray):
        """Random access: ids at ``offsets`` (positions in sorted order).

        Returns ``None`` when the codec only supports full decode.
        """
        return None


@dataclasses.dataclass
class RawCodec(IdCodec):
    width: int = 64

    @property
    def name(self) -> str:
        return f"unc{self.width}"

    def encode(self, ids, universe):
        return {"ids": np.sort(np.asarray(ids, dtype=np.int64)), "n": len(ids)}

    def decode(self, blob, universe):
        return blob["ids"]

    def size_bits(self, blob):
        return self.width * blob["n"]

    def gather(self, blob, offsets):
        return blob["ids"][np.asarray(offsets, dtype=np.int64)]


class CompactCodec(IdCodec):
    name = "compact"

    def encode(self, ids, universe):
        return {
            "ids": np.sort(np.asarray(ids, dtype=np.int64)),
            "n": len(ids),
            "w": max(1, math.ceil(math.log2(max(2, universe)))),
        }

    def decode(self, blob, universe):
        return blob["ids"]

    def size_bits(self, blob):
        return blob["w"] * blob["n"]

    def gather(self, blob, offsets):
        return blob["ids"][np.asarray(offsets, dtype=np.int64)]


class EFCodec(IdCodec):
    name = "ef"

    def encode(self, ids, universe):
        return EliasFano.encode(np.asarray(ids), universe)

    def decode(self, blob, universe):
        return blob.decode()

    def size_bits(self, blob):
        return blob.size_bits

    def gather(self, blob, offsets):
        return np.array([blob.access(int(o)) for o in np.asarray(offsets)],
                        dtype=np.int64)


class ROCCodec(IdCodec):
    name = "roc"

    def encode(self, ids, universe):
        ans = BigANS()
        roc_push_set(ans, np.asarray(ids), universe)
        return {"state": ans.tobytes(), "n": len(ids)}

    def decode(self, blob, universe):
        ans = BigANS.frombytes(blob["state"])
        return roc_pop_set(ans, blob["n"], universe)

    def size_bits(self, blob):
        return len(blob["state"]) * 8 - _leading_zero_bits(blob["state"])


def _leading_zero_bits(raw: bytes) -> int:
    """Exact bit count: whole bytes minus the top byte's unused bits."""
    if not raw:
        return 0
    top = raw[-1]
    return 8 - top.bit_length() if top else 8


class GapCodec(IdCodec):
    name = "gap_ans"

    def __init__(self, lanes: int = 0):   # 0 = scale lanes with cluster size
        self._impl = GapAnsCodec(lanes=lanes)

    def encode(self, ids, universe):
        return self._impl.encode(np.asarray(ids), universe)

    def decode(self, blob, universe):
        return self._impl.decode(blob, universe)

    def size_bits(self, blob):
        return self._impl.size_bits(blob)


_REGISTRY: Dict[str, Callable[[], IdCodec]] = {
    "unc64": lambda: RawCodec(64),
    "unc32": lambda: RawCodec(32),
    "compact": CompactCodec,
    "ef": EFCodec,
    "roc": ROCCodec,
    "gap_ans": GapCodec,
}

CODEC_NAMES = tuple(_REGISTRY)


def get_codec(name: str) -> IdCodec:
    """A fresh id codec by registry name (one of ``CODEC_NAMES``)."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(f"unknown id codec {name!r}; options: {CODEC_NAMES}")
