"""Batched ``rank1`` over a bit-packed vector — the wavelet tree's rank.

``pack_bits_u32`` lays bits out as the reference does; ``wt_rank``
answers ``rank1(q)`` for a batch of positions, bit-exactly equal to the
plain cumsum-and-gather ``wt_rank_ref``.
"""

from .ops import pack_bits_u32, wt_rank
from .ref import wt_rank_ref

__all__ = ["wt_rank", "wt_rank_ref", "pack_bits_u32"]
