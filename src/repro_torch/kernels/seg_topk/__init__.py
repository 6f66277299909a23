"""Segmented top-k select — the device half of the scan engine's top-k.

``seg_topk`` reduces padded per-query candidate rows to their ``k``
smallest ``(value, column)`` pairs, bit-identically to the plain version
``seg_topk_ref``; see ``ops.py`` for the contract.
"""

from .ops import seg_topk
from .ref import seg_topk_ref

__all__ = ["seg_topk", "seg_topk_ref"]
