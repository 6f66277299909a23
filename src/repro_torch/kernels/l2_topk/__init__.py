from .ops import l2_dist
from .ref import l2_dist_ref

__all__ = ["l2_dist", "l2_dist_ref"]
