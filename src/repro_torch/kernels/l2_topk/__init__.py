from .ops import l2_dist, l2_top1
from .ref import l2_dist_ref, l2_top1_ref

__all__ = ["l2_dist", "l2_dist_ref", "l2_top1", "l2_top1_ref"]
