"""repro_torch.kernels — the port's kernels, by hand for Hopper.

Each kernel package pairs a wrapper (``ops.py``) with a plain torch
version (``ref.py``).  The CUDA C++ sources live in ``repro_torch/csrc``
and are built by :mod:`repro_torch.kernels._build` at first use.

A wrapper runs the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches``
(a plain integer, updated under one lock, ``_check.COUNT_LOCK``, since
the sharded router launches from several threads at once), so a run can
show which kernels its path went through;
``seg_topk`` also counts its launches by ``(n, k)`` and by ``(rows, n,
k)``, ``l2_top1`` by ``(K, d, rows)``, ``pq_adc`` and ``l2_dist`` the rows
they scored, ``l2_dist`` its launches by ``(NQ, N)`` tile, and ``wt_rank``
its launches by route (:func:`launch_shapes`):

* ``l2_topk.l2_dist``  — squared-L2 block for flat vectors (the scan).
* ``l2_topk.l2_top1``  — nearest centroid per row (k-means assignment in
  build and ingest).
* ``pq_adc.pq_adc``    — batched PQ ADC scoring against an arena of codes.
* ``seg_topk.seg_topk`` — segmented top-k select, bit-exact
  ``(value, column)`` order.
* ``wt_rank.wt_rank``  — batched ``rank1`` over a bit-packed vector.
* ``rans_decode.rans_decode`` — interleaved-lane 32/16 rANS decode.

``wt_rank`` and ``rans_decode`` lie on no engine path, in the reference or
here: their entry point is this package.
"""

from .l2_topk import l2_dist, l2_dist_ref, l2_top1, l2_top1_ref
from .pq_adc import pq_adc, pq_adc_ref
from .rans_decode import make_tables, rans_decode, rans_decode_ref
from .seg_topk import seg_topk, seg_topk_ref
from ._check import COUNT_LOCK
from .wt_rank import pack_bits_u32, wt_rank, wt_rank_ref

__all__ = ["l2_dist", "l2_dist_ref", "l2_top1", "l2_top1_ref", "pq_adc",
           "pq_adc_ref", "seg_topk", "seg_topk_ref", "wt_rank", "wt_rank_ref",
           "pack_bits_u32", "rans_decode", "rans_decode_ref", "make_tables",
           "reset_launches", "launch_counts", "launch_shapes"]

_WRAPPERS = {"l2_dist": l2_dist, "l2_top1": l2_top1, "pq_adc": pq_adc,
             "seg_topk": seg_topk, "wt_rank": wt_rank,
             "rans_decode": rans_decode}


def reset_launches() -> None:
    """Set every kernel's launch count (and the shape counts) to 0."""
    with COUNT_LOCK:
        for w in _WRAPPERS.values():
            w.launches = 0
        seg_topk.shapes = {}
        seg_topk.tiles = {}
        l2_dist.tiles = {}
        l2_top1.shapes = {}
        wt_rank.routes = {}
        pq_adc.rows = l2_dist.rows = 0


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    with COUNT_LOCK:
        return {name: w.launches for name, w in _WRAPPERS.items()}


def launch_shapes() -> dict:
    """Shapes since the last reset: ``{"seg_topk": {(n, k): launches},
    "seg_topk_tiles": {(rows, n, k): launches}, "l2_top1": {(K, d, rows):
    launches}, "pq_adc": rows, "l2_dist": rows, "l2_dist_tiles": {(NQ, N):
    launches}, "wt_rank": {route: launches}}``."""
    with COUNT_LOCK:
        return {"seg_topk": dict(seg_topk.shapes),
                "seg_topk_tiles": dict(seg_topk.tiles),
                "l2_top1": dict(l2_top1.shapes),
                "pq_adc": pq_adc.rows, "l2_dist": l2_dist.rows,
                "l2_dist_tiles": dict(l2_dist.tiles),
                "wt_rank": dict(wt_rank.routes)}
