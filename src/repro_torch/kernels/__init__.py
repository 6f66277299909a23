"""repro_torch.kernels — the scan engine's kernels, by hand for Hopper.

Each kernel package pairs a wrapper (``ops.py``) with a plain torch
version (``ref.py``).  The CUDA C++ sources live in ``repro_torch/csrc``
and are built by :mod:`repro_torch.kernels._build` at first use.

A wrapper runs the plain version only when its tensors lie on the CPU;
for CUDA tensors it launches the kernel or raises — there is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches``
(a plain integer), so a run can show which kernels its path went through:

* ``l2_topk.l2_dist``  — squared-L2 block for flat vectors.
* ``pq_adc.pq_adc``    — batched PQ ADC scoring against an arena of codes.
* ``seg_topk.seg_topk`` — segmented top-k select, bit-exact
  ``(value, column)`` order.
"""

from .l2_topk import l2_dist, l2_dist_ref
from .pq_adc import pq_adc, pq_adc_ref
from .seg_topk import seg_topk, seg_topk_ref

__all__ = ["l2_dist", "l2_dist_ref", "pq_adc", "pq_adc_ref", "seg_topk",
           "seg_topk_ref", "reset_launches", "launch_counts"]

_WRAPPERS = {"l2_dist": l2_dist, "pq_adc": pq_adc, "seg_topk": seg_topk}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for w in _WRAPPERS.values():
        w.launches = 0


def launch_counts() -> dict:
    """``{kernel name: launches since the last reset}``."""
    return {name: w.launches for name, w in _WRAPPERS.items()}
