"""repro_torch — the compressed-id ANN stack on PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: same index layer,
same factory-spec grammar, same bit-parity contracts, with the scan
engine's kernels (``l2_dist``, ``pq_adc``, ``seg_topk``) written by hand
in CUDA C++ for ``sm_90a`` (``repro_torch/csrc``).  It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller asks for ``device="cpu"``; on a CPU
index each kernel wrapper runs its plain torch version instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
