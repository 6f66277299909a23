"""repro_torch — the compressed-id ANN stack on PyTorch and CUDA (Hopper).

A second package beside the JAX reference ``repro``: same index layer,
same factory-spec grammar, same bit-parity contracts, with the six
kernels (``l2_dist``, ``pq_adc``, ``seg_topk``, ``l2_top1``,
``wt_rank``, ``rans_decode``) written by hand in CUDA C++ for ``sm_90a``
(``repro_torch/csrc``).  Beside the ANN side (``core``, ``ann``, ``api``,
``serve``, ``shard``, ``kernels``), the LM side: ``configs``,
``models``, ``train`` (serving steps, the train step, AdamW), ``data``,
``distributed`` (gradient compression), ``checkpoint``, ``retrieval``
and ``launch`` (the serving and training drivers).  It imports ``torch``
and numpy only — never ``jax`` and nothing of ``repro``.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
CUDA is absent unless the caller asks for ``device="cpu"``; on a CPU
index each kernel wrapper runs its plain torch version instead.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
