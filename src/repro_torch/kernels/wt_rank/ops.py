"""Batched rank1 on a bit-packed vector (the wavelet tree's rank step).

Counterpart of the reference's ``repro.kernels.wt_rank`` (``ops.py``):
``pack_bits_u32`` is a numpy copy of its packing, and ``wt_rank`` answers
``rank1(q)``, the number of ones in ``[0, q)``, for each query position.

torch's ``uint32`` has little operator support, so the wrapper carries
the u32 words as **int32 bit patterns** (``words.view(np.int32)`` of
``pack_bits_u32``'s output); the kernel reads them back as u32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from .._check import cuda_args, ptr, stream_of
from .ref import wt_rank_ref

__all__ = ["pack_bits_u32", "wt_rank"]

WORDS_PER_SUPER = 16
ROUTES = ("global", "resident")   # by the code ``wt_rank_route`` returns


def pack_bits_u32(bits: np.ndarray):
    """bits (N,) 0/1 -> (words u32 (W,), super_cum i32 (S,)), little-endian.

    ``words`` is padded to a superblock multiple plus one slack
    superblock; ``super_cum[s]`` counts the ones before word ``16 s``.
    Byte-equal to the reference's ``pack_bits_u32``.
    """
    n = len(bits)
    W = -(-n // 32)
    pad = np.zeros(W * 32, np.uint8)
    pad[:n] = bits
    words = pad.reshape(W, 32).astype(np.uint32)
    words = (words << np.arange(32, dtype=np.uint32)).sum(axis=1,
                                                          dtype=np.uint32)
    Wp = (-(-W // WORDS_PER_SUPER) + 1) * WORDS_PER_SUPER
    words = np.concatenate([words, np.zeros(Wp - W, np.uint32)])
    counts = np.bitwise_count(words).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(counts)])
    super_cum = cum[::WORDS_PER_SUPER][: Wp // WORDS_PER_SUPER + 1].astype(
        np.int32)
    return words, super_cum


def wt_rank(words: torch.Tensor, super_cum: torch.Tensor,
            queries: torch.Tensor) -> torch.Tensor:
    """words (W,) int32 bit patterns, super_cum (S,) int32 as
    ``pack_bits_u32`` gives them, queries (Q,) int32 -> (Q,) int32 ranks.

    A query must lie in ``[0, 32 W]`` and its superblock in ``super_cum``;
    any other query gives -1.  CPU tensors take the plain version; CUDA
    tensors launch ``csrc/wt_rank.cu``, bit-equal to it, on the route the
    library picks by size: ``"resident"`` (the bitvector in each SM's
    shared memory) where words and ``super_cum`` fit and the batch is large
    enough to pay for loading them, else ``"global"``.
    ``wt_rank.routes`` counts the launches of each route.
    """
    if words.dim() != 1 or super_cum.dim() != 1 or queries.dim() != 1:
        raise ValueError("wt_rank: words, super_cum and queries are 1-D")
    nq = queries.shape[0]
    if nq == 0:
        return torch.zeros(0, dtype=torch.int32, device=queries.device)
    if all(t.device.type == "cpu" for t in (words, super_cum, queries)):
        return wt_rank_ref(words, super_cum, queries)
    cuda_args("wt_rank", words, super_cum, queries)
    if not (words.dtype == super_cum.dtype == queries.dtype == torch.int32):
        raise TypeError("wt_rank: kernel takes int32 words (u32 bit "
                        "patterns), super_cum and queries")
    out = torch.empty(nq, dtype=torch.int32, device=queries.device)
    lib = _build.library("wt_rank")
    fn = lib.wt_rank_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ptr(words), ptr(super_cum), ptr(queries), ptr(out), nq,
            words.shape[0], super_cum.shape[0], stream_of(out))
    _build.check(lib, rc, "wt_rank")
    lib.wt_rank_route.argtypes = [ctypes.c_int] * 3
    lib.wt_rank_route.restype = ctypes.c_int
    route = ROUTES[lib.wt_rank_route(words.shape[0], super_cum.shape[0], nq)]
    wt_rank.launches += 1
    wt_rank.routes[route] = wt_rank.routes.get(route, 0) + 1
    return out


wt_rank.launches = 0
wt_rank.routes = {}
