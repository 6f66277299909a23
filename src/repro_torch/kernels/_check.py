"""Argument checks shared by the CUDA kernel wrappers."""

from __future__ import annotations

import ctypes

import torch

__all__ = ["cuda_args", "stream_of", "ptr"]


def cuda_args(name: str, *tensors: torch.Tensor) -> None:
    """All tensors CUDA, contiguous and on one device; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: kernel takes CUDA tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
