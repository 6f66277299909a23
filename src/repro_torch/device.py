"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` (str or ``torch.device``) -> ``torch.device``.

    A CUDA device is never silently replaced by the CPU: asking for
    ``"cuda"`` where no CUDA device is present raises.  Only ``"cpu"`` and
    ``"cuda[:i]"`` are supported.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} requested but no CUDA device is "
                "available; pass device='cpu' to run the plain torch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} "
                         "(options: cuda, cpu)")
    return dev
