"""The port's ``repro.checkpoint``: atomic saves in the reference's
layout, auto-resume (the elastic ``reshard`` comes with the distributed
slice)."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
