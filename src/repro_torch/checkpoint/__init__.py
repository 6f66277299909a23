"""The port's ``repro.checkpoint``: atomic saves in the reference's
layout, auto-resume, and the elastic ``reshard`` onto a live mesh (with
the sharded save that gathers each tensor whole)."""

from .checkpoint import (latest_step, reshard, restore_checkpoint,
                         save_checkpoint)

__all__ = ["latest_step", "reshard", "restore_checkpoint", "save_checkpoint"]
