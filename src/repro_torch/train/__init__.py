"""The port's ``repro.train``: the train, prefill and serve step builders
and AdamW."""

from .optim import AdamWConfig, OptState, apply_updates, init_opt, lr_at
from .step import loss_fn, make_prefill_step, make_serve_step, make_train_step

__all__ = ["AdamWConfig", "OptState", "apply_updates", "init_opt", "loss_fn",
           "lr_at", "make_prefill_step", "make_serve_step", "make_train_step"]
