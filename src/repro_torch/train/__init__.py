"""The port's step builders (``repro.train``): the serving half so far."""

from .step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
