"""Synthetic datasets and the token pipeline (numpy, seeded) — copies of
the reference's ``repro.data``."""

from .pipeline import TokenPipeline
from .synthetic import PRESETS, make_dataset, make_tokens

__all__ = ["PRESETS", "TokenPipeline", "make_dataset", "make_tokens"]
