"""Synthetic datasets (numpy, seeded) — copies of the reference presets."""

from .synthetic import PRESETS, make_dataset

__all__ = ["PRESETS", "make_dataset"]
