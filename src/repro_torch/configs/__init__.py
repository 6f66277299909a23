from .base import SHAPES, ModelConfig, ShapeSpec, reduced
from .registry import ARCH_IDS, ARCHS, LONG_CONTEXT_ARCHS, get_config, shape_applicable

__all__ = [
    "SHAPES", "ModelConfig", "ShapeSpec", "reduced",
    "ARCH_IDS", "ARCHS", "LONG_CONTEXT_ARCHS", "get_config", "shape_applicable",
]
