from .base import SHAPES, ModelConfig, ShapeSpec
from .registry import ARCHS, get, names

__all__ = ["SHAPES", "ModelConfig", "ShapeSpec", "ARCHS", "get", "names"]
