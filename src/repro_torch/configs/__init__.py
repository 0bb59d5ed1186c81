from .base import (MeshConfig, ModelConfig, ShapeConfig, SHAPES, TrainConfig,
                   shape_applicable)
from .registry import ARCHS, get, smoke

__all__ = ["MeshConfig", "ModelConfig", "ShapeConfig", "SHAPES",
           "TrainConfig", "shape_applicable", "ARCHS", "get", "smoke"]
