from repro_torch.configs.base import (
    ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get,
    get_reduced,
    shape_applicable,
)

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get", "get_reduced",
           "shape_applicable"]
