from repro_torch.configs.base import ARCHS, ModelConfig, ShapeConfig, get, get_reduced

__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "get", "get_reduced"]
