from repro_torch.models.api import Model, build

__all__ = ["Model", "build"]
