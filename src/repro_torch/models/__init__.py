from repro_torch.models.api import Model, build
from repro_torch.models.transformer import ModelOpts

__all__ = ["Model", "ModelOpts", "build"]
