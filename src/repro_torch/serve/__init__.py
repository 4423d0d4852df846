from repro_torch.serve.engine import ServeEngine

__all__ = ["ServeEngine"]
