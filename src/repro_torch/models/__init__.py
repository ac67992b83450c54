from .zoo import Model, build_model

__all__ = ["Model", "build_model"]
