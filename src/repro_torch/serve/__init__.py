from .engine import DecodeParams, Request, ServingEngine, make_serve_steps

__all__ = ["DecodeParams", "Request", "ServingEngine", "make_serve_steps"]
