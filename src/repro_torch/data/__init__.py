from .pipeline import DataConfig, SyntheticLM, make_batch

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]
