from .optimizers import (Leaf, Optimizer, adafactor, adamw, clip_by_global_norm, cosine_schedule,
                         global_norm, make_optimizer)

__all__ = ["Leaf", "Optimizer", "adamw", "adafactor", "clip_by_global_norm", "cosine_schedule",
           "global_norm", "make_optimizer"]
