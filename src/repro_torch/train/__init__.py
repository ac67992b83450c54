from .trainer import SPAN_GRADS, SPAN_OPTIMIZER, Trainer, TrainState, init_state, make_train_step

__all__ = ["SPAN_GRADS", "SPAN_OPTIMIZER", "Trainer", "TrainState", "init_state",
           "make_train_step"]
