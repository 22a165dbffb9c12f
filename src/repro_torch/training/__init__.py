from .serving import (ServeState, greedy_generate, make_decode_step,
                      make_prefill_step)
from .trainer import (TrainState, init_state, make_eval_step,
                      make_train_step, value_and_grad)

__all__ = ["ServeState", "TrainState", "greedy_generate", "init_state",
           "make_decode_step", "make_eval_step", "make_prefill_step",
           "make_train_step", "value_and_grad"]
