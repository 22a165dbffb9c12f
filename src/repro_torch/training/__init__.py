from .serving import (ServeState, greedy_generate, make_decode_step,
                      make_prefill_step)
from .trainer import make_eval_step

__all__ = ["ServeState", "greedy_generate", "make_decode_step",
           "make_eval_step", "make_prefill_step"]
