from .serving import (ServeState, greedy_generate, make_decode_step,
                      make_prefill_step)

__all__ = ["ServeState", "greedy_generate", "make_decode_step",
           "make_prefill_step"]
