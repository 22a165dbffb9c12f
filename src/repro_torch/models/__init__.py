from .config import ModelConfig
from .model import (Params, forward, head_weight, init_cache, init_params,
                    lm_loss, logits_from_hidden, loss_fn, model_spec,
                    param_shapes)
from .weights import (load_flat, load_opt_state, opt_state_to_flat,
                      to_flat)

__all__ = ["ModelConfig", "Params", "forward", "head_weight", "init_cache",
           "init_params", "lm_loss", "logits_from_hidden", "loss_fn",
           "model_spec", "param_shapes",
           "load_flat", "load_opt_state", "opt_state_to_flat", "to_flat"]
