from .ref import momentum_sumsq_ref
from .scale_head import head_update_apply, momentum_sumsq

__all__ = ["head_update_apply", "momentum_sumsq", "momentum_sumsq_ref"]
