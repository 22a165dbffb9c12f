from .colnorm import canon3, norm_apply, norm_sumsq, update_apply
from .ref import norm_apply_ref, norm_sumsq_ref, update_apply_ref

__all__ = ["canon3", "norm_apply", "norm_sumsq", "update_apply",
           "norm_apply_ref", "norm_sumsq_ref", "update_apply_ref"]
