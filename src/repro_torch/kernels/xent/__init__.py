from .ref import xent_bwd_dh_ref, xent_bwd_dw_ref, xent_fwd_ref
from .xent import xent_bwd_dh, xent_bwd_dw, xent_fwd

__all__ = ["xent_fwd", "xent_bwd_dh", "xent_bwd_dw", "xent_fwd_ref",
           "xent_bwd_dh_ref", "xent_bwd_dw_ref"]
