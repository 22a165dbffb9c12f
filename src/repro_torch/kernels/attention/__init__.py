from .attention import mha_bwd_dkv, mha_bwd_dq, mha_fwd
from .ref import mha_bwd_dkv_ref, mha_bwd_dq_ref, mha_fwd_ref

__all__ = ["mha_bwd_dkv", "mha_bwd_dkv_ref", "mha_bwd_dq", "mha_bwd_dq_ref",
           "mha_fwd", "mha_fwd_ref"]
