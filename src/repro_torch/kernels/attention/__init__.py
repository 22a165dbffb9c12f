from .attention import mha_fwd
from .ref import mha_fwd_ref

__all__ = ["mha_fwd", "mha_fwd_ref"]
