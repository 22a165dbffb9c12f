"""Kernel entry points for the model code.

Forward-only attention in this slice. Routing is by the tensors' device
alone: the wrapper runs the plain version on the CPU and the CUDA kernel on
the card. Unlike ``repro.kernels.dispatch`` there is no ``REPRO_FUSED``
switch and no guarded fallback: a kernel that fails on the card raises
instead of quietly becoming the reference.
"""
from __future__ import annotations

from .attention.attention import mha_fwd


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None):
    """Blockwise (flash) attention; see ``attention.mha_fwd``.

    q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv) with H % K == 0 —
    the GQA repeat is never materialized. ``kv_len`` bounds the key
    positions for decode over a partially filled cache and needs
    ``causal=False`` (the kernel implements no causal-over-fill mask).
    Returns (B, S, H, hdv) in q's dtype.
    """
    return mha_fwd(q, k, v, kv_len, scale=scale, causal=causal)[0]
