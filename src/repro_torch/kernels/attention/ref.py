"""Plain PyTorch version of the flash-attention forward.

It materializes the full (B, H, S, T) score matrix, as
``repro.kernels.attention.ref`` does, so it is a test-scale reference: the
CPU path of ``attention.mha_fwd`` and the yardstick the CUDA kernel is
held against on the card. Scores are formed in f32 from the inputs
upcast, which is what the kernel accumulates. Masking is one
:class:`~repro_torch.kernels.attention.mask.MaskSpec` densified through
:func:`~repro_torch.kernels.attention.mask.mask_array`; fully masked rows
give 0 output through the same finite -1e30 stand-in and 1e-30 clamp the
kernels use, where a naive softmax would give NaN.
"""
from __future__ import annotations

import torch

from .mask import mask_array, mask_spec

NEG = -1e30


def mha_fwd_ref(q, k, v, kv_len=None, *, scale: float, causal: bool,
                segments=None):
    """(out, lse): q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv).

    H % K == 0; kv heads are repeated to the query head count here (the
    kernel indexes them as ``q_head // group``). Returns out (B, S, H, hdv)
    in q's dtype and lse (B, H, S) f32.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if K != H:
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * scale
    spec = mask_spec(S, T, causal=causal, kv_len=kv_len, segments=segments)
    valid = mask_array(spec, S, T, kv_len=kv_len, segments=segments,
                       device=q.device)[:, None]  # (1|B, 1, S, T)
    s = torch.where(valid, s, NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqs,bshd->bqhd", (p / l).to(v.dtype), v)
    lse = (m + torch.log(l))[..., 0]
    return out.to(q.dtype), lse
