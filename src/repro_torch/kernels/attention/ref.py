"""Plain PyTorch versions of the flash-attention forward and backward.

They materialize the full (B, H, S, T) score matrix, as
``repro.kernels.attention.ref`` does, so they are test-scale references:
the CPU path of ``attention.mha_fwd``, ``mha_bwd_dq`` and ``mha_bwd_dkv``,
and the yardstick the CUDA kernels are held against on the card. Scores
are formed in f32 from the inputs upcast, which is what the kernels
accumulate. Masking is one
:class:`~repro_torch.kernels.attention.mask.MaskSpec` densified through
:func:`~repro_torch.kernels.attention.mask.mask_array`; fully masked rows
give 0 output (and 0 gradient) through the same finite -1e30 stand-in,
1e-30 clamp and select the kernels use, where a naive softmax would give
NaN.
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


def _bwd_parts(q, k, v, dout, lse, delta, kv_len, scale, causal, segments):
    """(p, ds, k, q) of the backward on dense (B, H, S, T) scores, with the
    kv heads repeated to H.

    p = where(valid, exp(s - lse), 0) is a select, so a fully masked row
    (lse about -1e30) gives exactly 0; ds = p * (dp - delta) * scale, also
    0 where masked. Both are f32.
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
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bshd->bhqs", dout.float(), v.float())
    ds = torch.where(valid, p * (dp - delta[..., None]) * scale, 0.0)
    return p, ds, k


def mha_bwd_dq_ref(q, k, v, dout, lse, delta, kv_len=None, *, scale: float,
                   causal: bool, segments=None):
    """dQ (B, S, H, hd) in q's dtype.

    ``lse`` (B, H, S) is the forward's log-sum-exp and ``delta`` (B, H, S)
    f32 is ``sum(f32(dout) * f32(out), -1)``. ds is rounded to k's dtype
    before the product with k; the sum over keys is f32.
    """
    _, ds, k = _bwd_parts(q, k, v, dout, lse, delta, kv_len, scale, causal,
                          segments)
    dq = torch.einsum("bhqs,bshd->bqhd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def mha_bwd_dkv_ref(q, k, v, dout, lse, delta, kv_len=None, *,
                    scale: float, causal: bool, segments=None):
    """(dK, dV) in k's and v's dtypes, in the (B, T, K, hd|hdv) storage
    layout: the G query heads of each kv head are summed (in f32).

    p is rounded to dout's dtype before the dV product, ds to q's dtype
    before the dK product; all sums are f32.
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    p, ds, _ = _bwd_parts(q, k, v, dout, lse, delta, kv_len, scale, causal,
                          segments)
    dv = torch.einsum("bhqs,bqhd->bshd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqs,bqhd->bshd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(B, T, K, H // K, hd).sum(3)
    dv = dv.reshape(B, T, K, H // K, v.shape[3]).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)
