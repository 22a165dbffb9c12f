"""Plain PyTorch version of the fused momentum kernel (kernel 10).

``momentum_sumsq_ref`` repeats the arithmetic of the TPU kernel body in
``repro.kernels.scale_head.scale_head`` (and of ``csrc/momentum_sumsq.cu``)
on canonical (L, m, n) operands: beta read as f32 and ``1 - beta`` formed
in f32, ``m' = beta * f32(m) + (1 - beta) * (gscale * f32(g))``, m' stored
into m in m's dtype (in place), and the sum of squares of the *pre-cast*
f32 m' along the reduce axis. It is the CPU path of
``scale_head.momentum_sumsq`` and the yardstick of the CUDA kernel on the
card.
"""
from __future__ import annotations

import torch

from ..colnorm.ref import _RED, check_axis, f32_scalar, scaled_f32


def one_minus(beta):
    """1 - beta in f32, for beta as ``f32_scalar`` returns it."""
    if torch.is_tensor(beta):
        return 1.0 - beta
    return float(torch.tensor(1.0) - torch.tensor(beta))


def momentum_sumsq_ref(m, g, beta, axis: str = "col", *, gscale=None):
    """(m', ss): m' written into m (returned), ss f32 (L, 1, n) | (L, m, 1)."""
    check_axis(axis)
    b = f32_scalar(beta)
    m_new = b * m.float() + one_minus(b) * scaled_f32(g, gscale)
    m.copy_(m_new)
    return m, (m_new * m_new).sum(dim=_RED[axis] % 3, keepdim=True)
