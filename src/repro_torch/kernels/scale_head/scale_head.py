"""Fused momentum kernel of the SCALE LM-head update: the wrapper around
the Hopper CUDA kernel in ``csrc/momentum_sumsq.cu``.

It replaces the TPU kernel ``repro.kernels.scale_head.scale_head
.momentum_sumsq`` and takes the same canonical (L, m, n) operands. CPU
tensors go to the plain version in ``ref.py``, CUDA tensors to the kernel,
with no fallback. ``momentum_sumsq.launches`` counts calls that launched
the kernel (one per call, though a split reduction is two CUDA launches).
The head's apply step, ``head_update_apply``, is the colnorm
``update_apply`` kernel with no gscale, as on the TPU.
"""
from __future__ import annotations

import ctypes

import torch

from ..colnorm.colnorm import (_DTYPES, check_distinct, check_operands,
                               launch, scalar_arg, split_plan, update_apply)
from ..colnorm.ref import EPS, check_axis
from .ref import momentum_sumsq_ref

__all__ = ["momentum_sumsq", "head_update_apply"]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.momentum_sumsq.argtypes is None:
        p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
        lib.momentum_sumsq.argtypes = [p, i, i64, i64, i64, p, i, i64, i64,
                                       i64, i, i, i, i, p, f, p, f, p, p, i,
                                       i, p]
        lib.momentum_sumsq.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def momentum_sumsq(m, g, beta, axis: str = "col", *, gscale=None):
    """(m', ss): m' = beta*m + (1-beta)*gscale*g, ss = sumsq(m') along axis.

    m, g (L, mm, n). m' is written into m in **m's dtype** (the momentum
    storage dtype) and m is returned; ss is f32 (L, 1, n) for col and
    (L, mm, 1) for row, summed from the f32 m' before its rounding.
    ``beta`` and ``gscale`` are Python numbers or 1-element f32 tensors on
    the operands' device.
    """
    check_axis(axis)
    dev = check_operands("momentum_sumsq", m, g)
    L, mm, n = m.shape
    if tuple(g.shape) != (L, mm, n):
        raise ValueError(f"momentum_sumsq: m {tuple(m.shape)} and g "
                         f"{tuple(g.shape)} differ")
    if dev.type == "cpu":
        return momentum_sumsq_ref(m, g, beta, axis, gscale=gscale)
    check_distinct("momentum_sumsq", m, g)
    S, chunk = split_plan(axis, L, mm, n)
    ss = torch.empty((L, 1, n) if axis == "col" else (L, mm, 1),
                     dtype=torch.float32, device=dev)
    part = ss if S == 1 else torch.empty(
        (L, S, n if axis == "col" else mm), dtype=torch.float32, device=dev)
    b_p, b_v = scalar_arg(beta, "beta", dev)
    gs_p, gs_v = scalar_arg(1.0 if gscale is None else gscale, "gscale", dev)
    launch("momentum_sumsq", _bind, "momentum_sumsq", dev, m.data_ptr(),
           _DTYPES[m.dtype], *m.stride(), g.data_ptr(), _DTYPES[g.dtype],
           *g.stride(), L, mm, n, int(axis == "row"), b_p, b_v, gs_p, gs_v,
           part.data_ptr(), ss.data_ptr(), S, chunk)
    momentum_sumsq.launches += 1
    return m, ss


def head_update_apply(theta, m_new, ss, lr, axis: str = "col",
                      eps: float = EPS):
    """theta - lr * m'/(sqrt(ss)+eps), written into theta: the colnorm
    ``update_apply`` kernel with no gscale (the clip factor entered through
    the momentum EMA)."""
    return update_apply(theta, m_new, ss, lr, axis, eps=eps)


momentum_sumsq.launches = 0
