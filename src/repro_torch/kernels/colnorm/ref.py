"""Plain PyTorch versions of the column/row-norm kernels (kernels 7-9).

Each repeats the arithmetic of its TPU kernel body in
``repro.kernels.colnorm.colnorm`` (and of the CUDA kernel in
``csrc/colnorm.cu``): f32 math on ``gscale * f32(g)``, ``sqrt(ss) + eps``
then a true division, one rounding to the output dtype. They take the
kernels' canonical (L, m, n) operands and the same ``gscale``, ``eps`` and
``out_dtype``; ``update_apply_ref`` writes into theta in place, as the
kernel does. They are the CPU path of the wrappers in ``colnorm.py`` and
the yardstick the CUDA kernels are held against on the card.

``normalize`` is the jnp oracle of ``repro.kernels.colnorm.ref`` (any
2-D or stacked leaf), used by ``dispatch`` off the kernels' coverage.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-8

_RED = {"col": -2, "row": -1}


def canon3(x: torch.Tensor) -> torch.Tensor:
    """Canonicalize to (L, m, n); 2-D inputs get a unit layer axis (a view)."""
    if x.ndim == 2:
        return x[None]
    if x.ndim == 3:
        return x
    raise ValueError(f"fused kernels take 2-D/3-D arrays, got {tuple(x.shape)}")


def check_axis(axis: str) -> None:
    if axis not in _RED:
        raise ValueError(f"axis must be 'col' or 'row', got {axis!r}")


def f32_scalar(x):
    """A scalar operand as the kernels read it: a Python number rounded to
    f32 (still a Python float), or a 0-d/1-element tensor as f32."""
    if torch.is_tensor(x):
        return x.reshape(()).float()
    return float(np.float32(x))


def scaled_f32(g: torch.Tensor, gscale=None) -> torch.Tensor:
    """``gscale * f32(g)``, the kernels' gradient read."""
    gf = g.float()
    return gf if gscale is None else gf * f32_scalar(gscale)


def norm_sumsq_ref(g, axis: str = "col", *, gscale=None) -> torch.Tensor:
    """(L, m, n) -> f32 (L, 1, n) for col, (L, m, 1) for row."""
    check_axis(axis)
    gf = scaled_f32(g, gscale)
    return (gf * gf).sum(dim=_RED[axis] % 3, keepdim=True)


def norm_apply_ref(g, ss, axis: str = "col", *, eps: float = EPS,
                   gscale=None, out_dtype=None) -> torch.Tensor:
    """gscale * g / (sqrt(ss) + eps) in ``out_dtype`` (default g's)."""
    check_axis(axis)
    norm = torch.sqrt(ss) + f32_scalar(eps)
    return (scaled_f32(g, gscale) / norm).to(out_dtype or g.dtype)


def update_apply_ref(theta, g, ss, lr, axis: str = "col", *,
                     eps: float = EPS, gscale=None) -> torch.Tensor:
    """theta - lr * gscale * g / (sqrt(ss) + eps), written into theta."""
    check_axis(axis)
    norm = torch.sqrt(ss) + f32_scalar(eps)
    upd = theta.float() - f32_scalar(lr) * scaled_f32(g, gscale) / norm
    return theta.copy_(upd)


def normalize(g, axis: str = "col", eps: float = EPS, out_dtype=None):
    """g / (||slice||_2 + eps) along the reduce axis, f32 math, in
    ``out_dtype`` (default g's)."""
    gf = g.float()
    norms = torch.sqrt((gf * gf).sum(dim=_RED[axis], keepdim=True))
    return (gf / (norms + f32_scalar(eps))).to(out_dtype or g.dtype)
