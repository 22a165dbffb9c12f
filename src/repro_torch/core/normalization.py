"""Gradient normalization schemes from the paper, eq. (6).

A copy of ``repro.core.normalization``. Matrices are stored (d_in, d_out)
(``y = x @ W``); a *column* ``G[:, j]`` belongs to output unit j, so
column-wise normalization reduces over ``axis=-2``; stacked
(L, d_in, d_out) leaves normalize per leading slice. Math is f32, as in
the JAX package: for col/row the sum of squares in f32, the reciprocal
norm cast to g's dtype, then one multiply; the Newton-Schulz and SVD kinds
work on an f32 copy and round once to g's dtype at the end.

The f32 products stay at full precision: torch keeps TF32 off by default
and nothing in this package turns it on (the JAX package's NS runs in f32
too).
"""
from __future__ import annotations

import torch

_EPS = 1e-8

# Quintic Newton-Schulz coefficients from Muon (Jordan et al., 2024).
_NS_COEFFS = (3.4445, -4.7750, 2.0315)
_NS_STEPS = 5


def _inv_norm(g: torch.Tensor, dim: int, eps: float) -> torch.Tensor:
    gf = g.to(torch.float32)
    ss = torch.sum(torch.square(gf), dim=dim, keepdim=True)
    return (1.0 / (torch.sqrt(ss) + eps)).to(g.dtype)


def colnorm(g: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """``out[:, j] = g[:, j] / ||g[:, j]||_2``; reduction over ``axis=-2``."""
    if g.ndim < 2:
        raise ValueError(f"colnorm expects a matrix, got shape {tuple(g.shape)}")
    return g * _inv_norm(g, -2, eps)


def rownorm(g: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Row-wise normalization: normalize along the input dimension."""
    if g.ndim < 2:
        raise ValueError(f"rownorm expects a matrix, got shape {tuple(g.shape)}")
    return g * _inv_norm(g, -1, eps)


def signnorm(g: torch.Tensor) -> torch.Tensor:
    """Sign normalization (sign-SGD direction)."""
    return torch.sign(g).to(g.dtype)


def _ns_iteration_2d(g: torch.Tensor, steps: int) -> torch.Tensor:
    """Newton-Schulz orthogonalization of an (m, n) matrix, m <= n, or of
    each slice of a stack (..., m, n): one batched matmul per product, and
    each slice scaled by its own Frobenius norm, as the JAX package's
    ``vmap`` over slices gives."""
    a, b, c = _NS_COEFFS
    x = g / (torch.linalg.vector_norm(g, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        xxt = x @ x.mT
        bxc = b * xxt + c * (xxt @ xxt)
        x = a * x + bxc @ x
    return x


def ns_orthogonalize(g: torch.Tensor, steps: int = _NS_STEPS) -> torch.Tensor:
    """Inexact singular-value normalization ``U V^T`` via Newton-Schulz
    (Muon's quintic iteration), in f32; stacked (..., m, n) leaves per
    slice."""
    if g.ndim < 2:
        raise ValueError(f"ns_orthogonalize expects a matrix, got "
                         f"{tuple(g.shape)}")
    gf = g.to(torch.float32)
    transpose = gf.shape[-2] > gf.shape[-1]
    if transpose:
        gf = gf.mT
    out = _ns_iteration_2d(gf, steps)
    if transpose:
        out = out.mT
    return out.to(g.dtype)


def svd_orthogonalize(g: torch.Tensor) -> torch.Tensor:
    """Exact singular-value normalization ``U V^T`` (reference / Table 1).

    ``torch.linalg.svd`` on a CUDA tensor checks its solver's status on the
    host, so this kind synchronises once per leaf (``sgd_svdnorm``)."""
    u, _, vt = torch.linalg.svd(g.to(torch.float32), full_matrices=False)
    return (u @ vt).to(g.dtype)


NORMALIZATIONS = {
    "col": colnorm,
    "row": rownorm,
    "sign": signnorm,
    "ns": ns_orthogonalize,
    "svd": svd_orthogonalize,
    "none": lambda g: g,
}


def resolve_larger(kind: str, shape) -> str:
    """Resolve the ``larger`` kind (Table 13 row 4: normalize along the
    larger trailing dim; ties break to ``col``) to col/row by shape.

    The one source of the tie-break for both impls and the kernel dispatch.
    """
    if kind == "larger":
        if len(shape) < 2:
            raise ValueError(f"norm kind 'larger' needs a matrix, got {tuple(shape)}")
        return "col" if shape[-2] >= shape[-1] else "row"
    return kind


_FLIPPED = {"col": "row", "row": "col"}


def flip_kind(kind: str) -> str:
    """col/row kind for a matrix stored transposed ((d_out, d_in)), as a
    tied LM head in the embedding's (V, D) layout; other kinds are
    invariant."""
    return _FLIPPED.get(kind, kind)


def normalize(g: torch.Tensor, kind: str) -> torch.Tensor:
    try:
        fn = NORMALIZATIONS[kind]
    except KeyError:
        raise ValueError(f"unknown normalization {kind!r}; options "
                         f"{list(NORMALIZATIONS)}") from None
    return fn(g)
