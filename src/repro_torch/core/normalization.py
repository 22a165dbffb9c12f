"""Gradient normalization schemes from the paper, eq. (6).

A copy of the col/row part of ``repro.core.normalization``. Matrices are
stored (d_in, d_out) (``y = x @ W``); a *column* ``G[:, j]`` belongs to
output unit j, so column-wise normalization reduces over ``axis=-2``;
stacked (L, d_in, d_out) leaves normalize per leading slice. Math is f32,
as in the JAX package: the sum of squares in f32, the reciprocal norm cast
to g's dtype, then one multiply. The sign, ns and svd kinds come with the
rest of the optimizer zoo (ROADMAP Queue 1 item 8) and raise until then.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


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


def _not_ported(kind: str):
    def f(g):
        raise ValueError(f"normalization {kind!r} is not ported to "
                         "repro_torch yet (ROADMAP Queue 1 item 8, the rest "
                         "of the optimizer zoo); ported: col, row, larger, "
                         "none")
    return f


NORMALIZATIONS = {
    "col": colnorm,
    "row": rownorm,
    "sign": _not_ported("sign"),
    "ns": _not_ported("ns"),
    "svd": _not_ported("svd"),
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
