"""Gradient compression for cross-pod gradient reduction: the port of
``repro.core.compression``.

Column-wise symmetric int8 quantization composes exactly with SCALE:
colnorm(g) is invariant to any positive per-column rescaling, so the
per-column quantization scale cancels in SCALE's update; the only error
is the 8-bit rounding within a column (relative error at most 1/254 of
the column's largest element). For Adam-family optimizers the scale does
not cancel. Trees are the port's flat ``{path: tensor}`` mappings.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.model import flatten

from .types import GradientTransformation

_I8_MAX = 127.0


class CompressedLeaf(NamedTuple):
    q: torch.Tensor      # int8 payload
    scale: torch.Tensor  # per-column f32 scale (1, ..., d_out)


def compress_leaf(g: torch.Tensor) -> CompressedLeaf:
    """Column-wise symmetric int8 quantization (matrices; reduction axis
    -2). ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gf = g.to(torch.float32)
    if g.ndim >= 2:
        amax = torch.amax(gf.abs(), dim=-2, keepdim=True)
    else:
        amax = torch.amax(gf.abs(), dim=tuple(range(g.ndim)), keepdim=True)
    scale = torch.clamp_min(amax, 1e-30) / _I8_MAX
    q = torch.clamp(torch.round(gf / scale), -_I8_MAX, _I8_MAX).to(
        torch.int8)
    return CompressedLeaf(q, scale)


def decompress_leaf(c: CompressedLeaf, dtype) -> torch.Tensor:
    return (c.q.to(torch.float32) * c.scale).to(dtype)


def compress(grads) -> dict:
    return {k: compress_leaf(g) for k, g in flatten(grads).items()}


def decompress(comp: dict, like) -> dict:
    return {k: decompress_leaf(comp[k], g.dtype)
            for k, g in flatten(like).items()}


def compressed(tx: GradientTransformation) -> GradientTransformation:
    """Wrap an optimizer so it sees int8-roundtripped gradients — exactly
    what arrives after a compressed cross-pod reduction."""

    def update(grads, state, params=None):
        rt = decompress(compress(grads), grads)
        return tx.update(rt, state, params)

    return GradientTransformation(tx.init, update)


def compression_ratio(grads) -> float:
    """Wire-bytes ratio achieved by int8 + per-column f32 scales."""
    orig = comp = 0
    for g in flatten(grads).values():
        n = g.numel()
        cols = n // g.shape[-2] if g.ndim >= 2 else 1
        orig += n * g.element_size()
        comp += n * 1 + cols * 4
    return orig / max(comp, 1)
