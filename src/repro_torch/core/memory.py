"""Optimizer-state memory accounting (paper Appendix B / Table 4): a copy
of ``repro.core.memory`` over the port's flat ``{path: shape}`` mappings
(``models.model.param_shapes``; nested dicts, tensors and shape tuples
are accepted too).

Computes weights + optimizer-state bytes analytically from parameter
shapes, following the paper's estimation protocol: bf16 (2 bytes) per
float, counting embedding/attention/MLP/head matrices.

This is the paper's protocol, not what the pipeline allocates, and the
copy keeps the JAX package's numbers as they are:
  * Muon's embedding and head are billed at 1x; the pipeline runs Adam
    there (2x).
  * The GaLore family's low-rank moments are billed as ``r * min(m, n)``
    each; the pipeline stores ``(r, max(m, n))``.
  * APOLLO is billed no projector; the pipeline keeps one in
    ``extra["proj"]``.
Tied embeddings: pass ``rules=LabelRules.tied()`` so the embedding is
billed as the ``last`` group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

from repro_torch.models.model import flatten

from .labels import LabelRules

GB = 1024 ** 3
GB_DEC = 1e9  # the paper's "G" is decimal (0.131B params * 2B = 0.262G)


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    method: str
    weight_bytes: int
    state_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.weight_bytes + self.state_bytes

    def gb(self, decimal: bool = True) -> tuple:
        d = GB_DEC if decimal else GB
        return (self.weight_bytes / d, self.state_bytes / d,
                self.total_bytes / d)


def _shape_of(leaf) -> tuple:
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    return tuple(leaf)


def _size(shape) -> int:
    return int(math.prod(shape)) if shape else 1


def _leaves(shapes) -> dict:
    """{path: shape} of a flat or nested mapping of shapes or tensors."""
    return {k: _shape_of(v) for k, v in flatten(shapes).items()}


def _proj_state_sizes(shape, rank: int, store_projector: bool) -> int:
    """Low-rank (m, v) + optional projector element count for one matrix."""
    m, n = shape[-2], shape[-1]
    lead = _size(shape[:-2])
    r = min(rank, m, n)
    low = r * min(m, n)          # per-state low-rank elements
    proj = min(m, n) * r if store_projector else 0
    return lead * (2 * low + proj)


def optimizer_state_elements(
    shapes: Mapping | Any,
    method: str,
    rank: int = 256,
    rules: LabelRules | None = None,
) -> int:
    """Number of extra optimizer-state elements for ``method``."""
    rules = rules or LabelRules()
    total = 0
    for path, shape in _leaves(shapes).items():
        lab = rules.classify(path, len(shape))
        n = _size(shape)
        if method == "sgd":
            extra = 0
        elif method in ("sgd_momentum",):
            extra = n
        elif method in ("adam", "adamw", "stable_spam"):
            extra = 2 * n
        elif method == "muon":
            # first-order momentum everywhere (paper App. B counts 1x total)
            extra = n if lab != "vector" else 2 * n
        elif method == "swan":
            # Adam on first + last layers; stateless elsewhere
            extra = 2 * n if lab in ("first", "last", "vector") else 0
        elif method == "scale":
            # momentum on last layer only; Adam on vectors (negligible)
            if lab == "last":
                extra = n
            elif lab == "vector":
                extra = 2 * n
            else:
                extra = 0
        elif method in ("galore", "fira"):
            if lab == "matrix":
                extra = _proj_state_sizes(shape, rank, store_projector=True)
            else:
                extra = 2 * n
        elif method == "apollo":
            if lab == "matrix":
                extra = _proj_state_sizes(shape, rank, store_projector=False)
            else:
                extra = 2 * n
        elif method == "apollo_mini":
            if lab == "matrix":
                extra = _proj_state_sizes(shape, 1, store_projector=False)
            else:
                extra = 2 * n
        else:
            raise ValueError(f"unknown method {method!r}")
        total += extra
    return total


def momentum_eligible_elements(
    shapes: Mapping | Any,
    method: str,
    rules: LabelRules | None = None,
) -> int:
    """State elements that ``momentum_dtype="bfloat16"`` would store in bf16:
    the first moment of >=2-D params for adam/adamw, muon and scale's
    LM-head momentum; every other method contributes zero."""
    rules = rules or LabelRules()
    total = 0
    for path, shape in _leaves(shapes).items():
        lab = rules.classify(path, len(shape))
        n = _size(shape)
        if method in ("adam", "adamw") and lab != "vector":
            total += n
        elif method == "muon" and lab != "vector":
            # paper counts muon's non-vector state as 1x = the first moment
            total += n
        elif method == "scale" and lab == "last":
            total += n
    return total


def memory_report(
    shapes, method: str, dtype_bytes: int = 2, rank: int = 256,
    rules: LabelRules | None = None, momentum_dtype: str | None = None,
) -> MemoryReport:
    """Analytic weight/state bytes for ``method`` (paper Appendix B protocol).

    ``momentum_dtype="bfloat16"`` bills the momentum-eligible first-moment
    elements at 2 bytes instead of ``dtype_bytes``: a no-op under the
    paper's 2-byte protocol; pass ``dtype_bytes=4`` for f32-state
    footprints.
    """
    weight_elems = sum(_size(s) for s in _leaves(shapes).values())
    state_elems = optimizer_state_elements(shapes, method, rank=rank,
                                           rules=rules)
    state_bytes = state_elems * dtype_bytes
    if momentum_dtype == "bfloat16":
        mu = momentum_eligible_elements(shapes, method, rules=rules)
        state_bytes += mu * (2 - dtype_bytes)
    elif momentum_dtype not in (None, "float32"):
        raise ValueError(
            f"momentum_dtype must be float32|bfloat16, got {momentum_dtype!r}")
    return MemoryReport(method, weight_elems * dtype_bytes, state_bytes)


METHODS = ("sgd", "sgd_momentum", "adam", "adamw", "stable_spam", "muon",
           "swan", "galore", "fira", "apollo", "apollo_mini", "scale")
