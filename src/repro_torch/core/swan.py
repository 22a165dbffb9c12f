"""SWAN (Ma et al., 2025): stateless SGD with GradNorm + GradWhitening.

The port of ``repro.core.swan``. Hidden matrices: (1) GradNorm — row-wise
standardization (zero mean / unit variance along the input dimension);
(2) GradWhitening — (GG^T)^{-1/2} G, approximated with the Newton-Schulz
iteration Muon uses. As a pipeline composition that is
``Stages(standardize=True, norm="ns")`` on the matrix group. First/last
layers and vector params run full Adam.
"""
from __future__ import annotations

from typing import Optional

import torch

from .labels import LabelRules
from .normalization import ns_orthogonalize
from .pipeline import ADAM_LR_STAGE, PipeState, Stages, build_pipeline
from .types import GradientTransformation, Schedule

SwanState = PipeState


def swan_normalize(g: torch.Tensor, ns_steps: int = 5) -> torch.Tensor:
    """GradNorm (row standardize) + GradWhitening (NS orthogonalization)."""
    gf = g.to(torch.float32)
    mean = torch.mean(gf, dim=-1, keepdim=True)
    # jnp.std is the population deviation: correction=0 (torch.std divides
    # by n - 1 by default)
    std = torch.std(gf, dim=-1, keepdim=True, correction=0)
    gn = (gf - mean) / (std + 1e-8)
    return ns_orthogonalize(gn, ns_steps).to(g.dtype)


def swan(
    lr: Schedule | float,
    ns_steps: int = 5,
    adam_lr: Schedule | float | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    rules: Optional[LabelRules] = None,
) -> GradientTransformation:
    matrix_st = Stages(standardize=True, norm="ns", ns_steps=ns_steps)
    plans = {"first": ADAM_LR_STAGE, "last": ADAM_LR_STAGE,
             "matrix": matrix_st, "vector": ADAM_LR_STAGE}
    return build_pipeline(plans, lr, adam_lr, b1=b1, b2=b2, eps=eps,
                          rules=rules)
