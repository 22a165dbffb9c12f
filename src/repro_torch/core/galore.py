"""Projection-based memory-efficient Adam variants: GaLore, Fira,
APOLLO(-Mini). The port of ``repro.core.galore``.

These compress Adam's (m, v) states into a rank-``r`` subspace per matrix:

  * GaLore (Zhao et al., 2024): SVD projection refreshed every
    ``update_proj_gap`` steps; Adam runs on the projected gradient; the
    update is projected back.
  * Fira (Chen et al., 2024): GaLore + the full-rank residual re-scaled by
    the low-rank Adam norm ratio.
  * APOLLO (Zhu et al., 2025): *random* projection; the low-rank Adam
    update only estimates channel-wise scaling factors applied to the raw
    full-rank gradient. APOLLO-Mini is the rank-1 / tensor-wise variant.

The whole family is one pipeline composition: hidden matrices take the
:class:`~repro_torch.core.pipeline.Project` stage (the projector tree
lives in ``state.extra["proj"]``), while the first (embedding) and last
(LM head) layers and vector params run full Adam. APOLLO's random
projector comes from a ``torch.Generator`` seeded from (``seed``, the
refresh block, the leaf), so its values are the port's own, not JAX's.
Memory accounting lives in :mod:`.memory`.
"""
from __future__ import annotations

from typing import Optional

from .labels import LabelRules
from .pipeline import ADAM_STAGE, PipeState, Project, Stages, build_pipeline
from .types import GradientTransformation, Schedule

GaloreState = PipeState


def _galore_family(
    lr: Schedule | float,
    rank: int,
    update_proj_gap: int,
    scale_factor: float,
    mode: str,  # "galore" | "fira" | "apollo" | "apollo_mini"
    rules: Optional[LabelRules],
    b1: float,
    b2: float,
    eps: float,
    seed: int,
) -> GradientTransformation:
    spec = Project(mode=mode, rank=rank, update_proj_gap=update_proj_gap,
                   scale_factor=scale_factor, seed=seed)
    # first/last/vector use full Adam (paper §4); only hidden matrices are
    # low-rank
    plans = {"first": ADAM_STAGE, "last": ADAM_STAGE,
             "matrix": Stages(project=spec), "vector": ADAM_STAGE}
    return build_pipeline(plans, lr, b1=b1, b2=b2, eps=eps, rules=rules)


def galore(lr, rank: int = 256, update_proj_gap: int = 200,
           scale_factor: float = 0.25, rules=None, b1=0.9, b2=0.999,
           eps=1e-8, seed=0):
    return _galore_family(lr, rank, update_proj_gap, scale_factor, "galore",
                          rules, b1, b2, eps, seed)


def fira(lr, rank: int = 256, update_proj_gap: int = 200,
         scale_factor: float = 0.25, rules=None, b1=0.9, b2=0.999, eps=1e-8,
         seed=0):
    return _galore_family(lr, rank, update_proj_gap, scale_factor, "fira",
                          rules, b1, b2, eps, seed)


def apollo(lr, rank: int = 256, update_proj_gap: int = 200,
           scale_factor: float = 1.0, rules=None, b1=0.9, b2=0.999,
           eps=1e-8, seed=0):
    return _galore_family(lr, rank, update_proj_gap, scale_factor, "apollo",
                          rules, b1, b2, eps, seed)


def apollo_mini(lr, update_proj_gap: int = 200, scale_factor: float = 1.0,
                rules=None, b1=0.9, b2=0.999, eps=1e-8, seed=0):
    return _galore_family(lr, 1, update_proj_gap, scale_factor,
                          "apollo_mini", rules, b1, b2, eps, seed)
