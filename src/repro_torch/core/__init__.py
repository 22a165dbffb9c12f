"""repro_torch.core — the paper's contribution, SCALE, on PyTorch."""
from .api import (OPTIMIZER_NAMES, OPTIMIZER_REGISTRY, OptimizerSpec,
                  make_optimizer)
from .labels import LabelRules, label_tree, transposed_tree
from .normalization import (NORMALIZATIONS, colnorm, flip_kind, normalize,
                            resolve_larger, rownorm)
from .pipeline import (ADAM_LR_STAGE, PipeState, Stages, build_pipeline,
                       muon_lr_scale)
from .scale import ScaleState, scale
from .schedules import constant, linear_warmup_cosine
from .types import GradientTransformation, apply_updates, global_norm

__all__ = [
    "OPTIMIZER_NAMES", "OPTIMIZER_REGISTRY", "OptimizerSpec",
    "make_optimizer", "LabelRules", "label_tree", "transposed_tree",
    "NORMALIZATIONS", "colnorm", "flip_kind", "normalize", "resolve_larger",
    "rownorm", "ADAM_LR_STAGE", "PipeState", "Stages",
    "build_pipeline", "muon_lr_scale", "ScaleState", "scale", "constant",
    "linear_warmup_cosine", "GradientTransformation", "apply_updates",
    "global_norm",
]
