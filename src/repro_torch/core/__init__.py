"""repro_torch.core — the paper's contribution, SCALE, and the baseline
optimizers, on PyTorch."""
from .api import (OPTIMIZER_NAMES, OPTIMIZER_REGISTRY, OptimizerSpec,
                  make_optimizer)
from .compression import (compress, compressed, compression_ratio,
                          decompress)
from .galore import apollo, apollo_mini, fira, galore
from .labels import LabelRules, label_tree, transposed_tree
from .memory import (METHODS, MemoryReport, memory_report,
                     momentum_eligible_elements, optimizer_state_elements)
from .normalization import (NORMALIZATIONS, colnorm, flip_kind, normalize,
                            ns_orthogonalize, resolve_larger, rownorm,
                            signnorm, svd_orthogonalize)
from .optimizers import (adam, adams, muon, normalized_sgd, sgd,
                         stable_spam_adam)
from .pipeline import (ADAM_LR_STAGE, ADAM_STAGE, PipeState, Project,
                       Stages, build_pipeline, muon_lr_scale)
from .scale import ScaleState, scale
from .schedules import constant, linear_warmup_cosine
from .swan import swan, swan_normalize
from .types import GradientTransformation, apply_updates, global_norm

__all__ = [
    "OPTIMIZER_NAMES", "OPTIMIZER_REGISTRY", "OptimizerSpec",
    "make_optimizer", "compress", "compressed", "compression_ratio",
    "decompress", "apollo", "apollo_mini", "fira", "galore", "LabelRules",
    "label_tree", "transposed_tree", "METHODS", "MemoryReport",
    "memory_report", "momentum_eligible_elements",
    "optimizer_state_elements", "NORMALIZATIONS", "colnorm", "flip_kind",
    "normalize", "ns_orthogonalize", "resolve_larger", "rownorm",
    "signnorm", "svd_orthogonalize", "adam", "adams", "muon",
    "normalized_sgd", "sgd", "stable_spam_adam", "ADAM_LR_STAGE",
    "ADAM_STAGE", "PipeState", "Project", "Stages", "build_pipeline",
    "muon_lr_scale", "ScaleState", "scale", "constant",
    "linear_warmup_cosine", "swan", "swan_normalize",
    "GradientTransformation", "apply_updates", "global_norm",
]
