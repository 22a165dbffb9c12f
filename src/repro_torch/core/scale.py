"""SCALE — Stochastic Column-normalized Last-layer momentum (Algorithm 1).

A port of ``repro.core.scale``. Per parameter group:
  * last layer (LM head):   m <- beta*m + (1-beta)*g ;  delta = -lr * colnorm(m)
  * other matrices:         delta = -lr * colnorm(g)           (stateless)
  * vector params:          Adam (negligible memory; Appendix C)

SCALE is a stage composition over the pipeline (:mod:`.pipeline`), which
owns the kernel lowering, the two entry points and the state layout.

Implementations (``impl``):
  * ``"jnp"`` (the default) — the plain per-leaf maths of the JAX
    package's jnp route, in PyTorch on any device.
  * ``"fused"`` — matrix updates go through
    :mod:`repro_torch.kernels.dispatch`: the hand-written CUDA kernels on
    CUDA tensors, their plain versions (the same arithmetic) on CPU
    tensors, as the JAX fused route runs its kernels in interpret mode
    off the TPU. Coverage: 2-D and stacked 3-D leaves, col/row/larger.
    ``update_params`` costs a stateless matrix 4 passes (g for the sums of
    squares; theta, g and theta' in the apply) and the momentum matrix 6,
    per shard on a mesh: it takes the ``shardings`` / ``grad_scale``
    keywords the trainer hands it (see the pipeline module).

``momentum_dtype="bfloat16"`` stores the momentum in bf16
(cast-on-read/write: the EMA and its sums of squares in f32). The impls
then differ by bf16 rounding, as in JAX: the jnp route normalizes the
pre-cast f32 EMA, the kernels' apply reads the stored momentum.
"""
from __future__ import annotations

from typing import Optional, Sequence

from .labels import LabelRules
from .pipeline import ADAM_LR_STAGE, PipeState, Stages, build_pipeline
from .types import GradientTransformation, Schedule

ScaleState = PipeState


def _norm_kind_for(label: str, norm_last: str, norm_first: str,
                   norm_rest: str) -> str:
    if label == "last":
        return norm_last
    if label == "first":
        return norm_first
    return norm_rest


def scale(
    lr: Schedule | float,
    beta: float = 0.9,
    momentum_on: Sequence[str] = ("last",),
    norm_last: str = "col",
    norm_first: str = None,
    norm_rest: str = "col",
    adam_lr: Schedule | float | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    rules: Optional[LabelRules] = None,
    lr_scaling: bool = False,
    impl: str = "jnp",
    momentum_dtype: str = "float32",
) -> GradientTransformation:
    """Build the SCALE optimizer (paper Algorithm 1).

    ``lr_scaling=True`` enables the Muon-style per-matrix lr scale the paper
    uses for its 1B run (Appendix C). For a ``tie_embeddings=True`` model
    pass ``rules=LabelRules.tied()``: the token embedding is then the
    momentum group, and its col/row kind is flipped for the (V, D) storage.
    """
    norm_first = norm_first if norm_first is not None else norm_rest
    momentum_on = tuple(momentum_on)

    def plan(lab):
        # vectors take Adam even when "vector" is listed in momentum_on
        if lab == "vector":
            return ADAM_LR_STAGE
        kind = _norm_kind_for(lab, norm_last, norm_first, norm_rest)
        return Stages(momentum=beta if lab in momentum_on else 0.0,
                      norm=kind, flip_transposed=True,
                      lr_scaling=lr_scaling)

    plans = {lab: plan(lab) for lab in ("first", "last", "matrix", "vector")}
    return build_pipeline(plans, lr, adam_lr, b1=b1, b2=b2, eps=eps,
                          rules=rules, require_last=True, impl=impl,
                          momentum_dtype=momentum_dtype)
