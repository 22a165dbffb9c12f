"""Baseline optimizers (paper §4): SGD(±M), Adam(W), AdamS, Stable-SPAM,
Muon, and SGD with a chosen gradient normalization (Table 2 ablations).

The port of ``repro.core.optimizers``, with its signatures and defaults.
Every optimizer here is a thin stage composition over the shared
leaf-update pipeline (:mod:`.pipeline`), which owns both entry points, the
kernel lowering and the state layout. Per the paper (Appendix C) every
memory-efficient method applies Adam to <=1-D "vector" parameters, whose
size is negligible.
"""
from __future__ import annotations

from typing import Optional

import torch

from .labels import LabelRules
from .pipeline import ADAM_LR_STAGE, PipeState, Stages, build_pipeline
from .types import GradientTransformation, Schedule, global_norm

_f32 = torch.float32

# every pipeline optimizer shares one state layout
AdamState = SgdState = NormSgdState = MuonState = PipeState

_ALL = ("first", "last", "matrix", "vector")


def adam(
    lr: Schedule | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum_dtype: str = "float32",
) -> GradientTransformation:
    """Adam / AdamW (decoupled weight decay if ``weight_decay > 0``).

    ``momentum_dtype="bfloat16"`` stores the first moment of >=2-D params in
    bf16 (cast-on-read/write; vector moments and the second moment stay f32).
    """
    st = Stages(adam=True, weight_decay=weight_decay)
    return build_pipeline({lab: st for lab in _ALL}, lr, b1=b1, b2=b2,
                          eps=eps, momentum_dtype=momentum_dtype)


def adams(
    lr: Schedule | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    momentum_dtype: str = "float32",
) -> GradientTransformation:
    """AdamS (Huang et al., 2025): momentum itself as the normalizer.

    Adam's second-moment buffer is dropped; the denominator is made per
    step as ``sqrt(b2 * m_hat^2 + (1 - b2) * g^2)``, so the state is
    SGDM-sized (first moment only) while step sizes stay Adam-like.
    ``weight_decay`` is decoupled, as in AdamW; ``momentum_dtype=
    "bfloat16"`` stores the >=2-D first moment in bf16.
    """
    st = Stages(adams=True, weight_decay=weight_decay)
    return build_pipeline({lab: st for lab in _ALL}, lr, b1=b1, b2=b2,
                          eps=eps, momentum_dtype=momentum_dtype)


def sgd(
    lr: Schedule | float,
    momentum: float = 0.0,
    nesterov: bool = False,
) -> GradientTransformation:
    """Vanilla SGD, optional heavy-ball momentum (paper eq. (2)/(7))."""
    st = Stages(momentum=momentum, nesterov=nesterov)
    return build_pipeline({lab: st for lab in _ALL}, lr)


def normalized_sgd(
    lr: Schedule | float,
    kind: str = "col",
    rules: Optional[LabelRules] = None,
    adam_lr: Schedule | float | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    impl: str = "jnp",
    momentum_dtype: str = "float32",
) -> GradientTransformation:
    """SGD + gradient normalization on all matrix params (Table 2 rows).

    ``kind`` in {col,row,sign,ns,svd}. Vector params use Adam (Appendix C).
    ``impl="fused"`` lowers the col/row kinds to the ``norm_sumsq`` +
    ``update_apply`` kernels (write) or ``norm_sumsq`` + ``norm_apply``
    (delta); sign/ns/svd stay on the plain path. ``momentum_dtype`` is
    accepted for zoo uniformity (no >=2-D first moment here).
    """
    norm_st = Stages(norm=kind)
    plans = {"first": norm_st, "last": norm_st, "matrix": norm_st,
             "vector": ADAM_LR_STAGE}
    return build_pipeline(plans, lr, adam_lr, b1=b1, b2=b2, eps=eps,
                          rules=rules, impl=impl,
                          momentum_dtype=momentum_dtype)


def stable_spam_adam(
    lr: Schedule | float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    gamma1: float = 0.7,
    gamma2: float = 0.9,
    theta: float = 0.999,
    reset_interval: int = 1000,
) -> GradientTransformation:
    """Adam (Stable-SPAM): adaptive norm/spike clipping + momentum reset.

    Follows Huang et al. (2025): AdaClip clips per-element spikes above the
    EMA of the historical max |g|; AdaGN rescales the global norm toward its
    EMA; momentum (m, v) is reset every ``reset_interval`` steps. The
    clipping runs as the pipeline's tree-level ``pre`` hook, the reset via
    ``reset_interval``, and the update itself is the plain Adam stage. The
    hook returns f32 gradients and updates its EMAs (``state.extra``) in
    place, all on the device.
    """

    def pre_init(params):
        dev = next(iter(params.values())).device
        return {"norm_ema": torch.zeros((), dtype=_f32, device=dev),
                "max_ema": {k: torch.zeros((), dtype=_f32, device=p.device)
                            for k, p in params.items()}}

    def pre(grads, extra, count):
        # AdaClip: per-tensor spike clipping against the EMA of max|g|;
        # the JAX package's operations, in place on private f32 buffers
        out = {}
        for k, g in grads.items():
            gf = g.to(_f32)
            mx = extra["max_ema"][k]
            a = gf.abs()
            mx.mul_(theta).add_(torch.amax(a) * (1 - theta))
            mx_hat = mx / (1.0 - theta ** (count + 1))
            clip = a > mx_hat  # there the scale is mx_hat / (|g| + 1e-12)
            a.add_(1e-12)
            torch.div(mx_hat, a, out=a)
            a.masked_fill_(~clip, 1.0)
            out[k] = a.mul_(gf)
            del gf, a, clip
        # AdaGN: global-norm rescaling toward its EMA
        gnorm = global_norm(out)
        ne = extra["norm_ema"]
        ne.mul_(gamma1).add_(gnorm * (1 - gamma1))
        norm_hat = ne / (1.0 - gamma1 ** (count + 1))
        lim = gamma2 * norm_hat + eps
        gscale = torch.where(gnorm > lim, lim / (gnorm + 1e-12), 1.0)
        for a in out.values():
            a.mul_(gscale)
        return out, extra

    st = Stages(adam=True)
    return build_pipeline({lab: st for lab in _ALL}, lr, b1=b1, b2=b2,
                          eps=eps, pre=pre, pre_init=pre_init,
                          reset_interval=reset_interval)


def muon(
    lr: Schedule | float,
    beta: float = 0.95,
    nesterov: bool = True,
    ns_steps: int = 5,
    adam_lr: Schedule | float | None = None,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    rules: Optional[LabelRules] = None,
    lr_scaling: bool = True,
    momentum_dtype: str = "float32",
) -> GradientTransformation:
    """Muon (Jordan et al., 2024): momentum + Newton-Schulz orthogonalization
    for hidden matrices; Adam for embeddings, LM head, and vector params.
    Stores first-order momentum for every matrix (Table 4 memory row).
    ``momentum_dtype="bfloat16"`` halves that momentum's storage (and the
    first/last adam-m) with cast-on-read/write semantics.
    """
    matrix_st = Stages(momentum=beta, nesterov=nesterov, norm="ns",
                       ns_steps=ns_steps, lr_scaling=lr_scaling)
    plans = {"first": ADAM_LR_STAGE, "last": ADAM_LR_STAGE,
             "matrix": matrix_st, "vector": ADAM_LR_STAGE}
    return build_pipeline(plans, lr, adam_lr, b1=b1, b2=b2, eps=eps,
                          rules=rules, momentum_dtype=momentum_dtype)
