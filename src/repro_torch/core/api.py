"""Public optimizer factory: ``make_optimizer(name, lr=..., **kw)``.

The port of ``repro.core.api``: the JAX registry's 20 names in its order,
with its defaults, ``fused`` flags and lowering notes. Names match the
paper's tables: scale, sgd, sgd_momentum, adam, adamw, stable_spam, muon,
swan, galore, fira, apollo, apollo_mini, the Table-2 normalization
ablations sgd_colnorm / sgd_rownorm / sgd_signnorm / sgd_nsnorm /
sgd_svdnorm, and two related-work compositions: adams (AdamS) and adapm
(SCALE's plan with momentum on the embedding and the LM head).

``make_optimizer`` validates the name and the kwargs up front and raises a
``ValueError`` listing the valid choices.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Mapping

from . import galore as _galore
from . import optimizers as _opt
from . import scale as _scale
from . import swan as _swan
from .types import GradientTransformation


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """One registry row: how to build an optimizer and what it supports.

    ``fused`` means the composition contains stages that lower to the
    colnorm/momentum kernels when built with ``impl="fused"``; ``lowering``
    is the JAX row's note on which.
    """
    name: str
    factory: Callable[..., GradientTransformation]
    fused: bool = False
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    lowering: str = ""

    def valid_kwargs(self) -> tuple:
        params = inspect.signature(self.factory).parameters
        return tuple(k for k in params if k != "lr")


def _registry() -> dict:
    specs = [
        OptimizerSpec("scale", _scale.scale, fused=True, lowering=(
            "stateless matrices -> normalize / norm_update; momentum "
            "groups (LM head) -> momentum_norm / momentum_norm_update; "
            "Adam vectors stay jnp")),
        OptimizerSpec("scale_fused", _scale.scale, fused=True,
                      defaults={"impl": "fused"}, lowering=(
                          'as scale, built with impl="fused" by default')),
        OptimizerSpec("sgd", _opt.sgd, lowering=(
            "never fused: plain SGD has no norm stage; jnp write path "
            "only")),
        OptimizerSpec("sgd_momentum", _opt.sgd, defaults={"momentum": 0.9},
                      lowering=(
                          "never fused: a bare momentum EMA without a "
                          "col/row norm has no kernel composition")),
        OptimizerSpec("adam", _opt.adam, lowering=(
            "never fused: Adam moments have no kernel composition; jnp "
            "write path only")),
        OptimizerSpec("adamw", _opt.adam, defaults={"weight_decay": 0.01},
                      lowering=(
                          "as adam (decoupled weight decay folds into the "
                          "Adam stage)")),
        OptimizerSpec("adams", _opt.adams, lowering=(
            "never fused: the synthesized AdamS denominator "
            "(sqrt(b2*m^2 + (1-b2)*g^2)) has no kernel composition; jnp "
            "write path only")),
        OptimizerSpec("adapm", _scale.scale, fused=True,
                      defaults={"momentum_on": ("first", "last")}, lowering=(
                          "as scale with momentum on the embedding and the "
                          "LM head (partial momentum); hidden matrices stay "
                          "stateless normalize / norm_update")),
        OptimizerSpec("stable_spam", _opt.stable_spam_adam, lowering=(
            "never fused: AdaClip/AdaGN run as the tree-level pre hook; "
            "the Adam stage stays jnp")),
        OptimizerSpec("muon", _opt.muon, lowering=(
            "never fused: nesterov EMA + Newton-Schulz orthogonalization "
            "sit outside kernel coverage")),
        OptimizerSpec("swan", _swan.swan, lowering=(
            "never fused: standardize (GradNorm) precedes the norm "
            "stage")),
        OptimizerSpec("galore", _galore.galore, lowering=(
            "never fused: the low-rank projection stage has no kernel "
            "composition")),
        OptimizerSpec("fira", _galore.fira, lowering=(
            "as galore (adds the full-rank residual)")),
        OptimizerSpec("apollo", _galore.apollo, lowering=(
            "as galore (random projector, channel-wise scaling)")),
        OptimizerSpec("apollo_mini", _galore.apollo_mini, lowering=(
            "as apollo (rank-1 projector, tensor-wise scaling)")),
        OptimizerSpec("sgd_colnorm", _opt.normalized_sgd, fused=True,
                      defaults={"kind": "col"}, lowering=(
                          "all matrix groups -> normalize / norm_update "
                          'when built with impl="fused"; vectors stay '
                          "jnp")),
        OptimizerSpec("sgd_rownorm", _opt.normalized_sgd, fused=True,
                      defaults={"kind": "row"}, lowering=(
                          "as sgd_colnorm with the row kind")),
        OptimizerSpec("sgd_signnorm", _opt.normalized_sgd,
                      defaults={"kind": "sign"}, lowering=(
                          "never fused: sign norm is outside kernel "
                          "coverage")),
        OptimizerSpec("sgd_nsnorm", _opt.normalized_sgd,
                      defaults={"kind": "ns"}, lowering=(
                          "never fused: Newton-Schulz norm is outside "
                          "kernel coverage")),
        OptimizerSpec("sgd_svdnorm", _opt.normalized_sgd,
                      defaults={"kind": "svd"}, lowering=(
                          "never fused: SVD norm is outside kernel "
                          "coverage")),
    ]
    return {s.name: s for s in specs}


OPTIMIZER_REGISTRY = _registry()
OPTIMIZER_NAMES = tuple(OPTIMIZER_REGISTRY)


def make_optimizer(name: str, lr: Any = 1e-3, **kw) -> GradientTransformation:
    key = name.lower()
    spec = OPTIMIZER_REGISTRY.get(key)
    if spec is None:
        raise ValueError(
            f"unknown optimizer {name!r}; valid choices: "
            + ", ".join(sorted(OPTIMIZER_REGISTRY)))
    valid = spec.valid_kwargs()
    unknown = sorted(set(kw) - set(valid))
    if unknown:
        raise ValueError(
            f"unknown kwarg(s) {unknown} for optimizer {name!r}; "
            f"valid kwargs: {', '.join(valid)}")
    return spec.factory(lr, **{**spec.defaults, **kw})
