"""Optimizer factory: ``make_optimizer(name, lr=..., **kw)``.

The registry entries of ``repro.core.api`` that build on SCALE, with the
JAX package's defaults: ``scale``, ``scale_fused`` (``impl="fused"``) and
``adapm`` (momentum on the embedding and the LM head). Any other name
raises a ``KeyError``: the rest of the JAX registry comes with the rest of
the optimizer zoo (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Mapping

from . import scale as _scale
from .types import GradientTransformation


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """One registry row: the factory and the defaults the name implies."""
    name: str
    factory: Callable[..., GradientTransformation]
    defaults: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def valid_kwargs(self) -> tuple:
        params = inspect.signature(self.factory).parameters
        return tuple(k for k in params if k != "lr")


OPTIMIZER_REGISTRY = {s.name: s for s in (
    OptimizerSpec("scale", _scale.scale),
    OptimizerSpec("scale_fused", _scale.scale, defaults={"impl": "fused"}),
    OptimizerSpec("adapm", _scale.scale,
                  defaults={"momentum_on": ("first", "last")}),
)}
OPTIMIZER_NAMES = tuple(OPTIMIZER_REGISTRY)


def make_optimizer(name: str, lr: Any = 1e-3, **kw) -> GradientTransformation:
    key = name.lower()
    spec = OPTIMIZER_REGISTRY.get(key)
    if spec is None:
        raise KeyError(f"optimizer {name!r} is not in repro_torch; ported: "
                       + ", ".join(OPTIMIZER_NAMES) + " (the rest of the "
                       "JAX registry comes with ROADMAP Queue 1 item 8)")
    valid = spec.valid_kwargs()
    unknown = sorted(set(kw) - set(valid))
    if unknown:
        raise ValueError(
            f"unknown kwarg(s) {unknown} for optimizer {name!r}; "
            f"valid kwargs: {', '.join(valid)}")
    return spec.factory(lr, **{**spec.defaults, **kw})
