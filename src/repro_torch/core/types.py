"""Optimizer framework primitives, as in ``repro.core.types``.

A :class:`GradientTransformation` is an ``(init, update)`` pair with an
optional in-place ``update_params``:

    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = apply_updates(params, updates)
    # or, writing the parameters in place:
    params, state = tx.update_params(grads, state, params, grad_scale=s)

Parameters, gradients and updates are flat ``{path_str: tensor}``
mappings (``repro_torch.models.model.flatten`` of a parameter tree; keys
are the JAX package's ``core.labels.path_str`` keys). ``updates`` are
deltas, so ``apply_updates`` is a plain add in each parameter's dtype.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.models.model import flatten
from repro_torch.models.sharding import full_value

PyTree = Any
Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr


class GradientTransformation(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, Optional[PyTree]], tuple]
    # optional in-place path: (grads, state, params) -> (params, new_state)
    update_params: Optional[Callable[..., tuple]] = None
    # the per-label Stages plans a pipeline optimizer was built from
    plans: Optional[Any] = None


def apply_updates(params, updates) -> dict:
    """``{path: p + u.to(p.dtype)}`` (new tensors, as JAX's tree add)."""
    params, updates = flatten(params), flatten(updates)
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 on the leaves'
    device (no host synchronisation).

    Each leaf's f32 norm comes from one fused reduction that reads the leaf
    once and materializes no f32 copy of it (``torch._foreach_norm``); the
    result is the f32 norm of those norms. DTensor leaves (a mesh) give
    the norm of their full values, a plain tensor on every rank.
    """
    leaves = list(flatten(tree).values())
    if not leaves:
        return torch.zeros(())
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    # a DTensor leaf's norm is a partial one: reduced to the global norm
    # per leaf before the norms are stacked
    norms = [full_value(n) for n in norms]
    return torch.linalg.vector_norm(torch.stack(norms))
