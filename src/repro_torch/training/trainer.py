"""Training-loop steps (the port of ``repro.training.trainer``).

``make_train_step`` builds the paper's training step: loss and gradient
(with microbatch accumulation), global-norm clipping folded into the
optimizer's parameter write, and the update. ``make_eval_step`` is the
validation loss. Gradients are taken functionally with
``torch.autograd.grad``; no ``.grad`` state is left on the parameters, and
no step synchronises with the host: the step counter and every metric stay
0-d tensors on the device.
"""
from __future__ import annotations

import inspect
from typing import Any, NamedTuple

import torch

from repro_torch.core import pipeline
from repro_torch.core.types import (GradientTransformation, apply_updates,
                                    global_norm)
from repro_torch.models import loss_fn
from repro_torch.models.model import Params, flatten, unflatten


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the parameters' device
    params: Any         # Params; the fused write updates it in place
    opt_state: Any


def init_state(params, tx: GradientTransformation) -> TrainState:
    dev = next(iter(flatten(params).values())).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      tx.init(params))


def value_and_grad(params, cfg, batch: dict, aux_coef: float = 0.01):
    """(total loss, metrics, grads) of ``models.loss_fn`` at ``params``.

    The gradient is taken with respect to detached aliases of the leaves
    (the parameters' own ``requires_grad`` is left as it is), and comes
    back as a flat ``{path: tensor}`` dict in the leaves' dtypes; the loss
    and the metrics come back detached.
    """
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(params).items()}
    with torch.enable_grad():
        total, metrics = loss_fn(unflatten(leaves), cfg, batch,
                                 aux_coef=aux_coef)
        grads = torch.autograd.grad(total, list(leaves.values()))
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as a true division (JAX's), not torch's multiplication by the
    reciprocal of a Python number; keeps x's dtype."""
    return x / torch.full((), float(n), device=x.device)


def _update_norm(new: dict, old: dict) -> torch.Tensor:
    """global_norm of new - old, differenced in f32 one leaf at a time."""
    norms = [torch.linalg.vector_norm(new[k].float() - o.float())
             for k, o in old.items()]
    return torch.linalg.vector_norm(torch.stack(norms))


def make_train_step(cfg, tx: GradientTransformation, grad_accum: int = 1,
                    clip_norm: float = 0.0, aux_coef: float = 0.01,
                    accum_dtype: str = "float32", norm_metrics: bool = True,
                    fused_apply=None):
    """Build ``train_step(state, batch) -> (state, metrics)``.

    The semantics of the JAX package's ``make_train_step``:

    * ``grad_accum > 1`` splits the batch along axis 0 into microbatches,
      sums their gradients in ``accum_dtype`` and divides by
      ``grad_accum``; the loss and the metrics are averaged.
    * ``clip_norm > 0`` clips by the global gradient norm: the factor
      ``min(1, clip_norm / (|g| + 1e-9))`` is a 0-d device tensor, passed
      into ``tx.update_params(grad_scale=...)`` under the fused write and
      multiplied into the gradients otherwise.
    * ``fused_apply``: ``None`` uses the optimizer's in-place
      ``update_params`` when it has one, ``True`` requires it, ``False``
      takes ``update`` + ``apply_updates``.
    * metrics: ``loss`` (the total, with ``aux_coef * aux``), ``grad_norm``
      (with clipping or ``norm_metrics``), ``update_norm`` (with
      ``norm_metrics``), ``aux`` and ``weight``. Under the fused write the
      parameters are overwritten, so ``update_norm`` differences a copy of
      the pre-step parameters in f32, as JAX does: one more parameter-sized
      buffer (2.68 GB at llama-1b in bf16); ``norm_metrics=False`` saves it.

    Left out, with the modules they need: ``rules`` and ``mesh`` (sharding,
    ROADMAP.md Queue 1 item 12), ``guard`` and ``faults`` (item 9),
    ``stats`` (item 10). ``donate`` has no counterpart: ``update_params``
    already writes the parameters and the momentum in place.
    """
    acc_dt = torch.float32 if accum_dtype == "float32" else torch.bfloat16
    if fused_apply is None:
        fused_apply = tx.update_params is not None
    elif fused_apply and tx.update_params is None:
        raise ValueError("fused_apply=True but the optimizer has no "
                         "update_params (fused parameter write)")
    fuse_clip = (fused_apply and clip_norm > 0 and "grad_scale"
                 in inspect.signature(tx.update_params).parameters)

    def reshape(x):
        if x.shape[0] % grad_accum:
            raise ValueError(
                f"grad_accum={grad_accum} must divide the batch axis: "
                f"got batch size {x.shape[0]} (remainder "
                f"{x.shape[0] % grad_accum}); pick a batch size that is "
                f"a multiple of grad_accum or lower grad_accum")
        return x.reshape((grad_accum, x.shape[0] // grad_accum)
                         + tuple(x.shape[1:]))

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, cfg, batch, aux_coef)
        micro = {k: reshape(v) for k, v in batch.items()}
        gsum, loss_sum, stack = {}, None, []
        for i in range(grad_accum):
            loss, metrics, grads = value_and_grad(
                params, cfg, {k: v[i] for k, v in micro.items()}, aux_coef)
            for k, g in grads.items():
                if k in gsum:
                    gsum[k].add_(g)
                else:
                    gsum[k] = g.to(acc_dt)
            loss_sum = loss if loss_sum is None else loss_sum + loss
            stack.append(metrics)
        grads = {k: _div(g, grad_accum) for k, g in gsum.items()}
        metrics = {k: torch.stack([m[k] for m in stack]).mean(0)
                   for k in stack[0]}
        return _div(loss_sum, grad_accum), metrics, grads

    @torch.no_grad()
    def train_step(state: TrainState, batch: dict):
        loss, metrics, grads = compute_grads(state.params, batch)
        out = {"loss": loss}
        kw = {}
        if clip_norm > 0 or norm_metrics:
            gnorm = global_norm(grads)
            out["grad_norm"] = gnorm
        if clip_norm > 0:
            scale = torch.clamp(torch.div(torch.full_like(gnorm, clip_norm),
                                          gnorm + 1e-9), max=1.0)
            if fuse_clip:
                kw["grad_scale"] = scale
            else:
                grads = {k: pipeline.jax_mul(g, scale)
                         for k, g in grads.items()}
        if fused_apply:
            old = ({k: p.clone() for k, p in flatten(state.params).items()}
                   if norm_metrics else None)
            _, opt_state = tx.update_params(grads, state.opt_state,
                                            state.params, **kw)
            params = state.params
            if norm_metrics:
                out["update_norm"] = _update_norm(flatten(params), old)
                del old
        else:
            updates, opt_state = tx.update(grads, state.opt_state,
                                           state.params)
            params = Params(apply_updates(state.params, updates))
            if norm_metrics:
                out["update_norm"] = global_norm(updates)
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return TrainState(state.step + 1, params, opt_state), out

    return train_step


def make_eval_step(cfg):
    """eval_step(params, batch) -> {"loss", "perplexity"} (0-d f32 tensors
    on the batch's device), run under ``torch.no_grad()``."""

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch)
        return {"loss": metrics["loss"],
                "perplexity": torch.exp(metrics["loss"])}

    return eval_step
