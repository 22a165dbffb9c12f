"""Training-loop steps (the port of ``repro.training.trainer``).

``make_train_step`` builds the paper's training step: loss and gradient
(with microbatch accumulation), global-norm clipping folded into the
optimizer's parameter write, and the update, optionally vetted by the
anomaly guard (:mod:`.resilience`). ``make_eval_step`` is the validation
loss. Gradients are taken functionally with ``torch.autograd.grad``; no
``.grad`` state is left on the parameters, and no step synchronises with
the host: the step counter, the guard's verdict and every metric stay 0-d
tensors on the device. The host keeps its own mirror of the step counter
(``TrainState.host_step``), which the statistics cadence reads.

Both steps take a ``torch.distributed`` mesh (``rules`` and ``mesh``, as
the JAX package's): the parameters are then DTensors laid out per the
rules (``models.model.place_params``), each step lays the global batch it
is given out per JAX's input layouts (``models.sharding.batch_axes``: the
(B, S) leaves per ("act_batch", "act_seq"), an audio model's (B, C, S)
tokens and labels per ("act_batch", None, "act_seq"), the VLM's image
embeddings per ("act_batch", None, "act_embed")), the loss runs on the
mesh, each gradient comes back in its parameter's layout, and the
optimizer's kernels run on the local shards
(``update_params(shardings=...)``).
Every metric is a plain 0-d tensor, the same on every rank.
"""
from __future__ import annotations

import inspect
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.checkpoint.checkpointer import named_leaves
from repro_torch.core import pipeline
from repro_torch.core.pipeline import HostCount
from repro_torch.core.types import (GradientTransformation, apply_updates,
                                    global_norm)
from repro_torch.models import loss_fn
from repro_torch.models.model import (Params, check_mesh, flatten,
                                      param_logical_axes, param_shapes,
                                      unflatten)
from repro_torch.models.sharding import (Rules, full_value, laid_out_as,
                                         mesh_context, shard_batch,
                                         tree_shardings)
from repro_torch.obs.profile import trace_span
from repro_torch.obs.stats import (StatsPolicy, leaf_update_norms,
                                   make_stats_fn)

from .resilience import (GuardPolicy, guard_step, guard_verdict,
                         guarded_select, init_guard_state,
                         inject_grad_faults)


class TrainState(NamedTuple):
    step: torch.Tensor  # 0-d int32 on the parameters' device
    params: Any         # Params; the fused write updates it in place
    opt_state: Any
    # a GuardState with the guard on; None has no leaves, so a guard-less
    # state checkpoints with the 3-field keys
    guard: Any = None
    # the host's mirror of ``step`` (a HostCount; no checkpoint leaf):
    # init_state sets it, each step advances it, restore re-seats it, and
    # the statistics cadence reads it instead of the device
    host_step: Any = None


def init_state(params, tx: GradientTransformation,
               guard: bool = False) -> TrainState:
    dev = next(iter(flatten(params).values())).device
    return TrainState(torch.zeros((), dtype=torch.int32, device=dev), params,
                      tx.init(params),
                      init_guard_state(dev) if guard else None, HostCount(0))


def value_and_grad(params, cfg, batch: dict, aux_coef: float = 0.01,
                   rules: Rules = None, mesh=None):
    """(total loss, metrics, grads) of ``models.loss_fn`` at ``params``.

    The gradient is taken with respect to detached aliases of the leaves
    (the parameters' own ``requires_grad`` is left as it is), and comes
    back as a flat ``{path: tensor}`` dict in the leaves' dtypes (on a
    mesh, DTensors in the leaves' layouts); the loss and the metrics come
    back detached, as plain tensors.
    """
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(params).items()}
    with torch.enable_grad(), mesh_context(mesh):
        total, metrics = loss_fn(unflatten(leaves), cfg, batch,
                                 aux_coef=aux_coef, rules=rules, mesh=mesh)
        grads = torch.autograd.grad(total, list(leaves.values()))
    return (full_value(total.detach()),
            {k: full_value(v.detach()) for k, v in metrics.items()},
            {k: laid_out_as(g, leaves[k]) for k, g in zip(leaves, grads)})


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """x / n as a true division (JAX's), not torch's multiplication by the
    reciprocal of a Python number; keeps x's dtype."""
    return x / torch.full((), float(n), device=x.device)


def make_train_step(cfg, tx: GradientTransformation, grad_accum: int = 1,
                    clip_norm: float = 0.0, aux_coef: float = 0.01,
                    accum_dtype: str = "float32", norm_metrics: bool = True,
                    fused_apply=None, guard: Optional[GuardPolicy] = None,
                    faults=None, stats: Optional[StatsPolicy] = None,
                    rules: Optional[Rules] = None, mesh=None):
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
    * ``guard``: a :class:`~repro_torch.training.resilience.GuardPolicy`.
      The step then needs a guard-carrying state (``init_state(...,
      guard=True)``) and vets every update: the verdict reads the loss and
      the pre-clip gradient norm, and a skipped step leaves params and
      optimizer state bitwise as they were. The update writes them in
      place, so the step snapshots what it writes (the parameter copy
      above, taken whether or not ``norm_metrics`` asks for it, and a copy
      of every optimizer-state tensor) and selects elementwise against the
      snapshot after the write (``guarded_select``): no host read. The
      metrics gain ``skipped``, ``bad_step`` and ``rollback`` (0-d), and
      ``update_norm`` is taken after the guard (0 on a skipped step).
      ``PipeState.host_count``, the host's mirror of the count, is read
      only by a projection stage (GaLore, Fira, APOLLO): for those the
      step reads the verdict back and the mirror stays the count after
      the guard; for the others it runs one ahead per skipped step until
      the launcher re-seats it at its per-step read of ``rollback``.
    * ``faults``: a :class:`~repro_torch.training.faults.FaultPlan`; its
      ``nan_grad``/``inf_grad`` clauses fill the gradients with NaN/Inf
      when the state's device step is a fault step (bitwise inert on the
      others). ``None`` costs nothing.

    * ``stats``: a :class:`~repro_torch.obs.stats.StatsPolicy`. The
      metrics gain the per-layer-group statistics of
      :mod:`repro_torch.obs.stats` (``stats/<group>/<name>`` and
      ``stats/valid``) from the pre-clip gradients, the pre-step and
      post-guard parameters and the post-step optimizer state. The cadence
      is ``state.host_step + 1`` (the completed-step index, as JAX's
      ``state.step + 1``) modulo ``every_k``, decided on the host: off it
      no reduction runs and every stat is 0. On a cadence step the fused
      write needs the pre-step parameters: the snapshot above, taken then
      if neither ``norm_metrics`` nor the guard takes it; with
      ``norm_metrics`` the per-leaf f32 differences are formed once for
      ``update_norm`` and the groups alike. Params and optimizer state are
      bitwise those of a step without stats.

    Spans (``obs.trace_span``, JAX's named scopes): ``fwd`` (the loss and
    its gradient), ``optimizer_update``, ``guard``, ``obs_stats``.

    * ``rules`` and ``mesh``: sharded training, as JAX's (see the module
      docstring): the parameters (``state.params``) are DTensors laid out
      per ``rules`` (default ``Rules(cfg.rule_overrides)``), the step
      takes the global batch, and ``update_params`` gets every
      parameter's sharding (``tree_shardings``). The global norm is the
      norm over the full gradients. Every family trains on a mesh
      (``models.model.check_mesh`` raises only in mode decode).

    ``donate`` has no counterpart: ``update_params`` already writes the
    parameters and the momentum in place.
    """
    check_mesh(cfg, mesh, "make_train_step")
    rules = rules or Rules(cfg.rule_overrides)
    acc_dt = torch.float32 if accum_dtype == "float32" else torch.bfloat16
    if fused_apply is None:
        fused_apply = tx.update_params is not None
    elif fused_apply and tx.update_params is None:
        raise ValueError("fused_apply=True but the optimizer has no "
                         "update_params (fused parameter write)")
    accepted = (inspect.signature(tx.update_params).parameters
                if fused_apply else {})
    fuse_clip = fused_apply and clip_norm > 0 and "grad_scale" in accepted
    up_kwargs = {}
    if mesh is not None and "shardings" in accepted:
        up_kwargs["shardings"] = tree_shardings(
            param_logical_axes(cfg), mesh, rules, param_shapes(cfg))
    # the projection stage decides its refresh from the host count
    reads_host_count = any(st.project is not None
                           for st in (tx.plans or {}).values())
    stats_fn = make_stats_fn(stats) if stats is not None else None

    def reshape(x):
        if x.shape[0] % grad_accum:
            raise ValueError(
                f"grad_accum={grad_accum} must divide the batch axis: "
                f"got batch size {x.shape[0]} (remainder "
                f"{x.shape[0] % grad_accum}); pick a batch size that is "
                f"a multiple of grad_accum or lower grad_accum")
        return x.reshape((grad_accum, x.shape[0] // grad_accum)
                         + tuple(x.shape[1:]))

    def lay_out(batch):
        return shard_batch(batch, mesh, rules) if mesh is not None else batch

    def compute_grads(params, batch):
        if grad_accum == 1:
            return value_and_grad(params, cfg, lay_out(batch), aux_coef,
                                  rules, mesh)
        micro = {k: reshape(full_value(v)) for k, v in batch.items()}
        gsum, loss_sum, stack = {}, None, []
        for i in range(grad_accum):
            loss, metrics, grads = value_and_grad(
                params, cfg, lay_out({k: v[i] for k, v in micro.items()}),
                aux_coef, rules, mesh)
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
        with mesh_context(mesh):
            return _train_step(state, batch)

    def _train_step(state: TrainState, batch: dict):
        if guard is not None and state.guard is None:
            raise ValueError(
                "make_train_step(guard=...) needs a guard-carrying state: "
                "build it with init_state(params, tx, guard=True)")
        host_step = state.host_step
        if host_step is None and stats_fn is not None:
            host_step = HostCount(int(state.step))  # built by hand: read once
        on_cadence = (stats_fn is not None
                      and stats_fn.hit(host_step.n + 1))
        with trace_span("fwd"):
            loss, metrics, grads = compute_grads(state.params, batch)
        grads = inject_grad_faults(faults, state.step, grads)
        out = {"loss": loss}
        if on_cadence:
            # the pre-clip gradients (JAX's raw_grads), read before the
            # update so that they can be freed after it
            with trace_span("obs_stats"):
                part = stats_fn.of_grads(grads)
        kw = {}
        if clip_norm > 0 or norm_metrics or guard is not None:
            gnorm = full_value(global_norm(grads))
            out["grad_norm"] = gnorm
        if clip_norm > 0:
            scale = torch.clamp(torch.div(torch.full_like(gnorm, clip_norm),
                                          gnorm + 1e-9), max=1.0)
            if fuse_clip:
                kw["grad_scale"] = scale
            else:
                grads = {k: pipeline.jax_mul(g, scale)
                         for k, g in grads.items()}
        gstate = state.guard
        if guard is not None:
            with trace_span("guard"):
                ok = guard_verdict(guard, state.guard, loss, gnorm)
                gstate, rollback = guard_step(guard, state.guard, ok, loss)
                # the update writes the optimizer state in place: snapshot
                old_state = {k: x.clone() for k, x in
                             dict(named_leaves(state.opt_state)).items()}
            host = getattr(state.opt_state, "host_count", None)
            host_n = host.n if host is not None else None
        with trace_span("optimizer_update"):
            if fused_apply:
                old = ({k: p.clone() for k, p in flatten(state.params).items()}
                       if norm_metrics or guard is not None or on_cadence
                       else None)
                _, opt_state = tx.update_params(grads, state.opt_state,
                                                state.params, **up_kwargs,
                                                **kw)
                params = state.params
            else:
                old = flatten(state.params)  # apply_updates leaves these
                updates, opt_state = tx.update(grads, state.opt_state,
                                               state.params)
                params = Params(apply_updates(state.params, updates))
        del grads
        if guard is not None:
            with trace_span("guard"):
                guarded_select(ok, flatten(params), old)
                guarded_select(ok, dict(named_leaves(opt_state)), old_state)
            del old_state
            if host is not None:
                # a skip passed the device count through; a projection
                # stage reads the mirror, so there it follows (one host
                # read); elsewhere the launcher re-seats it
                host.n = host_n + (int(ok) if reads_host_count else 1)
            out["skipped"] = gstate.skipped
            out["bad_step"] = (~ok).to(torch.int32)
            out["rollback"] = rollback
        unorms = None
        if norm_metrics:
            if fused_apply:
                unorms = leaf_update_norms(flatten(params), old)
                out["update_norm"] = full_value(torch.linalg.vector_norm(
                    torch.stack(list(unorms.values()))))
            else:
                unorm = full_value(global_norm(updates))
                out["update_norm"] = (torch.where(ok, unorm, 0.0)
                                      if guard is not None else unorm)
        if on_cadence:
            with trace_span("obs_stats"):
                out.update(stats_fn.finish(part, old, params, opt_state,
                                           unorms))
            del part
        elif stats_fn is not None:
            out.update(stats_fn.off(loss.device))
        del old
        out.update({k: v for k, v in metrics.items() if k != "loss"})
        return TrainState(state.step + 1, params, opt_state, gstate,
                          None if host_step is None
                          else HostCount(host_step.n + 1)), out

    return train_step


def make_eval_step(cfg, rules: Optional[Rules] = None, mesh=None):
    """eval_step(params, batch) -> {"loss", "perplexity"} (0-d f32 tensors
    on the batch's device), run under ``torch.no_grad()``. ``mesh``: as
    ``make_train_step``'s (the global batch laid out per the rules)."""
    check_mesh(cfg, mesh, "make_eval_step")
    rules = rules or Rules(cfg.rule_overrides)

    @torch.no_grad()
    def eval_step(params, batch):
        if mesh is not None:
            batch = shard_batch(batch, mesh, rules)
        _, metrics = loss_fn(params, cfg, batch, rules=rules, mesh=mesh)
        loss = full_value(metrics["loss"])
        return {"loss": loss, "perplexity": torch.exp(loss)}

    return eval_step
