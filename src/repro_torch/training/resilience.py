"""The anomaly guard: the port of ``repro.training.resilience``.

The guard sits inside the train step and decides per step whether the
freshly computed update may be applied:

  * finite checks on the loss and the global (pre-clip) gradient norm;
  * a running loss-spike statistic: an EMA of the accepted losses; a
    step whose loss exceeds ``spike_factor * ema`` once ``spike_warmup``
    steps were accepted is anomalous even if finite;
  * a bad step is skipped: params and optimizer state pass through
    bitwise (an elementwise select against the old values, never
    arithmetic masking), ``skipped`` counts it, and its loss never enters
    the EMA;
  * after ``max_bad_steps`` consecutive bad steps the ``rollback`` flag
    rises in the step's metrics, and the launcher restores the last
    verifiable checkpoint and cuts the learning rate.

Everything is 0-d tensor arithmetic on the device: no value is read back
to the host, so a guarded step does not synchronise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GuardPolicy(NamedTuple):
    """Static guard configuration.

    ``spike_factor``: accepted-loss-EMA multiple above which a finite loss
    is still anomalous; ``0`` disables the spike check (finite checks stay
    on). ``spike_warmup``: accepted steps before the spike check arms.
    ``ema_beta``: decay of the accepted-loss EMA. ``max_bad_steps``:
    consecutive bad steps before ``rollback`` trips; ``0`` means never.
    """
    spike_factor: float = 0.0
    spike_warmup: int = 20
    ema_beta: float = 0.99
    max_bad_steps: int = 0


class GuardState(NamedTuple):
    """Guard state, 0-d tensors on the device, carried in
    ``TrainState.guard``: ``loss_ema`` (f32) over ``ema_count`` accepted
    steps, ``skipped`` steps over the run and the current
    ``consecutive_bad`` streak (int32)."""
    loss_ema: torch.Tensor
    ema_count: torch.Tensor
    skipped: torch.Tensor
    consecutive_bad: torch.Tensor


def init_guard_state(device=None) -> GuardState:
    def z(dt):
        return torch.zeros((), dtype=dt, device=device)
    return GuardState(z(torch.float32), z(torch.int32), z(torch.int32),
                      z(torch.int32))


def _f32(x: float) -> float:
    """x rounded to f32, as JAX rounds a Python constant it casts; a Python
    number keeps the step free of host-to-device copies."""
    return float(np.float32(x))


def guard_verdict(policy: GuardPolicy, gstate: GuardState, loss, grad_norm):
    """-> 0-d bool tensor: may this step's update be applied?

    The spike check compares against the EMA debiased by its accumulated
    weight and arms once ``spike_warmup`` steps have been accepted.
    """
    ok = torch.isfinite(loss) & torch.isfinite(grad_norm)
    if policy.spike_factor > 0:
        armed = gstate.ema_count >= policy.spike_warmup
        beta = _f32(policy.ema_beta)
        weight = 1.0 - torch.pow(beta, gstate.ema_count.float())
        mean = gstate.loss_ema / torch.clamp(weight, min=1e-12)
        calm = loss <= policy.spike_factor * mean
        ok = ok & (calm | ~armed)
    return ok


def guard_step(policy: GuardPolicy, gstate: GuardState, ok, loss):
    """Advance the guard state given this step's verdict.

    Returns ``(new_state, rollback)``: the EMA takes accepted losses only,
    the streak resets on any accepted step, and ``rollback`` (0-d bool)
    trips when the streak reaches ``max_bad_steps`` (never when that is 0).
    """
    beta = _f32(policy.ema_beta)
    loss = loss.to(torch.float32)
    # 1 - beta in f32, as JAX forms it from the f32 beta (exact here)
    ema = torch.where(ok, beta * gstate.loss_ema
                      + _f32(np.float32(1.0) - np.float32(beta)) * loss,
                      gstate.loss_ema)
    count = gstate.ema_count + ok.to(torch.int32)
    streak = torch.where(ok, torch.zeros_like(gstate.consecutive_bad),
                         gstate.consecutive_bad + 1)
    skipped = gstate.skipped + (~ok).to(torch.int32)
    if policy.max_bad_steps > 0:
        rollback = streak >= policy.max_bad_steps
    else:
        rollback = torch.zeros((), dtype=torch.bool, device=ok.device)
    return GuardState(ema, count, skipped, streak), rollback


def guarded_select(ok, new: dict, old: dict) -> dict:
    """``new`` where ok, else ``old``, elementwise and bitwise, written into
    ``new``'s tensors (``{key: tensor}`` dicts of equal shapes and dtypes).

    A select never carries NaN or Inf from the discarded side, so a skipped
    step leaves exactly the old values. ``new`` may hold the very tensors
    the update wrote in place; ``old`` is then a snapshot taken before it.
    """
    for k, n in new.items():
        torch.where(ok, n, old[k], out=n)
    return new


def inject_grad_faults(plan, step, grads: dict) -> dict:
    """Corrupt ``grads`` at the plan's nan/inf steps, in place.

    ``plan`` is a :class:`~repro_torch.training.faults.FaultPlan` (or None:
    then nothing is touched, no pass over the gradients); ``step`` the
    state's 0-d device step counter, so a fault replays after a restore.
    Off the fault steps the masked fill leaves every leaf bitwise as it
    was. Only floating leaves are corrupted.
    """
    if plan is None or not plan.any_grad_faults:
        return grads

    def hit(steps):
        out = torch.zeros((), dtype=torch.bool, device=step.device)
        for k in steps:
            out = out | (step == k)
        return out

    bad_nan = hit(plan.grad_fault_steps("nan"))
    bad_inf = hit(plan.grad_fault_steps("inf"))
    for g in grads.values():
        if g.is_floating_point():
            g.masked_fill_(bad_nan, float("nan"))
            g.masked_fill_(bad_inf, float("inf"))
    return grads

