"""Per-layer-group gradient/update/momentum statistics (the port of
``repro.obs.stats``).

The paper's argument is observational: gradient variance concentrates in
the output layer (Fig. 4) and LM-head gradient column norms follow token
frequency (Fig. 10), which is why SCALE puts momentum on the head and
normalizes column-wise. A :class:`StatsPolicy` handed to
``make_train_step(stats=...)`` makes those facts live training metrics:
every ``every_k`` steps the step computes, per layer group
(``embedding`` / ``hidden`` / ``lm_head``, :func:`repro_torch.core.labels.
layer_group`):

  * ``grad_norm``      — group L2 norm of the pre-clip gradient;
  * ``colnorm_max`` / ``colnorm_med`` / ``colnorm_disp`` — max, median and
    max/median ratio of per-output-column gradient norms over the group's
    leaves of two or more dimensions (a tied (V, D) head reduces along its
    storage rows). The median of an even count is the mean of the two
    middle values, as ``jnp.median``'s. Stacked per-layer vectors, (L, D),
    count as matrices whose columns sum over the layer axis, as in JAX
    (ROADMAP.md reference caveat 10);
  * ``update_norm`` / ``param_norm`` / ``update_ratio`` — the applied
    update (post-guard: a skipped step reports 0) and its scale relative
    to the pre-step parameters;
  * ``momentum_norm``  — L2 norm of ``PipeState.mu`` (zero-length
    placeholders skipped, bf16 read as f32; 0 when the state has no ``mu``
    mirroring the gradients' keys).

No f32 copy of a whole gradient is made: group norms are per-leaf
``torch._foreach_norm(..., dtype=float32)`` reductions, and the per-column
sums of squares go through the port's ``norm_sumsq`` wrapper (the CUDA
kernel on the card, reading bf16 as f32 in registers, counted in
``norm_sumsq.launches``; its plain version on the CPU).

Cadence: JAX decides it under a traced ``lax.cond`` on the completed-step
index. The port decides it on the host, from an integer the trainer keeps
beside the device step, so the step reads nothing back: off the cadence
no reduction is issued, every stat is one shared 0 and ``stats/valid`` is
0. The collector only reads, so a run with stats is bitwise a run without.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.labels import LAYER_GROUPS, LabelRules, layer_group
from repro_torch.kernels.colnorm.colnorm import norm_sumsq
from repro_torch.models.model import flatten

_f32 = torch.float32


class StatsPolicy(NamedTuple):
    """Static stats configuration.

    ``every_k``: collection cadence in steps (every step when 1; must be
    >= 1). ``tied``: the model ties embeddings — the token embedding IS
    the LM head, so it reports under ``lm_head`` and its column norms
    reduce along the transposed (V, D) storage axis. ``momentum``:
    include first-moment-buffer norms. ``colnorms``: include the Fig. 10
    column-norm dispersion stats. ``ratios``: include update/param norm
    ratios. ``prefix``: metric-key prefix (``<prefix>/<group>/<name>``).
    """
    every_k: int = 50
    tied: bool = False
    momentum: bool = True
    colnorms: bool = True
    ratios: bool = True
    prefix: str = "stats"


def _names(policy: StatsPolicy) -> list:
    if policy.every_k < 1:
        raise ValueError(f"StatsPolicy.every_k must be >= 1, "
                         f"got {policy.every_k}")
    names = []
    for grp in LAYER_GROUPS:
        names.append(f"{grp}/grad_norm")
        if policy.colnorms:
            names += [f"{grp}/colnorm_max", f"{grp}/colnorm_med",
                      f"{grp}/colnorm_disp"]
        if policy.ratios:
            names += [f"{grp}/update_norm", f"{grp}/param_norm",
                      f"{grp}/update_ratio"]
        if policy.momentum:
            names.append(f"{grp}/momentum_norm")
    return names


def _col_sq_norms(g: torch.Tensor, transposed: bool) -> torch.Tensor:
    """Flattened f32 squared per-output-column norms of a >=2-D gradient.

    A matrix stored (d_in, d_out) reduces axis -2 (one norm per output
    column: for the (D, V) head one per vocab token); transposed (tied
    (V, D)) storage reduces axis -1. Leading axes (stacked layers) are
    the kernel's L: every slice contributes its columns.
    """
    m, n = g.shape[-2:]
    ss = norm_sumsq(g.reshape(-1, m, n), "row" if transposed else "col")
    return ss.reshape(-1)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the midpoint of the two middle
    order statistics ((lo + hi) * 0.5; one value for an odd count), NaN
    when any element is NaN. The count is the shape's, so no sync."""
    n = x.numel()
    s = torch.sort(x).values
    md = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(md, torch.nan),
                       md)


def _norm(norms: list, dev) -> torch.Tensor:
    """L2 norm of per-leaf f32 norms; 0 with none."""
    if not norms:
        return torch.zeros((), dtype=_f32, device=dev)
    return torch.linalg.vector_norm(torch.stack(norms))


def leaf_update_norms(new: dict, old: dict) -> dict:
    """``{path: f32 0-d |new - old|}``, differenced in f32 one leaf at a
    time (bf16 parameters would round small updates away)."""
    return {k: torch.linalg.vector_norm(new[k].float() - o.float())
            for k, o in old.items()}


def make_stats_fn(policy: StatsPolicy):
    """Build ``stats_fn(step, grads, old_params, new_params, opt_state,
    update_norms=None) -> {key: f32 0-d tensor}``.

    ``step`` is the host's completed-step index; the keys are the same
    every step; ``<prefix>/valid`` is 1.0 exactly on cadence steps and
    every other stat is 0 off it. Groups with no matching parameters
    report 0. ``update_norms``: the per-leaf ``leaf_update_norms`` when the
    caller has them already (the trainer's ``update_norm``).

    The trainer runs it in two parts, so that the gradients can be freed
    before the update's f32 differences are formed: ``stats_fn.hit(step)``,
    ``stats_fn.of_grads(grads)`` before the update and
    ``stats_fn.finish(part, old, new, opt_state, update_norms)`` after it;
    ``stats_fn.off(device)`` is the off-cadence dict.
    """
    names = _names(policy)
    rules = LabelRules.tied() if policy.tied else LabelRules()
    pre = policy.prefix

    def groups_of(paths):
        grp = {p: layer_group(p, tied=policy.tied) for p in paths}
        return {g: [p for p in paths if grp[p] == g] for g in LAYER_GROUPS}

    def hit(step: int) -> bool:
        return int(step) % policy.every_k == 0

    def of_grads(grads) -> dict:
        grads = flatten(grads)
        paths = list(grads)
        dev = next(iter(grads.values())).device
        norms = dict(zip(paths, torch._foreach_norm(
            [grads[p] for p in paths], 2, dtype=_f32)))
        out = {}
        for grp, idx in groups_of(paths).items():
            out[f"{grp}/grad_norm"] = _norm([norms[p] for p in idx], dev)
            if not policy.colnorms:
                continue
            sq = [_col_sq_norms(grads[p], rules.transposed(p, grads[p].ndim))
                  for p in idx if grads[p].ndim >= 2]
            if sq:
                cn = torch.sqrt(torch.cat(sq))
                mx, md = cn.max(), _median(cn)
            else:
                mx = md = torch.zeros((), dtype=_f32, device=dev)
            out[f"{grp}/colnorm_max"] = mx
            out[f"{grp}/colnorm_med"] = md
            out[f"{grp}/colnorm_disp"] = mx / torch.clamp_min(md, 1e-30)
        return out

    def finish(part: dict, old_params, new_params, opt_state,
               update_norms: Optional[dict] = None) -> dict:
        old = flatten(old_params)
        paths, dev = list(old), next(iter(old.values())).device
        out = dict(part)
        groups = groups_of(paths)
        if policy.ratios:
            if update_norms is None:
                update_norms = leaf_update_norms(flatten(new_params), old)
            pnorms = dict(zip(paths, torch._foreach_norm(
                [old[p] for p in paths], 2, dtype=_f32)))
            for grp, idx in groups.items():
                un = _norm([update_norms[p] for p in idx], dev)
                pn = _norm([pnorms[p] for p in idx], dev)
                out[f"{grp}/update_norm"] = un
                out[f"{grp}/param_norm"] = pn
                out[f"{grp}/update_ratio"] = un / torch.clamp_min(pn, 1e-30)
        if policy.momentum:
            # first-moment buffers: a pipeline optimizer's state mirrors the
            # gradients' keys in `mu` (zero-length where a group is
            # stateless); other states have no `mu`
            mu = getattr(opt_state, "mu", None)
            if not (hasattr(mu, "items") and set(flatten(mu)) == set(paths)):
                mu = None
            else:
                mu = flatten(mu)
            for grp, idx in groups.items():
                live = [mu[p] for p in idx if mu[p].numel()] if mu else []
                out[f"{grp}/momentum_norm"] = _norm(
                    list(torch._foreach_norm(live, 2, dtype=_f32))
                    if live else [], dev)
        vals = {f"{pre}/{n}": out[n] for n in names}
        vals[f"{pre}/valid"] = torch.ones((), dtype=_f32, device=dev)
        return vals

    def off(device) -> dict:
        z = torch.zeros((), dtype=_f32, device=device)
        vals = {f"{pre}/{n}": z for n in names}
        vals[f"{pre}/valid"] = z
        return vals

    def stats_fn(step, grads, old_params, new_params, opt_state,
                 update_norms: Optional[dict] = None) -> dict:
        if not hit(step):
            return off(next(iter(flatten(grads).values())).device)
        return finish(of_grads(grads), old_params, new_params, opt_state,
                      update_norms)

    stats_fn.hit = hit
    stats_fn.of_grads = of_grads
    stats_fn.finish = finish
    stats_fn.off = off
    return stats_fn


def stats_keys(policy: StatsPolicy) -> list:
    """The metric keys a collector built from ``policy`` emits."""
    return sorted([f"{policy.prefix}/{n}" for n in _names(policy)]
                  + [f"{policy.prefix}/valid"])


def split_stats(metrics: dict, policy: Optional[StatsPolicy]) -> tuple:
    """Split a step's metrics dict into (plain, stats) by key prefix.

    ``stats`` is {} off the cadence step (``<prefix>/valid`` 0) or when no
    policy is active — the launcher writes stats fields only when they were
    actually measured, keeping off-cadence JSONL records small. Reads
    ``<prefix>/valid`` back from the device.
    """
    if policy is None:
        return dict(metrics), {}
    pre = policy.prefix + "/"
    plain = {k: v for k, v in metrics.items() if not k.startswith(pre)}
    valid = metrics.get(pre + "valid")
    if valid is None or not float(valid):
        return plain, {}
    stats = {k: v for k, v in metrics.items()
             if k.startswith(pre) and k != pre + "valid"}
    return plain, stats
