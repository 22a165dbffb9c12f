"""Weight bridge between the JAX package's parameter tree and the port.

The JAX side flattens its tree to ``{core.labels.path_str: numpy}`` (the
port imports no JAX, so the caller does that). numpy cannot hold JAX's
bf16, so the arrays come as f32 and are cast here to ``cfg.dtype``;
bf16 -> f32 -> bf16 is exact, so the weights arrive bitwise equal.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .model import Params, flatten, param_shapes


def load_flat(flat: dict, cfg: ModelConfig, device=None) -> Params:
    """``{path_str: np.ndarray}`` -> :class:`Params` on ``device`` (cuda)."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    if set(flat) != set(shapes):
        raise KeyError(f"parameter paths differ from {cfg.name!r}'s: missing "
                       f"{sorted(set(shapes) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(shapes))}")
    out = {}
    for path, shape in shapes.items():
        a = np.asarray(flat[path])
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        out[path] = torch.tensor(a).to(device=device,
                                           dtype=cfg.torch_dtype)
    return Params(out)


def to_flat(params: Params) -> dict:
    """:class:`Params` -> ``{path_str: f32 np.ndarray}`` (inverse of load_flat)."""
    return {k: v.detach().float().cpu().numpy()
            for k, v in flatten(params).items()}


def _state_leaves(state) -> dict:
    """``{"count", "mu/<path>", "nu/<path>", "extra/...": tensor}``: the
    keys ``core.labels.path_str`` gives the JAX state (less its leading
    '.'): ``extra/norm_ema``, ``extra/max_ema/<path>``,
    ``extra/proj/<path>``."""
    out = {"count": state.count}
    for part in ("mu", "nu"):
        out.update(flatten(getattr(state, part), part))
    if state.extra is not None:
        out.update(flatten(state.extra, "extra"))
    return out


def _rebuild(tree, leaves: dict, prefix: str):
    """``tree`` with each leaf replaced by ``leaves[<its flat key>]``."""
    return {k: _rebuild(v, leaves, f"{prefix}/{k}") if hasattr(v, "items")
            else leaves[f"{prefix}/{k}"] for k, v in tree.items()}


def load_opt_state(flat: dict, params, tx, device=None):
    """``{"count", "mu/<path>", "nu/<path>", "extra/...": np.ndarray}`` ->
    the port's optimizer state for ``params`` under ``tx`` on ``device``
    (cuda), its host step count set from ``count``."""
    from repro_torch.core.pipeline import HostCount
    device = resolve_device(device)
    want = tx.init(params)
    like = _state_leaves(want)
    flat = {k.lstrip("."): v for k, v in flat.items()}
    if set(flat) != set(like):
        raise KeyError(f"optimizer state paths differ: missing "
                       f"{sorted(set(like) - set(flat))}, unexpected "
                       f"{sorted(set(flat) - set(like))}")
    got = {}
    for key, x in like.items():
        a = np.asarray(flat[key])
        if a.shape != tuple(x.shape):
            raise ValueError(f"{key}: shape {a.shape}, expected "
                             f"{tuple(x.shape)}")
        got[key] = torch.tensor(a).to(device=device, dtype=x.dtype)
    return want._replace(
        count=got["count"],
        mu=_rebuild(want.mu, got, "mu"), nu=_rebuild(want.nu, got, "nu"),
        extra=(None if want.extra is None
               else _rebuild(want.extra, got, "extra")),
        host_count=HostCount(int(got["count"])))


def opt_state_to_flat(state) -> dict:
    """The port's optimizer state -> ``{"count", "mu/<path>", "nu/<path>",
    "extra/...": np.ndarray}`` (f32 moments and extras, int32 count;
    inverse of load_opt_state)."""
    out = {}
    for k, x in _state_leaves(state).items():
        x = x.detach().cpu()
        out[k] = (x if k == "count" else x.float()).numpy()
    return out
