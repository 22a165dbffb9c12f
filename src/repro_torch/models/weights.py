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


def load_opt_state(flat: dict, params, tx, device=None):
    """``{"count", "mu/<path>", "nu/<path>": np.ndarray}`` -> the port's
    optimizer state for ``params`` under ``tx`` on ``device`` (cuda)."""
    device = resolve_device(device)
    want = tx.init(params)
    flat = {k.lstrip("."): v for k, v in flat.items()}
    keys = {"count", *(f"{part}/{k}" for part in ("mu", "nu")
                       for k in getattr(want, part))}
    if set(flat) != keys:
        raise KeyError(f"optimizer state paths differ: missing "
                       f"{sorted(keys - set(flat))}, unexpected "
                       f"{sorted(set(flat) - keys)}")

    def cast(key, like):
        a = np.asarray(flat[key])
        if a.shape != tuple(like.shape):
            raise ValueError(f"{key}: shape {a.shape}, expected "
                             f"{tuple(like.shape)}")
        return torch.tensor(a).to(device=device, dtype=like.dtype)

    return want._replace(
        count=cast("count", want.count),
        mu={k: cast(f"mu/{k}", x) for k, x in want.mu.items()},
        nu={k: cast(f"nu/{k}", x) for k, x in want.nu.items()})


def opt_state_to_flat(state) -> dict:
    """The port's optimizer state -> ``{"count", "mu/<path>", "nu/<path>"}``
    numpy (f32 moments, int32 count; inverse of load_opt_state)."""
    out = {"count": state.count.detach().cpu().numpy()}
    for part in ("mu", "nu"):
        for k, x in getattr(state, part).items():
            out[f"{part}/{k}"] = x.detach().float().cpu().numpy()
    return out
