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
