"""Dense super-blocks and the loop over stacked layer params.

The JAX package scans each segment of homogeneous super-blocks over params
stacked on a leading (L, ...) axis; the port keeps that layout and loops in
Python. Each stacked tensor is cut into its L layers once per segment
(``unbind``), so the backward stacks each leaf's layer gradients once
instead of adding L full-size zero-padded slices; caches are indexed per
layer.

Rematerialization follows ``cfg.remat`` when a gradient is being taken
(grad mode on, no cache), as ``jax.checkpoint`` around each super-block
does there: ``"full"`` saves nothing inside a super-block and recomputes
its forward in the backward (``nothing_saveable``); ``"dots"`` saves the
outputs of the 2-D matrix products and recomputes the rest
(``dots_with_no_batch_dims_saveable``); ``"none"`` saves everything.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from . import layers as L
from .config import ModelConfig


def _sub_spec(cfg: ModelConfig, sub: str) -> dict:
    spec = L.attn_spec(cfg) if sub == "attn" else L.mlp_spec(cfg)
    return {"norm": L.Spec((cfg.d_model,), "ones"), **spec}


def _apply_sub(sub: str, p, cfg: ModelConfig, x, positions, mode: str, cache,
               cache_index):
    """Pre-norm residual sub-layer (attn or mlp). Returns (x, new_cache)."""
    h = L.rmsnorm(x, p["norm"], cfg.rms_eps)
    if sub == "attn":
        y, cache = L.apply_attention(p, cfg, h, positions, mode, cache,
                                     cache_index)
    else:
        y = L.apply_mlp(p, cfg, h)
    return x + y.to(x.dtype), cache


def superblock_layout(cfg: ModelConfig, kind: str) -> tuple:
    """Ordered (name, sub_kind) pairs of one super-block."""
    if kind == "dense":
        return (("attn", "attn"), ("ffn", "mlp"))
    raise NotImplementedError(f"super-block kind {kind!r} is not yet ported "
                              "to repro_torch")


def superblock_spec(cfg: ModelConfig, kind: str) -> dict:
    return {name: _sub_spec(cfg, sub)
            for name, sub in superblock_layout(cfg, kind)}


def superblock_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype, device) -> dict:
    """Zero KV cache for one super-block."""
    out = {}
    for name, sub in superblock_layout(cfg, kind):
        if sub == "attn":
            kshape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
            out[name] = {"k": torch.zeros(kshape, dtype=dtype, device=device),
                         "v": torch.zeros(kshape, dtype=dtype, device=device)}
    return out


def _layer(tree, l: int):
    """Layer ``l`` of a (nested) dict of stacked tensors, as views."""
    return {n: _layer(t, l) if hasattr(t, "items") else t[l]
            for n, t in tree.items()}


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a (nested) dict of stacked tensors: one
    ``unbind`` per leaf, whose backward stacks the layer gradients once."""
    leaves = {k: _unbind(t, n) if hasattr(t, "items") else t.unbind(0)
              for k, t in tree.items()}
    return [{k: v[l] for k, v in leaves.items()} for l in range(n)]


# the 2-D matrix products (x @ w reaches aten.mm): what "dots" saves
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under ``cfg.remat`` (see the module docstring)."""
    if cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat must be none|dots|full, got {cfg.remat!r}")
    # the model draws no random numbers, so no RNG state is kept
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **kw)


def apply_superblock(kind: str, cfg: ModelConfig, params, x, positions,
                     mode: str, cache: Optional[dict], cache_index):
    new_cache = dict(cache) if cache is not None else None
    for name, sub in superblock_layout(cfg, kind):
        sub_cache = cache.get(name) if (cache is not None and sub == "attn") \
            else None
        x, sub_cache = _apply_sub(sub, params[name], cfg, x, positions, mode,
                                  sub_cache, cache_index)
        if new_cache is not None and sub == "attn":
            new_cache[name] = sub_cache
    return x, new_cache


def apply_segment(kind: str, n_blocks: int, cfg: ModelConfig, stacked, x,
                  positions, mode: str, cache, cache_index):
    """Run ``n_blocks`` super-blocks over stacked params (and cache).

    -> (x, new_cache). prefill returns the S-length caches stacked to
    (L, B, S, K, hd); decode writes the stacked cache in place and returns
    it; train returns None.
    """
    layers = _unbind(stacked, n_blocks)
    if cache is None:
        block = functools.partial(apply_superblock, kind, cfg)
        if torch.is_grad_enabled():
            block = _remat(cfg, block)
        for p in layers:
            x, _ = block(p, x, positions, mode, None, cache_index)
        return x, None
    outs = []
    for l, p in enumerate(layers):
        x, c = apply_superblock(kind, cfg, p, x, positions, mode,
                                _layer(cache, l), cache_index)
        outs.append(c)
    if mode == "decode":
        return x, cache
    return x, _stack(outs)


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {n: _stack([t[n] for t in trees]) for n in first}
    return torch.stack(trees)
