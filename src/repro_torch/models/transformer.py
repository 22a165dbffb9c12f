"""Super-blocks (dense: self-attn + SwiGLU; moe: self-attn + MoE; ssm: one
Mamba2 layer, attention-free and without an FFN; vlm: cross-attn + MLP,
then ``cross_attn_every - 1`` x [self-attn + MLP]; hybrid: self-attn +
MLP, then ``hybrid_period - 1`` Mamba2 layers, each followed by an FFN
that is MoE at odd positions and MLP at even ones) and the loop over
stacked layer params. The self-attention sub-layer is GQA or MLA by
``cfg.attention_kind``, as in JAX. The attention and Mamba2 sub-layers
keep a cache (``_CACHED``, JAX's ``_needs_cache``), so a hybrid
super-block's cache holds both kinds; the VLM's cross sub-layer keeps
none (its keys and values are recomputed from the image embeddings at
every call, as JAX does).

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
(``dots_with_no_batch_dims_saveable``: the projections reach ``aten.mm``
and are saved, Mamba2's SSD products and the MoE einsums reach
``aten.bmm`` and are recomputed); ``"none"`` saves everything.

The MoE load-balance loss (``aux``) is an output of each super-block, and
so of each remat block: the recomputed forward routes the tokens as the
first did. The segment sums its layers' ``aux``; a segment without an MoE
sub-layer returns None for it.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils import checkpoint as _ckpt

from . import layers as L
from .config import ModelConfig
from .sharding import lay_out, shard


_SPECS = {"mlp": L.mlp_spec, "moe": L.moe_spec, "mamba": L.mamba_spec}
# the sub-layers that keep a cache (JAX's _needs_cache)
_CACHED = ("attn", "mamba")
# attention_kind -> (spec, apply, cache) of the self-attention sub-layer
_ATTENTION = {"gqa": (L.attn_spec, L.apply_attention, L.attn_cache),
              "mla": (L.mla_spec, L.apply_mla_attention, L.mla_cache)}


def _attention(cfg: ModelConfig) -> tuple:
    """(spec, apply, cache) of ``cfg.attention_kind``; any other kind
    raises."""
    if cfg.attention_kind not in _ATTENTION:
        raise ValueError(f"attention_kind must be one of {tuple(_ATTENTION)}, "
                         f"got {cfg.attention_kind!r}")
    return _ATTENTION[cfg.attention_kind]


def _sub_spec(cfg: ModelConfig, sub: str) -> dict:
    if sub == "attn":
        spec = _attention(cfg)[0](cfg)
    elif sub == "cross":
        spec = L.attn_spec(cfg, cross=True)
    else:
        spec = _SPECS[sub](cfg)
    return {"norm": L.Spec((cfg.d_model,), ("norm",), "ones"), **spec}


def _apply_sub(sub: str, p, cfg: ModelConfig, x, positions, mode: str, cache,
               cache_index, segment_ids=None, rules=None, mesh=None,
               image_embeds=None):
    """Pre-norm residual sub-layer (attn, cross, mlp, moe or mamba).
    Returns (x, new_cache, aux); aux is None but for moe. mamba takes no
    ``segment_ids``: its sequence mixing has no segment mask, as in JAX;
    nor does cross (image keys are not packed). Any other sub-layer kind
    raises ``ValueError``, as JAX's does.

    cross runs in mode "train" whatever ``mode`` is, without a cache, as
    JAX's does. Without ``image_embeds`` JAX's ``apply_attention`` gets
    no ``kv_source`` and so runs causal self-attention with RoPE over the
    text with the cross weights (and during decode over the current token
    alone, having no cache); the port does the same (ROADMAP.md reference
    caveat 14)."""
    h = L.rmsnorm(x, p["norm"], cfg.rms_eps)
    aux = None
    if sub == "attn":
        y, cache = _attention(cfg)[1](p, cfg, h, positions, mode, cache,
                                      cache_index, segment_ids, rules=rules,
                                      mesh=mesh)
    elif sub == "cross":
        y, _ = L.apply_attention(p, cfg, h, positions, "train", rules=rules,
                                 mesh=mesh, kv_source=image_embeds)
    elif sub == "moe":
        y, aux = L.apply_moe(p, cfg, h, rules=rules, mesh=mesh)
    elif sub == "mamba":
        y, cache = L.apply_mamba(p, cfg, h, mode, cache, rules=rules,
                                 mesh=mesh)
    elif sub == "mlp":
        y = L.apply_mlp(p, cfg, h)
    else:
        raise ValueError(sub)
    return x + y.to(x.dtype), cache, aux


def superblock_layout(cfg: ModelConfig, kind: str) -> tuple:
    """Ordered (name, sub_kind) pairs of one super-block."""
    if kind == "dense":
        return (("attn", "attn"), ("ffn", "mlp"))
    if kind == "moe":
        return (("attn", "attn"), ("ffn", "moe"))
    if kind == "ssm":
        return (("mamba", "mamba"),)
    if kind == "vlm":
        out = [("cross", "cross"), ("cross_ffn", "mlp")]
        for i in range(1, cfg.cross_attn_every):
            out += [(f"attn{i}", "attn"), (f"ffn{i}", "mlp")]
        return tuple(out)
    if kind == "hybrid":
        out = [("attn", "attn"), ("ffn0", "mlp")]
        for i in range(1, cfg.hybrid_period):
            out.append((f"mamba{i}", "mamba"))
            out.append((f"ffn{i}", "moe" if i % 2 == 1 else "mlp"))
        return tuple(out)
    raise ValueError(kind)


def superblock_spec(cfg: ModelConfig, kind: str) -> dict:
    return {name: _sub_spec(cfg, sub)
            for name, sub in superblock_layout(cfg, kind)}


def superblock_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     dtype, device) -> dict:
    """Zero cache for each sub-layer of one super-block that keeps one:
    attention in the layout of ``cfg.attention_kind``
    (``layers.attn_cache``, ``layers.mla_cache``), Mamba2's fixed-size
    conv and SSM states (``layers.mamba_cache``)."""
    out = {}
    for name, sub in superblock_layout(cfg, kind):
        if sub == "attn":
            out[name] = _attention(cfg)[2](cfg, batch, max_seq, dtype, device)
        elif sub == "mamba":
            out[name] = L.mamba_cache(cfg, batch, dtype, device)
    return out


def cache_axes(cfg: ModelConfig, kind: str) -> dict:
    """The logical axes of one super-block's stacked (L, ...) cache, per
    sub-layer that keeps one, JAX's."""
    out = {}
    for name, sub in superblock_layout(cfg, kind):
        if sub == "attn":
            if cfg.attention_kind == "mla":
                out[name] = {"ckv": (None, "cache_batch", "cache_seq",
                                     "cache_kv"),
                             "krope": (None, "cache_batch", "cache_seq",
                                       None, None)}
            else:
                ax = (None, *L.CACHE_KV_AXES)
                out[name] = {"k": ax, "v": ax}
        elif sub == "mamba":
            out[name] = {"conv": (None, "cache_batch", None, "ssm_inner"),
                         "ssm": (None, "cache_batch", None, None, None)}
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
                     mode: str, cache: Optional[dict], cache_index,
                     segment_ids=None, image_embeds=None, rules=None,
                     mesh=None):
    """-> (x, new_cache, aux): aux sums the MoE sub-layers' (None without
    one). ``image_embeds`` (B, T, D) reach the cross sub-layers."""
    new_cache = dict(cache) if cache is not None else None
    aux = None
    for name, sub in superblock_layout(cfg, kind):
        sub_cache = cache.get(name) if (cache is not None
                                        and sub in _CACHED) else None
        x, sub_cache, a = _apply_sub(sub, params[name], cfg, x, positions,
                                     mode, sub_cache, cache_index,
                                     segment_ids, rules=rules, mesh=mesh,
                                     image_embeds=image_embeds)
        if mesh is not None and mode == "prefill" and sub == "mamba":
            # one layer's Mamba2 cache laid out per JAX's cache_axes
            axes = cache_axes(cfg, kind)[name]
            sub_cache = {k: lay_out(v, rules.sharding(axes[k][1:], mesh,
                                                      v.shape))
                         for k, v in sub_cache.items()}
        if new_cache is not None and sub in _CACHED:
            new_cache[name] = sub_cache
        if a is not None:
            aux = a if aux is None else aux + a
    if rules is not None:
        # the residual carried between layers (JAX's scan carry)
        x = shard(x, ("act_batch", "act_seq", "act_residual"), rules, mesh)
    return x, new_cache, aux


def apply_segment(kind: str, n_blocks: int, cfg: ModelConfig, stacked, x,
                  positions, mode: str, cache, cache_index, segment_ids=None,
                  image_embeds=None, rules=None, mesh=None):
    """Run ``n_blocks`` super-blocks over stacked params (and cache).

    -> (x, new_cache, aux), aux the sum of the layers' (None for a segment
    without MoE). prefill returns the S-length caches stacked to
    (L, B, S, K, hd) (MLA: (L, B, S, kv_lora_rank) and (L, B, S, 1,
    qk_rope_dim); Mamba2: its fixed-size states, (L, B, dconv-1,
    conv_dim) and (L, B, nh, N, hd)); decode writes the stacked cache in
    place and returns it; train returns None. ``segment_ids`` (packed
    rows) and ``image_embeds`` (the VLM's) are tensor arguments of each
    remat block, so a recomputed forward masks and attends as the first
    did. ``rules`` and ``mesh``: see ``model.forward``.
    """
    layers = _unbind(stacked, n_blocks)
    auxs = []
    if cache is None:
        block = functools.partial(apply_superblock, kind, cfg, rules=rules,
                                  mesh=mesh)
        if torch.is_grad_enabled():
            block = _remat(cfg, block)
        for p in layers:
            x, _, aux = block(p, x, positions, mode, None, cache_index,
                              segment_ids, image_embeds)
            auxs.append(aux)
        return x, None, _sum_aux(auxs)
    outs = []
    for l, p in enumerate(layers):
        x, c, aux = apply_superblock(kind, cfg, p, x, positions, mode,
                                     _layer(cache, l), cache_index,
                                     segment_ids, image_embeds, rules=rules,
                                     mesh=mesh)
        outs.append(c)
        auxs.append(aux)
    if mode == "decode":
        return x, cache, _sum_aux(auxs)
    return x, _stack(outs), _sum_aux(auxs)


def _sum_aux(auxs: list):
    """The layers' aux summed as JAX's ``jnp.sum`` over the scan's stack;
    None when no layer has one."""
    if auxs[0] is None:
        return None
    return torch.stack(auxs).sum()


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {n: _stack([t[n] for t in trees]) for n in first}
    return torch.stack(trees)
