"""Model building blocks (dense subset of ``repro.models.layers``).

Every module exposes ``<mod>_spec(cfg) -> {name: Spec}`` (shapes and
initializers) and ``apply_<mod>(p, cfg, ...)`` (forward). Parameters keep
the JAX package's names and layouts, so ``x @ p["wq"]`` multiplies by a
(D, H*hd) matrix here as there. Attention goes through
``kernels.dispatch.flash_attention``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import dispatch

from .config import ModelConfig
from .sharding import Rules


class Spec(NamedTuple):
    shape: tuple
    axes: tuple           # logical axis names (len == ndim; models.sharding)
    init: str = "normal"  # normal | zeros | ones


# ---------------------------------------------------------------- norms/rope

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # normalize in f32, cast back, and only then scale: reordering changes
    # bf16 results
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_tables(positions: torch.Tensor, dim: int, theta: float):
    """cos/sin tables for ``positions`` (any shape: (S,), or (B, S) for
    packed rows, whose positions restart at each document), last dim
    ``dim // 2``."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, n_heads, dim); cos/sin (..., S, dim/2). Half-split halves."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# ----------------------------------------------------------------- attention

def _attn_shardings(q, k, rules: Optional[Rules], mesh) -> dict:
    """q/kv shardings from the logical rules on ``mesh`` (none without
    one), as JAX's ``_route_attention`` derives them."""
    if mesh is None or rules is None:
        return {}
    axes = ("act_batch", None, "act_heads", None)
    return {"q_sharding": rules.sharding(axes, mesh, q.shape),
            "kv_sharding": rules.sharding(axes, mesh, k.shape)}


def causal_blockwise_attention(q, k, v, scale: float, segments=None, *,
                               rules: Optional[Rules] = None,
                               mesh=None) -> torch.Tensor:
    """Causal flash attention; kv may have fewer heads (GQA, never
    repeated). ``segments`` (a (q_seg, kv_seg) int32 pair) keeps packed
    documents apart. ``mesh``: the operands' shardings come from
    ``rules``."""
    return dispatch.flash_attention(q, k, v, scale=scale, causal=True,
                                    segments=segments,
                                    **_attn_shardings(q, k, rules, mesh))


def decode_attention(q, k, v, scale: float, kv_len=None) -> torch.Tensor:
    """Non-causal attention over a T-length cache, keys bounded by ``kv_len``."""
    return dispatch.flash_attention(q, k, v, scale=scale, causal=False,
                                    kv_len=kv_len)


def attn_spec(cfg: ModelConfig) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((D, H * hd), ("embed", "heads")),
        "wk": Spec((D, K * hd), ("embed", "kv")),
        "wv": Spec((D, K * hd), ("embed", "kv")),
        "wo": Spec((H * hd, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H * hd,), ("heads",), "zeros")
        s["bk"] = Spec((K * hd,), ("kv",), "zeros")
        s["bv"] = Spec((K * hd,), ("kv",), "zeros")
    return s


def apply_attention(p, cfg: ModelConfig, x, positions, mode: str = "train",
                    cache: Optional[dict] = None, cache_index=None,
                    segment_ids=None, rules: Optional[Rules] = None,
                    mesh=None):
    """GQA self-attention. mode: train | prefill | decode. -> (y, new_cache).

    prefill returns this call's (B, S, K, hd) k/v as the cache. decode
    writes k/v into ``cache`` at ``cache_index`` (a 0-d int32 tensor) IN
    PLACE — the JAX package returns an updated copy — and attends
    non-causally over the cache with ``kv_len = cache_index + S``.
    ``segment_ids`` (B, S) int32 keeps attention within the documents of
    packed rows (train and prefill; decode serves one document a row and
    raises, as the JAX ``mask_spec`` does for segments with ``kv_len``).
    """
    if mode == "decode" and segment_ids is not None:
        raise ValueError("apply_attention: segment_ids and decode's kv_len "
                         "are mutually exclusive (decode serves one "
                         "document per row)")
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, K, hd)
    v = v.reshape(B, S, K, hd)

    if cfg.pos_embed == "rope":
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = 1.0 / math.sqrt(hd)
    new_cache = cache
    if mode == "decode":
        idx = cache_index + torch.arange(S, device=x.device)
        ck, cv = cache["k"], cache["v"]
        ck.index_copy_(1, idx, k.to(ck.dtype))
        cv.index_copy_(1, idx, v.to(cv.dtype))
        out = decode_attention(q, ck, cv, scale, kv_len=cache_index + S)
    else:
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        seg = None if segment_ids is None else (segment_ids, segment_ids)
        out = causal_blockwise_attention(q, k, v, scale, segments=seg,
                                         rules=rules, mesh=mesh)

    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache


# --------------------------------------------------------------------- MLPs

def mlp_spec(cfg: ModelConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "gelu":  # gpt2-style 2-matrix MLP
        return {"w_up": Spec((D, Fd), ("embed", "mlp")),
                "w_down": Spec((Fd, D), ("mlp", "embed"))}
    return {"w_gate": Spec((D, Fd), ("embed", "mlp")),
            "w_up": Spec((D, Fd), ("embed", "mlp")),
            "w_down": Spec((Fd, D), ("mlp", "embed"))}


def apply_mlp(p, cfg: ModelConfig, x):
    if cfg.mlp_kind == "gelu":
        h = F.gelu(x @ p["w_up"], approximate="tanh")  # jax.nn.gelu's default
    else:
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
