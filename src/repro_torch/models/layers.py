"""Model building blocks (the GQA self- and cross-attention, MLA, dense,
MoE and Mamba2 subset of ``repro.models.layers``).

Every module exposes ``<mod>_spec(cfg) -> {name: Spec}`` (shapes and
initializers) and ``apply_<mod>(p, cfg, ...)`` (forward). Parameters keep
the JAX package's names and layouts, so ``x @ p["wq"]`` multiplies by a
(D, H*hd) matrix here as there. Attention goes through
``kernels.dispatch.flash_attention`` (MLA's absorbed decode excepted:
plain products, as in JAX); the MoE layer's products and Mamba2's chunked
SSD are the JAX package's einsums, which it computes outside any Pallas
kernel too.
"""
from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.kernels import dispatch

from .config import ModelConfig
from .sharding import (NamedSharding, P, Rules, axes_size, gather,
                       grad_psum, is_dtensor, lay_out, pmean, psum,
                       psum_shared, scatter, shard, shard_index,
                       spec_mesh_axes, spec_of, wrap)


class Spec(NamedTuple):
    shape: tuple
    axes: tuple           # logical axis names (len == ndim; models.sharding)
    # normal | zeros | ones | small (the router) | alog | dtbias (Mamba2's
    # A_log and dt_bias; models.model.init_params)
    init: str = "normal"


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


def decode_attention(q, k, v, scale: float, kv_len=None, *,
                     mesh=None) -> torch.Tensor:
    """Non-causal attention over a T-length cache, keys bounded by
    ``kv_len``. ``mesh``: the cache DTensors laid out per JAX's
    ("cache_batch", "cache_seq", None, "cache_kv"), through
    ``dispatch.decode_attention``'s plan for their layout (a T split over
    "model": each rank's shard on the kernel, the partials combined by
    their lse)."""
    if mesh is None:
        return dispatch.flash_attention(q, k, v, scale=scale, causal=False,
                                        kv_len=kv_len)
    return dispatch.decode_attention(q, k, v, scale=scale, kv_len=kv_len)


# the layout of one layer's GQA cache (B, T, K, hd): JAX's decode
# annotation of it (``transformer.cache_axes`` less the layer axis)
CACHE_KV_AXES = ("cache_batch", "cache_seq", None, "cache_kv")


def write_cache(c, new, index) -> None:
    """Write ``new`` (B, S, K, hd) into the cache ``c`` (B, T, K, hd) at
    positions ``index`` .. ``index`` + S - 1 IN PLACE (``index`` a 0-d
    int32 tensor on the device, never read on the host).

    On a mesh ``c`` is a DTensor (its T split over "model": this rank
    holds positions [r T_l, (r + 1) T_l)). Each rank writes its local
    shard, and only where it owns the position: the local rows at the
    positions mod T_l are read and ``where(owned, new, old)`` written
    back, so a rank that owns none writes back what it holds. The S
    positions are consecutive, so mod T_l keeps them apart (S <= T_l)."""
    S = new.shape[1]
    if not is_dtensor(c):
        c.index_copy_(1, index + torch.arange(S, device=c.device),
                      new.to(c.dtype))
        return
    sh = spec_of(c)
    per = spec_mesh_axes(sh.spec, 4)
    if any(per[2]) or any(per[3]):
        raise NotImplementedError(
            f"write_cache: the cache layout {sh.spec} shards its kv heads "
            "or head dim; the decode write takes its batch and T sharded")
    local = c.to_local()
    T_l = local.shape[1]
    if S > T_l:
        raise NotImplementedError(f"write_cache: {S} positions over a "
                                  f"shard of {T_l}")
    new_l = lay_out(new, NamedSharding(sh.mesh, P(per[0] or None, None,
                                                  None, None))).to_local()
    pos = (index + torch.arange(S, device=local.device)
           - shard_index(sh.mesh, per[1]) * T_l)
    slot = pos.remainder(T_l)
    owned = ((pos >= 0) & (pos < T_l))[None, :, None, None]
    old = local.index_select(1, slot)
    local.index_copy_(1, slot, torch.where(owned, new_l.to(c.dtype), old))


def attn_spec(cfg: ModelConfig, cross: bool = False) -> dict:
    """q/k/v/o projections; the q/k/v biases under ``qkv_bias``, but never
    for a cross sub-layer (``cross``), as in JAX."""
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": Spec((D, H * hd), ("embed", "heads")),
        "wk": Spec((D, K * hd), ("embed", "kv")),
        "wv": Spec((D, K * hd), ("embed", "kv")),
        "wo": Spec((H * hd, D), ("heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        s["bq"] = Spec((H * hd,), ("heads",), "zeros")
        s["bk"] = Spec((K * hd,), ("kv",), "zeros")
        s["bv"] = Spec((K * hd,), ("kv",), "zeros")
    return s


def attn_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device) -> dict:
    """Zero GQA cache: k and v (B, max_seq, K, hd)."""
    kshape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(kshape, dtype=dtype, device=device),
            "v": torch.zeros(kshape, dtype=dtype, device=device)}


def apply_attention(p, cfg: ModelConfig, x, positions, mode: str = "train",
                    cache: Optional[dict] = None, cache_index=None,
                    segment_ids=None, rules: Optional[Rules] = None,
                    mesh=None, kv_source: Optional[torch.Tensor] = None):
    """GQA self-attention, or cross-attention when ``kv_source`` (B, T, D)
    is given. mode: train | prefill | decode. -> (y, new_cache).

    prefill returns this call's (B, S, K, hd) k/v as the cache. decode
    writes k/v into ``cache`` at ``cache_index`` (a 0-d int32 tensor) IN
    PLACE — the JAX package returns an updated copy — and attends
    non-causally over the cache with ``kv_len = cache_index + S``.
    ``segment_ids`` (B, S) int32 keeps attention within the documents of
    packed rows (train and prefill; decode serves one document a row and
    raises, as the JAX ``mask_spec`` does for segments with ``kv_len``).

    Cross-attention (the VLM's ``cross`` sub-layer, which runs in mode
    "train" whatever the model's, as in JAX): keys and values are
    ``kv_source``'s, neither q nor k is rotated, nothing is cached, and
    the attention over the T keys is non-causal with no ``kv_len`` (a
    single query on the decode kernel). The keys and values are recomputed
    from ``kv_source`` at every call, as JAX does (it keeps no cross
    cache either). The profiler sees the image keys' and values'
    projections as the span ``cross_kv`` and the attention over them as
    ``cross_attn``.

    ``mesh`` (x, ``p`` and ``kv_source`` DTensors laid out per ``rules``):
    the attention takes ``dispatch.flash_attention``'s sharded plan from
    the rules' ("act_batch", None, "act_heads", None) layout of q and kv,
    each rank on its (B/n, S, H/m, hd) x (B/n, T, K/m, hd) shard; q, k and
    v are first laid out per JAX's ("act_batch", "act_seq", "act_heads" /
    "act_kv") annotation at whole heads (``_whole_heads``; the cross
    sub-layer's keys and values in ``_cross_kv``). In mode decode the
    cache is ``models.model.init_cache``'s on the mesh (T over "model"):
    ``write_cache`` writes each rank's shard, and ``decode_attention``
    runs ``dispatch.decode_attention``'s plan for that layout.
    """
    if mode == "decode" and segment_ids is not None:
        raise ValueError("apply_attention: segment_ids and decode's kv_len "
                         "are mutually exclusive (decode serves one "
                         "document per row)")
    B, S, D = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    T = S if kv_source is None else kv_source.shape[1]

    q = x @ p["wq"]
    if kv_source is None:
        k, v = x @ p["wk"], x @ p["wv"]
    else:
        with record_function("cross_kv"):
            k, v = _cross_kv(p, cfg, kv_source, rules, mesh)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if mesh is not None and is_dtensor(q):
        q = _whole_heads(q, "act_heads", H, rules, mesh)
        if kv_source is None:
            k, v = (_whole_heads(t, "act_kv", K, rules, mesh) for t in (k, v))
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, T, K, hd)
    v = v.reshape(B, T, K, hd)

    if kv_source is None and cfg.pos_embed == "rope":
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    scale = 1.0 / math.sqrt(hd)
    new_cache = cache
    if kv_source is not None:
        out = _cross_attention(q, k, v, scale, rules, mesh)
    elif mode == "decode":
        ck, cv = cache["k"], cache["v"]
        write_cache(ck, k, cache_index)
        write_cache(cv, v, cache_index)
        out = decode_attention(q, ck, cv, scale, kv_len=cache_index + S,
                               mesh=mesh)
    else:
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
        seg = None if segment_ids is None else (segment_ids, segment_ids)
        out = causal_blockwise_attention(q, k, v, scale, segments=seg,
                                         rules=rules, mesh=mesh)

    y = out.reshape(B, S, H * hd) @ p["wo"]
    return y, new_cache


def _cross_kv(p, cfg: ModelConfig, images, rules: Optional[Rules] = None,
              mesh=None):
    """The image keys and values (B, T, K*hd), before any bias (a cross
    sub-layer has none).

    JAX's cross-attention mixes dtypes (ROADMAP.md reference caveat 13):
    f32 images against a bf16 model's wk and wv promote k and v to f32
    there. Torch's ``@`` refuses mixed dtypes, so the promotion is spelled
    out; the weights' gradients come back through the cast in their own
    dtype, as JAX's do. ``mesh``: k and v laid out per ("act_batch",
    "act_seq", "act_kv"), JAX's annotation of them, with the
    divisibility guard at whole kv heads: a split of the K*hd columns
    that cuts a head (2 kv heads over "model" 4) could not be viewed as
    (B, T, K, hd), so those heads stay whole, as the attention's own
    ("act_batch", None, "act_heads", None) layout has them."""
    dt = torch.promote_types(images.dtype, p["wk"].dtype)
    x = images.to(dt)
    k, v = x @ p["wk"].to(dt), x @ p["wv"].to(dt)
    if mesh is not None and is_dtensor(k):
        k, v = (_whole_heads(t, "act_kv", cfg.n_kv_heads, rules, mesh)
                for t in (k, v))
    return k, v


def _whole_heads(x, heads_axis: str, n: int, rules: Rules, mesh):
    """x (B, S, n*hd) laid out per ("act_batch", "act_seq", ``heads_axis``),
    JAX's annotation of q, k and v before their reshape, with the
    divisibility guard at whole heads (at (B, S, n)): a split of the
    columns that cuts a head (2 kv heads over "model" 4) could not be
    viewed as (B, S, n, hd), so those heads stay whole."""
    return lay_out(x, rules.sharding(("act_batch", "act_seq", heads_axis),
                                     mesh, (*x.shape[:2], n)))


def _cross_attention(q, k, v, scale: float, rules: Optional[Rules] = None,
                     mesh=None) -> torch.Tensor:
    """Non-causal attention of the text queries over the image keys, with
    no ``kv_len`` (JAX's ``cross_blockwise_attention``, and its
    ``decode_attention`` for one query: the attention wrappers route S <=
    4 to their decode kernel themselves). -> q's dtype.

    Where k and v came out f32 beside a bf16 q (f32 images in a bf16
    model; caveat 13), JAX's kernel forms q.k in f32, casts p to v's f32 and returns
    q's dtype, its dQ in q's dtype and dK, dV in f32. The port's kernels
    take one dtype, so q is promoted here and the f32 kernels (the fma
    route) compute that arithmetic; the cast back gives dQ in q's dtype.
    Images in the model's dtype keep everything bf16, on the tensor-core
    route. ``mesh``: q and kv take JAX's ("act_batch", None, "act_heads",
    None) shardings (``_attn_shardings``), so each rank runs the kernels on
    its rows and its heads; a layout the plan sends to "ref" (heads their
    axes do not divide) runs the plain version on the CPU and raises on
    the card."""
    qa = q.to(torch.promote_types(q.dtype, k.dtype))
    with record_function("cross_attn"):
        out = dispatch.flash_attention(qa, k, v, scale=scale, causal=False,
                                       **_attn_shardings(qa, k, rules, mesh))
    return out.to(q.dtype)


# ------------------------------------------------------------- MLA attention

def mla_spec(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    qlr, kvlr = cfg.q_lora_rank, cfg.kv_lora_rank
    return {
        "wq_a": Spec((D, qlr), ("embed", "lora")),
        "q_norm": Spec((qlr,), ("norm",), "ones"),
        "wq_b": Spec((qlr, H * (qn + qr)), ("lora", "heads")),
        "wkv_a": Spec((D, kvlr + qr), ("embed", "lora")),
        "kv_norm": Spec((kvlr,), ("norm",), "ones"),
        "wkv_b": Spec((kvlr, H * (qn + vd)), ("lora", "heads")),
        "wo": Spec((H * vd, D), ("heads", "embed")),
    }


def mla_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
              device) -> dict:
    """Zero MLA cache: the latent ckv (B, max_seq, kv_lora_rank) and the
    shared rope key krope (B, max_seq, 1, qk_rope_dim)."""
    return {"ckv": torch.zeros((batch, max_seq, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_seq, 1, cfg.qk_rope_dim),
                                 dtype=dtype, device=device)}


def apply_mla_attention(p, cfg: ModelConfig, x, positions, mode: str = "train",
                        cache: Optional[dict] = None, cache_index=None,
                        segment_ids=None, rules: Optional[Rules] = None,
                        mesh=None):
    """Multi-head Latent Attention (DeepSeek-V2/V3), JAX's
    ``apply_mla_attention``. mode: train | prefill | decode. -> (y,
    new_cache).

    The cache holds only the normalized kv latent ``ckv`` (B, T,
    kv_lora_rank) and the one rope key head every query head shares,
    ``krope`` (B, T, 1, qk_rope_dim). train and prefill expand the latent
    into per-head keys (qk_nope_dim + qk_rope_dim wide) and values
    (v_head_dim wide) and run causal flash attention with H == K: the
    only attention in the model whose key width differs from its value
    width. prefill returns this call's S-length latents as the cache.
    decode writes them into ``cache`` at ``cache_index`` IN PLACE (as
    ``apply_attention`` does) and runs the absorbed form
    (``_mla_absorbed``). ``segment_ids``: as ``apply_attention`` (train
    and prefill; decode raises). The profiler sees the projections as the
    span ``mla_proj`` and the absorbed decode as ``mla_decode``.

    ``mesh`` (train and prefill; x and ``p`` DTensors laid out per
    ``rules``): JAX's layouts. The latents ``cq``, ``c_kv`` and ``k_rope``
    take their "lora" / None axes (replicated over "model"); ``wq_b`` and
    ``wkv_b`` give per-head columns and ``wo``'s rows sum over the heads'
    axes. q_full, k_full and vv are laid out per ("act_batch", None,
    "act_heads", None), the shared rope key head expanded to each rank's
    heads after its layout is fixed (``_shared_head``), and the attention
    takes ``dispatch.flash_attention``'s sharded plan. Decode on a mesh
    (sharded serving) raises ``NotImplementedError`` before any work.
    """
    if mode == "decode" and segment_ids is not None:
        raise ValueError("apply_mla_attention: segment_ids are not taken in "
                         "decode (decode serves one document per row)")
    if mode == "decode" and mesh is not None:
        raise NotImplementedError(MLA_DECODE_ON_A_MESH)
    B, S, D = x.shape
    H = cfg.n_heads
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvlr = cfg.kv_lora_rank

    with record_function("mla_proj"):
        cq = rmsnorm(x @ p["wq_a"], p["q_norm"], cfg.rms_eps)
        q = (cq @ p["wq_b"]).reshape(B, S, H, qn + qr)
        q_nope, q_rope = q[..., :qn], q[..., qn:]

        kv_a = x @ p["wkv_a"]
        c_kv, k_rope = kv_a[..., :kvlr], kv_a[..., kvlr:]
        c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.rms_eps)

        cos, sin = rope_tables(positions, qr, cfg.rope_theta)
        q_rope = apply_rope(q_rope, cos, sin)
        k_rope = apply_rope(k_rope[..., None, :], cos, sin)  # one shared head

    scale = 1.0 / math.sqrt(qn + qr)
    new_cache = cache
    if mode == "decode":
        with record_function("mla_decode"):
            idx = cache_index + torch.arange(S, device=x.device)
            ckv, krope = cache["ckv"], cache["krope"]
            ckv.index_copy_(1, idx, c_kv.to(ckv.dtype))
            krope.index_copy_(1, idx, k_rope.to(krope.dtype))
            out = _mla_absorbed(p, cfg, q_nope, q_rope, ckv, krope,
                                cache_index + S, scale)
    else:
        if mode == "prefill":
            new_cache = {"ckv": c_kv, "krope": k_rope}
        with record_function("mla_proj"):
            # the latents expanded to per-head keys and values
            kv = (c_kv @ p["wkv_b"]).reshape(B, S, H, qn + vd)
            k_nope, vv = kv[..., :qn], kv[..., qn:]
            if mesh is None:
                k_rope_h = k_rope.expand(B, S, H, qr)
            else:
                k_rope_h = _shared_head(k_rope, H, rules, mesh)
            k_full = torch.cat([k_nope, k_rope_h], -1)
            q_full = torch.cat([q_nope, q_rope], -1)
            if mesh is not None:
                q_full = shard(q_full, ("act_batch", "act_seq", "act_heads",
                                        None), rules, mesh)
                k_full = shard(k_full, ("act_batch", None, "act_heads",
                                        None), rules, mesh)
                vv = shard(vv, ("act_batch", None, "act_heads", None), rules,
                           mesh)
        seg = None if segment_ids is None else (segment_ids, segment_ids)
        out = causal_blockwise_attention(q_full, k_full, vv, scale,
                                         segments=seg, rules=rules, mesh=mesh)
    with record_function("mla_proj"):
        y = out.reshape(B, S, H * vd) @ p["wo"]
    return y, new_cache


MLA_DECODE_ON_A_MESH = (
    "apply_mla_attention: decode on a mesh (the absorbed decode over a "
    "sequence-sharded latent cache) is sharded serving, not ported yet; "
    "ROADMAP.md Queue 1 item 12 (its leftovers)")


def _shared_head(k_rope, H: int, rules: Rules, mesh):
    """MLA's one rope key head (B, S, 1, qr) expanded to the H query heads
    on a mesh, laid out per ("act_batch", None, "act_heads", None): each
    rank expands its local rows to its own heads, with no communication.
    The gradient of a rank's heads sums over them into a partial sum of
    the one head, summed over the head axes on the way back (the partial
    sum XLA makes of JAX's broadcast; DTensor's own route would gather the
    H-head gradient)."""
    from torch.distributed.tensor import Partial
    B, S, _, qr = k_rope.shape
    head = rules.sharding(("act_batch", None, "act_heads", None), mesh,
                          (B, S, H, qr))
    one = lay_out(k_rope, rules.sharding(("act_batch", None, None, None),
                                         mesh, k_rope.shape))
    heads = spec_mesh_axes(head.spec, 4)[2]
    grad = tuple(Partial() if name in heads else pl for name, pl in
                 zip(mesh.mesh_dim_names, one.placements))
    local = one.to_local(grad_placements=grad)
    n = H // axes_size(mesh, heads)
    return wrap(local.expand(local.shape[0], S, n, qr), head, (B, S, H, qr))


def _mla_absorbed(p, cfg: ModelConfig, q_nope, q_rope, ckv, krope, kv_len,
                  scale: float):
    """MLA decode against the latent cache (DeepSeek's absorbed form, JAX's
    decode branch): ``wkv_b`` folded into the query (``q_lat``) and the
    output (``out_lat @ wv``), so no T-length key or value is expanded.
    Plain products, as in JAX (no Pallas kernel there), in the model
    dtype; the scores turn f32 after ``s_lat + s_rope``, keys at or past
    ``kv_len`` are masked and the softmax is f32. -> (B, S, H, v_head_dim).
    """
    H, qn, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    T = ckv.shape[1]
    wkv = p["wkv_b"].reshape(cfg.kv_lora_rank, H, qn + vd)
    wk, wv = wkv[..., :qn], wkv[..., qn:]
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope, wk)         # (B,S,H,kvlr)
    s_lat = torch.einsum("bqhk,btk->bhqt", q_lat, ckv)
    s_rope = torch.einsum("bqhr,btr->bhqt", q_rope, krope[:, :, 0])
    s = (s_lat + s_rope).float() * scale
    s = s.masked_fill(torch.arange(T, device=s.device) >= kv_len,
                      float("-inf"))
    pattn = torch.softmax(s, dim=-1)
    out_lat = torch.einsum("bhqt,btk->bqhk", pattn.to(q_nope.dtype), ckv)
    return torch.einsum("bqhk,khv->bqhv", out_lat, wv)


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


# ---------------------------------------------------------------------- MoE

def moe_spec(cfg: ModelConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    s = {
        "router": Spec((D, E), ("embed", None), "small"),
        "w_gate": Spec((E, D, Fd), ("experts", "embed", "expert_mlp")),
        "w_up": Spec((E, D, Fd), ("experts", "embed", "expert_mlp")),
        "w_down": Spec((E, Fd, D), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        Fs = Fd * cfg.n_shared_experts
        s["shared_gate"] = Spec((D, Fs), ("embed", "mlp"))
        s["shared_up"] = Spec((D, Fs), ("embed", "mlp"))
        s["shared_down"] = Spec((Fs, D), ("mlp", "embed"))
    return s


def moe_capacity(cfg: ModelConfig, Tg: int) -> int:
    """Each expert's capacity C in a group of ``Tg`` tokens, in JAX's
    Python arithmetic."""
    C = max(1, int(cfg.capacity_factor * Tg * cfg.top_k / cfg.n_experts))
    return min(C, Tg)


def moe_groups(cfg: ModelConfig, T: int) -> tuple:
    """(G, Tg, C) of ``T`` tokens: G groups of Tg (the largest G <= T //
    moe_group_size that divides T, at least 1) and each expert's capacity
    C per group (``moe_capacity``), in JAX's Python arithmetic."""
    G = max(1, T // cfg.moe_group_size)
    while T % G:
        G -= 1
    Tg = T // G
    return G, Tg, moe_capacity(cfg, Tg)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order among
    ties, and bf16 router logits tie often at init)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, cfg: ModelConfig, xg):
    """The routing of ``xg`` (G, Tg, D) -> (probs, top_w, top_i, pos, keep):
    the f32 router softmax (G, Tg, E), the normalised top-k weights and
    experts (G, Tg, k), each (token, choice) pair's slot in its expert's
    capacity and whether that slot is below C (``moe_capacity`` of Tg, so
    a rank's share of the groups routes as the whole does). The router
    logits are cast to f32 after their product, and the slots count
    token-major and choice-minor, as in JAX."""
    E, k = cfg.n_experts, cfg.top_k
    G, Tg, _ = xg.shape
    C = moe_capacity(cfg, Tg)
    probs = torch.softmax((xg @ p["router"]).float(), -1)
    top_w, top_i = top_k(probs, k)                            # (G, Tg, k)
    top_w = top_w / top_w.sum(-1, keepdim=True)
    oh = F.one_hot(top_i, E).reshape(G, Tg * k, E)
    pos = ((oh.cumsum(1) - 1) * oh).sum(-1).reshape(G, Tg, k)
    return probs, top_w, top_i, pos, pos < C


def _same(x):
    return x


class MoEReduce(NamedTuple):
    """The collectives of an expert-parallel MoE layer (``moe_local``),
    each the identity on one rank (``MOE_LOCAL``): ``expert_sum`` sums the
    combine's partial outputs over the ranks that split the experts (its
    gradient passes through); ``expert_grad_sum`` passes a replicated
    operand through and sums the partial gradients those ranks form from
    it; ``group_mean`` averages the ranks' means over the ranks that split
    the groups (the load-balance loss's two means)."""
    expert_sum: Callable = _same
    expert_grad_sum: Callable = _same
    group_mean: Callable = _same


MOE_LOCAL = MoEReduce()


def moe_reduce(mesh, expert_axes, group_axes) -> MoEReduce:
    """The collectives of ``moe_local`` on ``mesh``: eager all-reduces over
    the groups of ``expert_axes`` (the ranks that split the experts) and
    ``group_axes`` (those that split the groups), inside autograd
    functions (``sharding.psum``, ``grad_psum``, ``pmean``)."""
    return MoEReduce(lambda t: psum(t, mesh, expert_axes),
                     lambda t: grad_psum(t, mesh, expert_axes),
                     lambda t: pmean(t, mesh, group_axes))


def moe_local(p, cfg: ModelConfig, xg, experts=None,
              reduce: MoEReduce = MOE_LOCAL):
    """One rank's part of the MoE layer: the routed experts ``experts`` =
    (e0, e1) of E (default all) on groups ``xg`` (G_l, Tg, D). -> (y
    (G_l, Tg, D), aux).

    ``p`` holds the whole router (D, E) and the experts' slices (e1 - e0,
    D, F) and (e1 - e0, F, D). Every rank routes its groups in full
    (``moe_route`` over all E experts, so the routing and the load-balance
    loss are the same on every rank that holds the groups), keeps the
    dispatch and combine masks' columns of its own experts, forms its
    (G_l, e1 - e0, C, D) buffer and runs its experts on it. ``reduce``
    (``MoEReduce``) makes the sums across ranks: the combine's partial y
    (forward), the dispatch's partial d(xg) and the combine's partial
    d(top_w) (backward); the router's gradient and the routing part of
    d(xg) are then whole on every rank, and the aux gradient counted once.
    ``aux`` = E * sum_e me_e * pe_e takes each mean over all the groups
    (``reduce.group_mean``) before the product. The einsums run in xg's
    dtype, as in JAX; the spans are ``apply_moe``'s."""
    E = cfg.n_experts
    e0, e1 = (0, E) if experts is None else experts
    G, Tg, D = xg.shape
    C = moe_capacity(cfg, Tg)
    dt = xg.dtype

    with record_function("moe_router"):
        probs, top_w, top_i, pos, keep = moe_route(p, cfg, xg)
        # load-balancing aux loss (Switch): E * sum_e f_e * P_e
        me = reduce.group_mean(
            F.one_hot(top_i[..., 0], E).float().mean((0, 1)))
        aux = E * (me * reduce.group_mean(probs.mean((0, 1)))).sum()

    with record_function("moe_dispatch"):
        # a dropped pair's slot C is one past the last class: an all-zero
        # row, as jax.nn.one_hot gives it
        keep_f = keep.to(dt)
        oh_c = F.one_hot(torch.where(keep, pos, C), C + 1)[..., :C].to(dt)
        oh_e = F.one_hot(top_i, E)[..., e0:e1].to(dt)      # (G, t, k, El)
        # the weighted combine mask, and the 0/1 dispatch mask
        top_w = reduce.expert_grad_sum(top_w)
        mask_c = torch.einsum("gtke,gtkc->gtec",
                              oh_e * (top_w.to(dt) * keep_f)[..., None],
                              oh_c)
        mask_d = torch.einsum("gtke,gtkc->gtec", oh_e * keep_f[..., None],
                              oh_c)
        xe = torch.einsum("gtec,gtd->gecd", mask_d,
                          reduce.expert_grad_sum(xg))      # (G, El, C, D)

    with record_function("moe_experts"):
        h = (F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
             * torch.einsum("gecd,edf->gecf", xe, p["w_up"]))
        ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])

    with record_function("moe_combine"):
        y = reduce.expert_sum(torch.einsum("gtec,gecd->gtd", mask_c, ye))
    return y, aux


def shared_experts(p, x):
    """The shared experts' SwiGLU, which every token takes."""
    return F.silu(x @ p["shared_gate"]) * (x @ p["shared_up"]) \
        @ p["shared_down"]


def apply_moe(p, cfg: ModelConfig, x, rules: Optional[Rules] = None,
              mesh=None):
    """Capacity-based token-dropping MoE with group-local dispatch
    (GShard-style), JAX's ``apply_moe``. -> (y, aux).

    The T tokens split into G groups (``moe_groups``); in each group every
    (token, choice) pair takes the next slot of its expert's C, token-major
    and choice-minor, and pairs past C are dropped (``moe_route``). One-hot
    dispatch and combine einsums move the tokens to and from the (G, E, C,
    D) expert buffers; the experts are SwiGLU; ``n_shared_experts`` adds a
    dense SwiGLU every token takes. ``aux`` is the Switch load-balance loss
    E * sum_e f_e * P_e (f32; f from the first choice only). The einsums
    run in x's dtype, as in JAX. The profiler sees the parts as the spans
    ``moe_router``, ``moe_dispatch``, ``moe_experts`` and ``moe_combine``.

    ``mesh`` (x and ``p`` DTensors laid out per ``rules``): expert
    parallelism (``_apply_moe_sharded``); y is laid out as x, aux
    replicated.
    """
    if mesh is not None:
        return _apply_moe_sharded(p, cfg, x, rules or Rules(
            cfg.rule_overrides), mesh)
    B, S, D = x.shape
    T = B * S
    G, Tg, _ = moe_groups(cfg, T)
    y, aux = moe_local(p, cfg, x.reshape(G, Tg, D))
    y = y.reshape(T, D)
    if cfg.n_shared_experts:
        with record_function("moe_experts"):
            y = y + shared_experts(p, x.reshape(T, D))
    return y.reshape(B, S, D), aux


def _moe_layout_error(what: str):
    return NotImplementedError(
        f"apply_moe on a mesh: {what}; the expert-parallel route takes "
        "tokens over the groups' axes (or replicated), experts over "
        "'act_experts', the embed dim of the expert leaves and the router "
        "over any axes (gathered), and nothing else sharded")


def _apply_moe_sharded(p, cfg: ModelConfig, x, rules: Rules, mesh):
    """Expert parallelism: ``moe_local`` on this rank's groups and experts.

    The layout is read off ``rules`` at the global shapes, as JAX's
    annotations are: the groups (G, Tg, D) over ``act_moe_group``, the
    experts of the (G, E, C, D) buffer over ``act_experts``. G, Tg and C
    are the global token count's. Where G does not divide over the group
    axes the groups are replicated: every rank gathers x and routes all T
    tokens, and cuts its rows back out; where x is replicated and the
    groups are not, every rank takes its groups. Where E does not divide
    over the expert axes every rank holds every expert and no combine sum
    runs. The router and the expert leaves are gathered over the axes that
    shard their embed dim (an FSDP gather; the gradient is summed over the
    group axes and cut back), never over the expert axes. The shared
    experts run as an MLP on the DTensors (``apply_mlp``'s layout: "mlp"
    over "model"). A layout the route cannot take raises
    ``NotImplementedError`` naming it.
    """
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(x):
        raise _moe_layout_error("x is a plain tensor, not a DTensor")
    B, S, D = x.shape
    # the layer's input as JAX annotates it (a pending partial sum summed)
    x = lay_out(x, rules.sharding(("act_batch", "act_seq", "act_embed"),
                                  mesh, x.shape))
    E = cfg.n_experts
    G, Tg, C = moe_groups(cfg, B * S)
    # the (G, E, C, D) buffer's layout: its groups are those of the (G,
    # Tg, D) tokens, its experts those of the expert leaves
    g_axes, e_axes, _, emb = spec_mesh_axes(rules.spec(
        ("act_moe_group", "act_experts", None, "act_embed"), mesh,
        (G, E, C, D)), 4)
    if emb:
        raise _moe_layout_error(f"the embed dim over {emb}")
    x_axes = spec_mesh_axes(spec_of(x).spec, 3)
    if x_axes[1] or x_axes[2] or set(x_axes[0]) & set(e_axes):
        raise _moe_layout_error(f"x laid out {x_axes}")
    b_axes = x_axes[0]

    def leaf(name, e_dim, embed_dim, f_dim):
        """The leaf's local part, gathered whole over its embed dim."""
        w = p[name]
        axes = spec_mesh_axes(spec_of(w).spec, w.ndim) if is_dtensor(w) \
            else ((),) * w.ndim
        if (e_dim is not None and axes[e_dim] != e_axes) or (
                e_dim is None and axes[1]) or (
                f_dim is not None and axes[f_dim]):
            raise _moe_layout_error(f"{name} laid out {axes} with the "
                                    f"experts over {e_axes}")
        local = w.to_local() if is_dtensor(w) else w
        return gather(local, mesh, axes[embed_dim], embed_dim, g_axes)

    pl = {"router": leaf("router", None, 0, None),
          "w_gate": leaf("w_gate", 0, 1, 2),
          "w_up": leaf("w_up", 0, 1, 2),
          "w_down": leaf("w_down", 0, 2, 1)}
    M = axes_size(mesh, e_axes)
    El = E // M
    if pl["w_gate"].shape[0] != El:
        raise _moe_layout_error(f"{El} experts a rank, the leaves hold "
                                f"{pl['w_gate'].shape[0]}")
    r = shard_index(mesh, e_axes)

    xl = x.to_local()
    if b_axes == g_axes:
        xg = xl.reshape(-1, Tg, D)
    elif not b_axes:        # x replicated: each rank takes its groups
        xg = scatter(xl.reshape(G, Tg, D), mesh, g_axes, 0)
    elif not g_axes:        # the groups replicated: every rank routes all
        xg = gather(xl, mesh, b_axes, 0).reshape(G, Tg, D)
    else:
        raise _moe_layout_error(f"tokens over {b_axes}, groups over "
                                f"{g_axes}")
    y, aux = moe_local(pl, cfg, xg, (r * El, (r + 1) * El),
                       moe_reduce(mesh, e_axes, g_axes))
    if b_axes == g_axes:
        y = y.reshape(xl.shape)
    elif not b_axes:
        y = gather(y, mesh, g_axes, 0).reshape(B, S, D)
    else:
        y = scatter(y.reshape(B, S, D), mesh, b_axes, 0)
    y = wrap(y, spec_of(x), x.shape)
    aux = DTensor.from_local(aux, mesh, (Replicate(),) * mesh.ndim,
                             run_check=False)
    if cfg.n_shared_experts:
        with record_function("moe_experts"):
            y = y + shared_experts(p, x)
    return y, aux


# ------------------------------------------------------------------- Mamba2

def largest_divisor(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target`` (>= 1), JAX's: over
    the divisor pairs, so a prime ``n`` gives 1 at once."""
    target = min(target, n)
    best, d = 1, 1
    while d * d <= n:
        if n % d == 0:
            for c in (d, n // d):
                if best < c <= target:
                    best = c
        d += 1
    return best


def _pick_block(S: int, T: int, block: int) -> int:
    """Largest common divisor block of (S, T) that is <= ``block``, JAX's:
    it warns whenever the block falls below half the requested size (a
    prime or awkward length turns the chunk loop into many short ones)."""
    target = max(min(block, S, T), 1)
    best = largest_divisor(math.gcd(S, T), target)
    if best * 2 < target:
        warnings.warn(
            f"blockwise attention: (S={S}, T={T}) share no divisor in "
            f"({target // 2}, {target}]; the tile shrinks to {best} "
            f"({(S // best) * (T // best)} candidate tile pairs). Pick "
            f"lengths with a common divisor near block={target} to keep "
            f"the scan short.", stacklevel=3)
    return best


def mamba_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    din, nh = cfg.d_inner, cfg.ssm_nheads
    gn = cfg.ssm_ngroups * cfg.ssm_state
    d_in_proj = 2 * din + 2 * gn + nh
    return {
        "in_proj": Spec((D, d_in_proj), ("embed", "ssm_inner")),
        "conv_w": Spec((cfg.ssm_dconv, cfg.conv_dim), ("conv", "ssm_inner")),
        "conv_b": Spec((cfg.conv_dim,), ("ssm_inner",), "zeros"),
        "A_log": Spec((nh,), (None,), "alog"),
        "D": Spec((nh,), (None,), "ones"),
        "dt_bias": Spec((nh,), (None,), "dtbias"),
        "gate_norm": Spec((din,), ("ssm_inner",), "ones"),
        "out_proj": Spec((din, D), ("ssm_inner", "embed")),
    }


def mamba_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """Zero Mamba2 cache: the conv window's last dconv-1 inputs ``conv``
    (B, dconv-1, conv_dim) in ``dtype`` and the SSM state ``ssm`` (B, nh,
    N, hd), always f32. Neither has a sequence axis."""
    return {"conv": torch.zeros((batch, cfg.ssm_dconv - 1, cfg.conv_dim),
                                dtype=dtype, device=device),
            "ssm": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_state,
                                cfg.ssm_headdim), dtype=torch.float32,
                               device=device)}


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv1d of window dconv, JAX's. x (B, S, C), w
    (dconv, C). ``state`` (B, dconv-1, C) is prepended (decode), zeros
    otherwise. The taps sum in JAX's order (Python's ``sum`` from 0, then
    ``+ b``) in x's dtype; -> (silu(y), the last dconv-1 pre-activation
    inputs: the next call's state)."""
    dconv = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], dconv - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], 1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(dconv)) + b
    new_state = xp[:, -(dconv - 1):] if dconv > 1 else pad
    return F.silu(y), new_state


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD (Mamba2's state-space duality, matmul form), JAX's.

    xh (B, S, nh, hd) in the model dtype; dt (B, S, nh) f32, after the
    softplus; A (nh,) f32, negative; Bm, Cm (B, S, G, N). -> y (B, S, nh,
    hd) in xh's dtype. The groups repeat to the heads as
    ``jnp.repeat(..., axis=3)`` does (each group's heads adjacent:
    ``repeat_interleave``). Each step keeps JAX's dtype: the C.B scores
    and the chunk states are products in the model dtype, the decays and
    weights f32 (cast to the model dtype for the products), the recurrence
    over chunks f32, emitting the state *before* each chunk, and
    y_intra + y_inter is added in the model dtype. The intra-chunk blocks
    are laid out (B, nc, nh, i, j), so each product is one batched matmul;
    JAX's (B, nc, i, j, nh) holds the same values.

    The one departure: the intra-chunk decay is exp(where(mask, li - lj,
    -inf)), where JAX forms exp(li - lj) over the whole block and masks
    after. Above the diagonal li - lj sums |dt * A| over up to chunk - 1
    steps; at the alog/dtbias inits (A in [-16, -1), dt up to 0.1) and a
    chunk of 256 it passes 88.7, where f32 exp overflows, and JAX's
    backward then forms 0 * inf = NaN. The forward is JAX's bitwise
    (masked entries are exactly 0 either way); every gradient JAX gives
    finite is unchanged, and this one stays finite where JAX's overflows
    (ROADMAP.md Queue 3, reference caveat 12).
    """
    B_, S, nh, hd = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    chunk = _pick_block(S, S, chunk)
    nc = S // chunk
    rep = nh // G
    dtype = xh.dtype

    # heads ahead of the chunk positions: (B, nc, nh, c, ...)
    xc = xh.reshape(B_, nc, chunk, nh, hd).transpose(2, 3)
    dtc = dt.reshape(B_, nc, chunk, nh).transpose(2, 3)
    Bc = Bm.reshape(B_, nc, chunk, G, N).repeat_interleave(rep, 3) \
        .transpose(2, 3)
    Cc = Cm.reshape(B_, nc, chunk, G, N).repeat_interleave(rep, 3) \
        .transpose(2, 3)

    dA = dtc * A[:, None]                       # (B, nc, nh, c), negative
    cum = torch.cumsum(dA, dim=-1)

    # intra-chunk: y_i += sum_{j<=i} C_i.B_j exp(cum_i - cum_j) dt_j x_j
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=xh.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]            # (.., i, j)
    decay = torch.exp(torch.where(mask, diff, float("-inf")))
    cb = (Cc @ Bc.transpose(-1, -2)).float()
    w = cb * decay * dtc[..., None, :]
    y_intra = w.to(dtype) @ xc                  # (B, nc, nh, c, hd)

    # chunk states: S_c = sum_j exp(cum_end - cum_j) dt_j B_j x_j^T
    dec_end = torch.exp(cum[..., -1:] - cum)   # (B, nc, nh, c)
    sb = (dec_end * dtc)[..., None] * Bc       # (B, nc, nh, c, N) f32
    states = sb.to(dtype).transpose(-1, -2) @ xc   # (B, nc, nh, N, hd)

    # inter-chunk recurrence over nc (few): h_c = h_{c-1} e^{sum dA_c} + S_c
    chunk_decay = torch.exp(dA.sum(-1))         # (B, nc, nh)
    states = states.float()
    h = xh.new_zeros((B_, nh, N, hd), dtype=torch.float32)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, 1)             # (B, nc, nh, N, hd)

    dec_in = torch.exp(cum)
    y_inter = (Cc * dec_in[..., None]).to(dtype) @ h_prev.to(dtype)
    y = (y_intra + y_inter).transpose(2, 3)     # (B, nc, c, nh, hd)
    return y.reshape(B_, S, nh, hd)


def _final_ssm_state(xh, dt, A, Bm, Cm):
    """The state after the last position, h_S = sum_j exp(cum_S - cum_j)
    dt_j B_j x_j^T (B, nh, N, hd), f32, JAX's (the prefill's)."""
    nh, G = xh.shape[2], Bm.shape[2]
    Bf = Bm.repeat_interleave(nh // G, 2)
    cum = torch.cumsum(dt * A, dim=1)
    dec = torch.exp(cum[:, -1:, :] - cum)       # (B, S, nh)
    sb = (dec * dt)[..., None] * Bf             # (B, S, nh, N)
    return torch.einsum("bjhn,bjhp->bhnp", sb.float(), xh.float())


MAMBA_DECODE_ON_A_MESH = (
    "apply_mamba: decode on a mesh (the single-step recurrence over a "
    "head-sharded conv and SSM cache) is sharded serving, not ported yet; "
    "ROADMAP.md Queue 1 item 12 (its leftovers)")


class MambaReduce(NamedTuple):
    """The collectives of a head-sharded Mamba2 layer (``mamba_local``),
    each the identity on one rank (``MAMBA_LOCAL``): ``head_grad_sum``
    passes the replicated input through and sums the partial gradients the
    ranks of the head axes form of it; ``norm_sum`` sums the gated
    RMSNorm's partial sums of squares over the head axes, and the partial
    gradients of that sum (None: the heads are whole, the norm is
    ``rmsnorm``); ``head_sum`` sums out_proj's partial outputs (its
    gradient passes through)."""
    head_grad_sum: Callable = _same
    norm_sum: Optional[Callable] = None
    head_sum: Callable = _same


MAMBA_LOCAL = MambaReduce()


def mamba_reduce(mesh, head_axes) -> MambaReduce:
    """The collectives of ``mamba_local`` on ``mesh``: eager all-reduces
    over the groups of ``head_axes`` (the ranks that split the heads),
    inside autograd functions (``sharding.grad_psum``, ``psum_shared``,
    ``psum``)."""
    return MambaReduce(lambda t: grad_psum(t, mesh, head_axes),
                       lambda t: psum_shared(t, mesh, head_axes),
                       lambda t: psum(t, mesh, head_axes))


def mamba_groups(cfg: ModelConfig, heads) -> tuple:
    """(g0, g1): the B/C groups the heads ``heads`` = (h0, h1) read. JAX's
    ``jnp.repeat`` gives each group nh/G adjacent heads."""
    rep = cfg.ssm_nheads // cfg.ssm_ngroups
    h0, h1 = heads
    return h0 // rep, -(-h1 // rep)


def mamba_slices(p, cfg: ModelConfig, heads) -> dict:
    """The leaves of the heads ``heads`` = (h0, h1) cut out of whole
    leaves: ``in_proj``'s z, x, B, C and dt columns (B and C those of the
    heads' groups, ``mamba_groups``), ``conv_w``'s and ``conv_b``'s x, B
    and C channels, ``gate_norm``'s and ``out_proj``'s d_inner rows, and
    ``A_log``, ``D`` and ``dt_bias`` at the heads. All the heads: the
    leaves themselves."""
    if tuple(heads) == (0, cfg.ssm_nheads):
        return dict(p)
    din, hd, N = cfg.d_inner, cfg.ssm_headdim, cfg.ssm_state
    gn = cfg.ssm_ngroups * N
    h0, h1 = heads
    g0, g1 = mamba_groups(cfg, heads)

    def cols(w, *starts):
        """w's last-dim blocks [s + lo, s + hi) of the heads (d_inner) or
        their groups, concatenated."""
        return torch.cat([w[..., s + lo:s + hi] for s, (lo, hi) in starts],
                         -1)
    inner, grp, head = (h0 * hd, h1 * hd), (g0 * N, g1 * N), (h0, h1)
    xbc = ((0, inner), (din, grp), (din + gn, grp))
    return {"in_proj": cols(p["in_proj"], (0, inner), (din, inner),
                            (2 * din, grp), (2 * din + gn, grp),
                            (2 * din + 2 * gn, head)),
            "conv_w": cols(p["conv_w"], *xbc),
            "conv_b": cols(p["conv_b"], *xbc),
            "gate_norm": p["gate_norm"][h0 * hd:h1 * hd],
            "out_proj": p["out_proj"][h0 * hd:h1 * hd],
            **{k: p[k][h0:h1] for k in ("A_log", "D", "dt_bias")}}


def _norm_over(x, scale, eps: float, width: int, total):
    """``rmsnorm`` of x's last dim as the part of a ``width``-wide row:
    the sum of squares summed over the ranks by ``total``."""
    xf = x.float()
    var = total((xf * xf).sum(dim=-1, keepdim=True)) / width
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def mamba_local(p, cfg: ModelConfig, x, mode: str = "train",
                cache: Optional[dict] = None, heads=None,
                reduce: MambaReduce = MAMBA_LOCAL):
    """One rank's part of the Mamba2 layer: the heads ``heads`` = (h0, h1)
    of nh (default all) on its rows of x (B, S, D). -> (y (B, S, D),
    new_cache), the cache of the rank's heads and channels.

    ``p`` holds the heads' leaves (``mamba_slices``; the whole leaves for
    all heads). The projection gives the heads' z, x and dt and their
    groups' B and C; the causal conv runs on those channels (it is
    depthwise); the SSD and the D skip on the heads alone. Where the heads
    do not cover whole groups, B and C repeat to the heads before the SSD.
    ``reduce`` (``MambaReduce``) makes the sums across the ranks that
    split the heads: the gated RMSNorm's sum of squares over d_inner and
    out_proj's partial (B, S, D) (forward), x's partial gradient
    (backward). With all heads and ``MAMBA_LOCAL`` this is the unsharded
    layer, op for op; spans and modes are ``apply_mamba``'s."""
    B, S, D = x.shape
    nh, hd, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    h0, h1 = (0, nh) if heads is None else heads
    g0, g1 = mamba_groups(cfg, (h0, h1))
    nl, dl, gn = h1 - h0, (h1 - h0) * hd, (g1 - g0) * N

    with record_function("mamba_proj"):
        zxbcdt = reduce.head_grad_sum(x) @ p["in_proj"]
        z = zxbcdt[..., :dl]
        xbc = zxbcdt[..., dl:2 * dl + 2 * gn]
        dt_raw = zxbcdt[..., 2 * dl + 2 * gn:]
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        xbc, conv_state = _causal_conv(
            xbc, p["conv_w"], p["conv_b"],
            cache["conv"] if mode == "decode" else None)
        # conv_state holds the last dconv-1 pre-activation inputs: what
        # decode needs after a prefill
        xs = xbc[..., :dl].reshape(B, S, nl, hd)
        Bm = xbc[..., dl:dl + gn].reshape(B, S, g1 - g0, N)
        Cm = xbc[..., dl + gn:].reshape(B, S, g1 - g0, N)
        rep = nh // cfg.ssm_ngroups
        if h0 % rep or h1 % rep:
            # part of a group: each head its own copy of B and C
            off = h0 - g0 * rep
            Bm = Bm.repeat_interleave(rep, 2)[:, :, off:off + nl]
            Cm = Cm.repeat_interleave(rep, 2)[:, :, off:off + nl]

    new_cache = cache
    if mode == "decode":
        with record_function("mamba_decode"):
            # h = h * exp(dt A) + dt * x B^T ; y = C.h + D x
            rep_l = nl // Bm.shape[2]
            h = cache["ssm"].float()                        # (B, nh, N, hd)
            dt1 = dt[:, 0]                                  # (B, nh)
            dA = torch.exp(dt1 * A)
            Bm1 = Bm[:, 0].repeat_interleave(rep_l, 1)      # (B, nh, N)
            Cm1 = Cm[:, 0].repeat_interleave(rep_l, 1)
            x1 = xs[:, 0].float()                           # (B, nh, hd)
            h = h * dA[..., None, None] + (dt1[..., None, None]
                                           * Bm1[..., :, None]
                                           * x1[..., None, :])
            y = torch.einsum("bhn,bhnp->bhp", Cm1.float(), h)
            y = y + p["D"].float()[None, :, None] * x1
            y = y[:, None].to(x.dtype)                      # (B, 1, nh, hd)
            cache["conv"].copy_(conv_state)
            cache["ssm"].copy_(h)
    else:
        with record_function("mamba_ssd"):
            y = _ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
            y = y + p["D"].to(x.dtype)[None, None, :, None] * xs
            if mode == "prefill":
                new_cache = {"conv": conv_state,
                             "ssm": _final_ssm_state(xs, dt, A, Bm, Cm)}

    with record_function("mamba_proj"):
        y = y.reshape(B, S, dl)
        y = y * F.silu(z.float()).to(y.dtype)
        if reduce.norm_sum is None:
            y = rmsnorm(y, p["gate_norm"], cfg.rms_eps)
        else:
            y = _norm_over(y, p["gate_norm"], cfg.rms_eps, cfg.d_inner,
                           reduce.norm_sum)
        return reduce.head_sum(y @ p["out_proj"]), new_cache


def apply_mamba(p, cfg: ModelConfig, x, mode: str = "train",
                cache: Optional[dict] = None, rules: Optional[Rules] = None,
                mesh=None):
    """Mamba2 block, JAX's ``apply_mamba``. mode: train | prefill | decode.
    -> (y, new_cache); cache = {"conv": (B, dconv-1, conv_dim), "ssm": (B,
    nh, N, hd) f32} (``mamba_cache``).

    train and prefill run the chunked SSD over the sequence; prefill
    returns the conv window's last inputs and the final SSM state as the
    cache. decode (S = 1) runs the single-step recurrence in f32 and
    writes the new conv and SSM states into ``cache``'s tensors IN PLACE
    (JAX returns new ones): the serving loop keeps the cache it was given
    (``transformer.apply_segment``). The gate is rmsnorm(y * silu(z)) in
    y's dtype. Packed rows need nothing: the sequence mixing has no
    segment mask, as in JAX. The profiler sees the projections, the conv
    and the gate as the span ``mamba_proj``, the SSD as ``mamba_ssd`` and
    decode's recurrence as ``mamba_decode``.

    ``mesh`` (x and ``p`` DTensors laid out per ``rules``): the heads
    split over "act_ssm_heads" (``_apply_mamba_sharded``) in modes train
    and prefill; y is laid out as x, prefill's cache per (batch, ...) with
    the heads and channels whole. decode on a mesh raises
    (``MAMBA_DECODE_ON_A_MESH``).
    """
    if mesh is not None:
        if mode == "decode":
            raise NotImplementedError(MAMBA_DECODE_ON_A_MESH)
        return _apply_mamba_sharded(p, cfg, x, mode, rules or Rules(
            cfg.rule_overrides), mesh)
    return mamba_local(p, cfg, x, mode, cache)


def _mamba_layout_error(what: str):
    return NotImplementedError(
        f"apply_mamba on a mesh: {what}; the head-sharded route takes the "
        "rows over 'act_batch' (or replicated), the heads over "
        "'act_ssm_heads' (or whole), the leaves over any axes that divide "
        "them (gathered), and nothing else sharded")


def _whole_leaf(w, mesh, grad_axes):
    """A leaf whole on every rank: its local shard gathered over the axes
    of each sharded dim (``sharding.gather``); the gradient the rank forms
    of the whole leaf summed over ``grad_axes`` (the axes that split the
    work: the rows and the heads) and cut back to the shard."""
    if not is_dtensor(w):
        return grad_psum(w, mesh, grad_axes)
    axes = spec_mesh_axes(spec_of(w).spec, w.ndim)
    dims = [d for d in range(w.ndim) if axes_size(mesh, axes[d]) > 1]
    for d in dims:
        if w.shape[d] % axes_size(mesh, axes[d]):
            raise _mamba_layout_error(f"a leaf of shape {tuple(w.shape)} "
                                      f"laid out {axes}, unevenly")
    local = w.to_local()
    if not dims:
        return grad_psum(local, mesh, grad_axes)
    for i, d in enumerate(dims):
        local = gather(local, mesh, axes[d], d,
                       grad_axes if i == len(dims) - 1 else ())
    return local


def _owned_channels(conv, cfg: ModelConfig, heads):
    """The conv cache (B, dconv-1, conv_dim) with this rank's channels of
    ``conv`` (B, dconv-1, its x, B and C channels) in place and zeros
    elsewhere; a group read by several ranks' heads is placed by the rank
    that holds its first head, so a sum over the head axes is the whole
    cache."""
    din, hd, N = cfg.d_inner, cfg.ssm_headdim, cfg.ssm_state
    gn = cfg.ssm_ngroups * N
    rep = cfg.ssm_nheads // cfg.ssm_ngroups
    h0, h1 = heads
    g0, g1 = mamba_groups(cfg, heads)
    go = -(-h0 // rep)                     # the first group this rank owns
    dl, gl = (h1 - h0) * hd, (g1 - g0) * N
    out = conv.new_zeros(conv.shape[:2] + (cfg.conv_dim,))
    out[..., h0 * hd:h1 * hd] = conv[..., :dl]
    for start, src in ((din, dl), (din + gn, dl + gl)):
        out[..., start + go * N:start + g1 * N] = \
            conv[..., src + (go - g0) * N:src + gl]
    return out


def _apply_mamba_sharded(p, cfg: ModelConfig, x, mode: str, rules: Rules,
                         mesh):
    """The head-sharded Mamba2 layer: ``mamba_local`` on this rank's heads
    and rows.

    The layout is read off ``rules`` at the global shapes, as JAX's
    annotations are: the rows over ``act_batch``, the heads (B, S, nh, hd)
    over ``act_ssm_heads`` (JAX's ``_ssd_chunked`` head layout with the
    chunk dims folded). Where nh does not divide over the head axes every
    rank holds every head and no head sum runs. JAX's "ssm_inner" cuts of
    ``in_proj`` ([z | x | B | C | dt], and so of ``zxbcdt``) and of
    ``conv_w``/``conv_b`` ([x | B | C]) are contiguous blocks that do not
    follow the heads: every leaf is gathered whole over the axes that
    shard it, and the rank takes its heads' columns (``mamba_slices``);
    the gradient of the whole leaf, partial over the rows and the heads,
    is summed over both and cut back to the leaf's shard. x with its
    sequence or features sharded, or a leaf cut unevenly, raises
    ``NotImplementedError`` naming the layout.

    prefill's cache: the SSM state gathered over the head axes, the conv
    window's channels summed from each rank's own (``_owned_channels``);
    both laid out with the rows, the rest whole.
    """
    if not is_dtensor(x):
        raise _mamba_layout_error("x is a plain tensor, not a DTensor")
    B, S, D = x.shape
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    # the layer's input as JAX annotates it (a pending partial sum summed)
    x = lay_out(x, rules.sharding(("act_batch", "act_seq", "act_embed"),
                                  mesh, x.shape))
    x_axes = spec_mesh_axes(spec_of(x).spec, 3)
    if x_axes[1] or x_axes[2]:
        raise _mamba_layout_error(f"x laid out {x_axes}")
    b_axes = x_axes[0]
    h_axes = spec_mesh_axes(rules.spec(
        ("act_batch", None, "act_ssm_heads", None), mesh, (B, S, nh, hd)),
        4)[2]
    M = axes_size(mesh, h_axes)
    r = shard_index(mesh, h_axes)
    heads = (r * nh // M, (r + 1) * nh // M)
    grad_axes = b_axes + (h_axes if M > 1 else ())
    whole = {k: _whole_leaf(p[k], mesh, grad_axes) for k in mamba_spec(cfg)}
    y, cache = mamba_local(mamba_slices(whole, cfg, heads), cfg,
                           x.to_local(), mode, None, heads,
                           mamba_reduce(mesh, h_axes) if M > 1
                           else MAMBA_LOCAL)
    y = wrap(y, spec_of(x), x.shape)
    if mode == "prefill":
        conv, ssm = cache["conv"], cache["ssm"]
        if M > 1:
            conv = psum(_owned_channels(conv, cfg, heads), mesh, h_axes)
            ssm = gather(ssm, mesh, h_axes, 1)
        rows = NamedSharding(mesh, P(None if not b_axes else b_axes[0]
                                     if len(b_axes) == 1 else b_axes))
        cache = {"conv": wrap(conv, rows, (B,) + conv.shape[1:]),
                 "ssm": wrap(ssm, rows, (B,) + ssm.shape[1:])}
    return y, cache
