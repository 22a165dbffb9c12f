"""Top-level model API: spec, init, caches, forward, logits, loss (every
family of ``repro.models.model``: dense, MoE, Mamba2 (ssm), hybrid
(attention, Mamba2, MoE and MLP in one super-block), the VLM (cross-
attention over image embeddings) and audio (codebooks); GQA or MLA
attention).

Parameter tree layout, as in ``repro.models.model``::

    {"tok_embed": {"w"},        # (V, D); audio (C, V, D)
     "segments": {"seg<i>_<kind>": {...stacked super-block params...}},
     "final_norm": {"s"},
     "lm_head": {"w"}}          # (D, V); audio (C, D, V); absent with
                                # cfg.tie_embeddings

The tree is held in :class:`Params`, an ``nn.Module`` whose
``state_dict()`` keys are the JAX package's ``core.labels.path_str`` keys
with ``/`` replaced by ``.`` (``segments.seg0_dense.attn.wq``, shape
(L, D, H*hd)). It indexes like the JAX dict: ``params["tok_embed"]["w"]``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from repro_torch.device import resolve_device
from repro_torch.kernels import dispatch

from . import layers as L
from . import transformer as T
from .config import ModelConfig
from .sharding import (IMAGE_AXES, Rules, embed_lookup, lay_out,
                       mesh_context, place, shard)


# ----------------------------------------------------------------- spec tree

def _stacked(spec_tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict)
            else L.Spec((n,) + tuple(v.shape), (None,) + tuple(v.axes),
                        v.init)
            for k, v in spec_tree.items()}


def _embed_spec(cfg: ModelConfig) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    if cfg.family == "audio":
        return {"w": L.Spec((cfg.n_codebooks, V, D),
                            (None, "vocab", "embed"))}
    return {"w": L.Spec((V, D), ("vocab", "embed"))}


def _head_spec(cfg: ModelConfig) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    if cfg.family == "audio":
        # the C heads are one 3-D leaf in SCALE's momentum group, which the
        # optimizer kernels take as a stacked leaf (dispatch.FUSED_NDIMS)
        return {"w": L.Spec((cfg.n_codebooks, D, V),
                            (None, "embed", "vocab"))}
    return {"w": L.Spec((D, V), ("embed", "vocab"))}


def model_spec(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    segs = {f"seg{i}_{kind}": _stacked(T.superblock_spec(cfg, kind), n)
            for i, (kind, n) in enumerate(cfg.segments)}
    out = {
        "tok_embed": _embed_spec(cfg),
        "segments": segs,
        "final_norm": {"s": L.Spec((D,), ("norm",), "ones")},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _head_spec(cfg)
    if cfg.pos_embed == "learned":
        out["pos_embed"] = {"w": L.Spec((cfg.max_position, D),
                                        (None, "embed"))}
    return out


def flatten(tree, prefix: str = "", sep: str = "/") -> dict:
    """{path: leaf} of a nested dict (or :class:`Params`), JAX path_str keys."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{sep}{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(flatten(v, path, sep))
        else:
            out[path] = v
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """{path_str: shape} of every parameter."""
    return {k: tuple(s.shape) for k, s in flatten(model_spec(cfg)).items()}


def param_logical_axes(cfg: ModelConfig) -> dict:
    """{path_str: logical axes} of every parameter (``models.sharding``)."""
    return {k: tuple(s.axes) for k, s in flatten(model_spec(cfg)).items()}


def place_params(params, cfg: ModelConfig, mesh, rules: Rules = None):
    """``params`` (the same full values on every rank) laid out on
    ``mesh`` per the rules (default ``Rules(cfg.rule_overrides)``): a
    :class:`Params` of DTensor leaves, each rank holding its shards (the
    JAX launcher's ``device_put`` with ``tree_shardings``)."""
    from .sharding import tree_shardings
    rules = rules or Rules(cfg.rule_overrides)
    shardings = tree_shardings(param_logical_axes(cfg), mesh, rules,
                               param_shapes(cfg))
    return Params({k: place(p.detach(), shardings[k], copy=True)
                   for k, p in flatten(params).items()})


def count_params(shapes: dict, cfg: ModelConfig = None,
                 active_only: bool = False) -> int:
    """Total parameters of a ``{path: shape}`` mapping; ``active_only``
    (with an MoE ``cfg``): each expert leaf counts ``top_k / n_experts``
    of its size, in JAX's integer arithmetic."""
    if not active_only or cfg is None or not cfg.n_experts:
        return int(sum(math.prod(s) for s in shapes.values()))
    total = 0
    for s in flatten(model_spec(cfg)).values():
        n = math.prod(s.shape)
        if "experts" in s.axes:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def check_mesh(cfg: ModelConfig, mesh, what: str,
               mode: str = "train") -> None:
    """Raise before any work where ``cfg`` has no sharded route on a mesh
    in ``mode``: in mode decode, MLA (the absorbed decode over a
    sequence-sharded latent cache) and Mamba2 (an ssm or hybrid segment:
    the recurrence over a head-sharded cache). Every family runs sharded
    in modes train and prefill: an moe segment (expert parallelism over
    "model": ``layers.apply_moe``), MLA, Mamba2 with its heads over
    "model" (``layers.apply_mamba``; an ssm or hybrid segment), the VLM's
    cross sub-layer (``layers.apply_attention`` with ``kv_source``: the
    images' rows over the batch axes, the heads over "model") and audio's
    codebook embedding and heads (each codebook's lookup through
    ``sharding.embed_lookup``, each head on the sharded xent route with
    its ``col_offset``). GQA attention decodes on a mesh too (dense, MoE,
    the VLM and audio): its cache's T over "model"
    (``cache_logical_axes``), each rank's shard on the decode kernel
    (``dispatch.decode_attention``)."""
    if mesh is None or mode != "decode":
        return
    mamba = [k for k, _ in cfg.segments if k in ("ssm", "hybrid")]
    if mamba:
        raise NotImplementedError(
            f"{what}: the {mamba[0]} segment's Mamba2: "
            f"{L.MAMBA_DECODE_ON_A_MESH}")
    if cfg.attention_kind == "mla":
        raise NotImplementedError(f"{what}: {L.MLA_DECODE_ON_A_MESH}")


class Params(nn.ModuleDict):
    """The parameter tree as nested ``ModuleDict``/``ParameterDict``s.

    Built from ``{path_str: tensor}``; parameters do not require grad
    until a caller turns it on (``requires_grad_``).
    """

    def __init__(self, flat: dict):
        super().__init__()
        for k, v in _modules(unflatten(flat)).items():
            self[k] = v


def unflatten(flat: dict, sep: str = "/") -> dict:
    """Nested dict of a ``{path: leaf}`` mapping (inverse of ``flatten``)."""
    tree: dict = {}
    for path, t in flat.items():
        *parents, leaf = path.split(sep)
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _modules(tree: dict) -> dict:
    """Nested dict -> ParameterDicts (leaf level) inside ModuleDicts."""
    return {k: nn.ParameterDict({n: nn.Parameter(x, requires_grad=False)
                                 for n, x in v.items()})
            if all(torch.is_tensor(x) for x in v.values())
            else nn.ModuleDict(_modules(v)) for k, v in tree.items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random params: normal(0, 0.02) matrices (0.006 for the MoE router),
    ones for norms, zero biases; Mamba2's ``A_log`` as log U[1, 16)
    ("alog") and ``dt_bias`` as the inverse softplus of dt = exp(U[ln 1e-3,
    ln 1e-1]) ("dtbias"). An init name it does not know raises
    ``ValueError``.

    The init rules are the JAX package's; the draws come from ``generator``
    (in path order, on the generator's device, in f32, then cast to the
    model dtype) and differ from ``jax.random``'s. ``device`` defaults to
    ``cuda``.
    """
    device = resolve_device(device)
    flat = {}
    for path, spec in flatten(model_spec(cfg)).items():
        x = _init_leaf(spec, generator)
        flat[path] = x.to(device=device, dtype=cfg.torch_dtype)
    return Params(flat)


def _init_leaf(spec: L.Spec, generator: torch.Generator) -> torch.Tensor:
    """One f32 leaf by ``spec.init`` (see ``init_params``)."""
    def uniform(lo, hi):
        return torch.empty(spec.shape, device=generator.device).uniform_(
            lo, hi, generator=generator)

    if spec.init == "ones":
        return torch.ones(spec.shape)
    if spec.init == "zeros":
        return torch.zeros(spec.shape)
    if spec.init == "alog":       # Mamba2's A = -exp(A_log) in [-16, -1)
        return torch.log(uniform(1.0, 16.0))
    if spec.init == "dtbias":     # softplus(dt_bias) = dt in [1e-3, 1e-1]
        dt = torch.exp(uniform(math.log(1e-3), math.log(1e-1)))
        return dt + torch.log(-torch.expm1(-dt))
    if spec.init in ("normal", "small"):
        scale = 0.006 if spec.init == "small" else 0.02
        return scale * torch.randn(spec.shape, generator=generator,
                                   device=generator.device)
    raise ValueError(f"unknown init {spec.init!r} (normal, small, zeros, "
                     "ones, alog, dtbias)")


# -------------------------------------------------------------------- cache

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None, rules: Rules = None, mesh=None) -> dict:
    """Zero cache, per segment and sub-layer that keeps one, like the JAX
    one: GQA's k and v (L, B, max_seq, K, hd); MLA's latent ckv (L, B,
    max_seq, kv_lora_rank) and shared rope key krope (L, B, max_seq, 1,
    qk_rope_dim); Mamba2's conv (L, B, dconv-1, conv_dim) and ssm (L, B,
    nh, N, hd). Each leaf keeps its own dtype: ``dtype`` (default the
    model's), but Mamba2's ssm state always f32.

    ``mesh``: each leaf a DTensor laid out per ``cache_logical_axes``
    under ``rules`` (default ``Rules(cfg.rule_overrides)``), with the
    divisibility guard of ``Rules.spec`` (GQA's T over "model" where it
    divides, else whole); each rank allocates only its shard."""
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    where = device if mesh is None else torch.device("meta")
    if mesh is not None:
        rules = rules or Rules(cfg.rule_overrides)
        axes = cache_logical_axes(cfg)
    out = {}
    for i, (kind, n) in enumerate(cfg.segments):
        seg = f"seg{i}_{kind}"
        one = T.superblock_cache(cfg, kind, batch, max_seq, dtype, where)
        if mesh is None:
            out[seg] = {name: {k: x.new_zeros((n,) + x.shape)
                               for k, x in c.items()}
                        for name, c in one.items()}
            continue
        out[seg] = {name: {k: place(
            torch.zeros((), dtype=x.dtype, device=device).expand(
                (n,) + x.shape),
            rules.sharding(axes[seg][name][k], mesh, (n,) + x.shape),
            copy=True) for k, x in c.items()} for name, c in one.items()}
    return out


def cache_logical_axes(cfg: ModelConfig) -> dict:
    """{segment: {sub-layer: {leaf: logical axes}}} of the stacked cache,
    JAX's ``model.cache_logical_axes`` (``transformer.cache_axes`` per
    segment): GQA's k and v per (None, "cache_batch", "cache_seq", None,
    "cache_kv"), MLA's and Mamba2's leaves as there."""
    return {f"seg{i}_{kind}": T.cache_axes(cfg, kind)
            for i, (kind, n) in enumerate(cfg.segments)}


# ------------------------------------------------------------------ forward

def forward(params, cfg: ModelConfig, tokens, *, image_embeds=None,
            mode: str = "train", cache=None, cache_index=None,
            positions=None, segment_ids=None, rules: Rules = None,
            mesh=None):
    """Run the backbone on tokens (B, S); audio (B, n_codebooks, S), whose
    codebook embeddings are summed. Returns (hidden (B, S, D), new_cache,
    aux).

    ``mode`` is train | prefill | decode (see ``layers.apply_attention``);
    decode positions are ``cache_index + arange(S)``. ``positions`` and
    ``segment_ids`` ((B, S) ints, optional) are the packed-document
    operands: within-document positions (RoPE and learned positions
    restart at each document) and the per-token document ids attention
    keeps apart (pad id 0). The ids are cast to contiguous int32 here,
    once for every layer. ``aux`` (the MoE load-balance loss in the JAX
    package) is 0 for the dense and ssm families; a hybrid model's sums
    its MoE sub-layers' (``ffn1``, ``ffn3``, ...). ``image_embeds`` (B,
    n_image_tokens, D; the data pipeline's are f32 whatever the model's
    dtype, as JAX's are) are the keys and values of the VLM's cross
    sub-layers (``layers.apply_attention``); without them those run
    JAX's causal self-attention over the text.

    ``mesh`` (a DeviceMesh; params and batch DTensors laid out per
    ``rules``, default ``Rules(cfg.rule_overrides)``): the activations
    are laid out per their logical axes (``sharding.shard``, as JAX's
    annotations), attention takes the shardings of its operands, and
    plain tensors (positions, masks) count as replicated. The MoE layer
    runs expert-parallel (``layers.apply_moe``), and MLA and Mamba2
    (``layers.apply_mamba``: the heads over "model"; an ssm or hybrid
    model) per JAX's head layouts in modes train and prefill. The image
    embeddings are laid out per ("act_batch", None, "act_embed")
    (``sharding.IMAGE_AXES``, JAX's input layout) before they reach the
    cross sub-layers; an audio model sums its codebooks' sharded lookups.
    In mode decode ``cache`` is ``init_cache``'s on the mesh: GQA writes
    each rank's shard of the sequence-sharded cache and attends through
    ``dispatch.decode_attention``; an MLA or Mamba2 model raises
    (``check_mesh``).
    """
    check_mesh(cfg, mesh, "forward", mode)
    rules = rules or Rules(cfg.rule_overrides)
    if mesh is not None and image_embeds is not None:
        image_embeds = lay_out(image_embeds, rules.sharding(
            IMAGE_AXES, mesh, image_embeds.shape))
    with mesh_context(mesh):
        return _forward(params, cfg, tokens, mode, cache, cache_index,
                        positions, segment_ids, image_embeds, rules, mesh)


def _embed(ew, cfg: ModelConfig, tokens, rules, mesh):
    """The token embedding: audio sums its codebooks' lookups.

    JAX indexes ``tokens[:, c]`` for every codebook, and clamps an index
    past the codebook axis: its greedy generation feeds (B, 1, 1) tokens
    back to an audio model, so every codebook embeds that one row
    (ROADMAP.md reference caveat 15). Torch raises there, so the index is
    clamped here, explicitly. ``mesh``: each lookup is
    ``sharding.embed_lookup``'s, laid out per ("act_batch", "act_seq",
    "act_embed")."""
    def lookup(w, toks):
        return (embed_lookup(w, toks, rules, mesh) if mesh is not None
                else w[toks])
    if cfg.family == "audio":
        last = tokens.shape[1] - 1
        return sum(lookup(ew[c], tokens[:, min(c, last)])
                   for c in range(cfg.n_codebooks))
    return lookup(ew, tokens)


def _forward(params, cfg, tokens, mode, cache, cache_index, positions,
             segment_ids, image_embeds, rules, mesh):
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    x = _embed(params["tok_embed"]["w"], cfg, tokens, rules, mesh)
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
        if mode == "decode":
            positions = cache_index + positions
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"]["w"][positions]

    new_cache = {} if cache is not None else None
    aux = torch.zeros((), device=x.device)
    for i, (kind, n) in enumerate(cfg.segments):
        name = f"seg{i}_{kind}"
        seg_cache = cache[name] if cache is not None else None
        x, seg_cache, seg_aux = T.apply_segment(
            kind, n, cfg, params["segments"][name], x, positions, mode,
            seg_cache, cache_index, segment_ids, image_embeds, rules=rules,
            mesh=mesh)
        if new_cache is not None:
            new_cache[name] = seg_cache
        if seg_aux is not None:
            aux = aux + seg_aux
    x = L.rmsnorm(x, params["final_norm"]["s"], cfg.rms_eps)
    return x, new_cache, aux


def head_weight(params, cfg: ModelConfig):
    """(w, transposed): lm_head.w (D, V), or the tied tok_embed.w (V, D);
    audio (C, D, V) and (C, V, D)."""
    if cfg.tie_embeddings:
        return params["tok_embed"]["w"], True
    return params["lm_head"]["w"], False


LOGITS_AXES = ("act_batch", "act_seq", "act_vocab")


def logits_from_hidden(params, cfg: ModelConfig, hidden,
                       rules: Rules = None):
    """Full-vocab logits (serving). hidden (B, S, D) -> (B, S, V_padded),
    audio (B, C, S, V_padded), one row per codebook head; on a mesh laid
    out per :data:`LOGITS_AXES`. The audio logits take those three axes on
    their first three dims, as JAX's annotation does: "act_vocab" lands on
    S and V stays whole (ROADMAP.md reference caveat 16)."""
    w, tied = head_weight(params, cfg)
    if cfg.family == "audio":
        # one product a codebook head, as the dense head's (a (B, S, D) x
        # (C, D, V) einsum flattens dims DTensor cannot flatten sharded)
        out = torch.stack([hidden @ (w[c].T if tied else w[c])
                           for c in range(cfg.n_codebooks)], dim=1)
    else:
        out = hidden @ (w.T if tied else w)
    return shard(_mask_pad_vocab(out, cfg), LOGITS_AXES,
                 rules or Rules(cfg.rule_overrides))


def _mask_pad_vocab(logits, cfg: ModelConfig):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=logits.device))


# --------------------------------------------------------------------- loss

def lm_loss(params, cfg: ModelConfig, hidden, labels, weights=None,
            rules: Rules = None, mesh=None):
    """Cross-entropy over the LM head without full-sequence logits.

    The route is ``kernels.dispatch.xent_loss``: the xent kernels behind a
    ``torch.autograd.Function``, whose logits live only as a tile. The JAX
    package's chunked-scan route (``REPRO_FUSED=off``) has no counterpart:
    the port has no such switch. labels (B, S) int, -1 = masked;
    ``weights`` (optional, (B, S) f32) scales each token's loss, and the
    mean divides by the summed effective weight of the tokens with label
    >= 0 (an all-masked batch gives loss 0). Returns (mean_loss,
    total_weight). A tied head (``cfg.tie_embeddings``) is the (V, D)
    ``tok_embed.w``, read in place by the transposed kernels, whose dW
    lands in (V, D); autograd adds it to the lookup's gradient in w's
    dtype, as JAX sums the two cotangents. Audio: labels (B, C, S); each
    codebook's head (``w[c]``, (D, V), or (V, D) tied) runs its own
    ``xent_loss`` over the same hidden states, and the mean divides the
    summed losses by the summed weights of all heads; per-token
    ``weights`` raise ``ValueError`` there, as in JAX.

    ``mesh``: the loss takes the hidden states' ("act_batch", "act_seq",
    "act_embed") and the head's ("embed", "vocab") shardings (tied:
    ("vocab", "embed")) from ``rules``, as JAX does, so the vocabulary
    shards of the head each run the kernels with their ``col_offset``. An
    audio model's heads all take the sharding of one head (the rules at
    ``w.shape[-2:]``, JAX's ``head_shape``).
    """
    if weights is not None and cfg.family == "audio":
        raise ValueError("lm_loss: per-token weights are not supported for "
                         "the audio multi-codebook head")
    rules = rules or Rules(cfg.rule_overrides)
    w, tied = head_weight(params, cfg)
    h_sh = w_sh = None
    if mesh is not None:
        h_sh = rules.sharding(("act_batch", "act_seq", "act_embed"), mesh,
                              hidden.shape)
        w_sh = rules.sharding(("vocab", "embed") if tied
                              else ("embed", "vocab"), mesh, w.shape[-2:])
    if cfg.family == "audio":
        with mesh_context(mesh):
            tot_l = tot_w = 0.0
            for c in range(cfg.n_codebooks):
                labs = labels[:, c]
                losses = dispatch.xent_loss(hidden, w[c], labs,
                                            vocab_size=cfg.vocab_size,
                                            transposed=tied,
                                            h_sharding=h_sh, w_sharding=w_sh)
                tot_l = tot_l + losses.sum()
                tot_w = tot_w + (labs >= 0).float().sum()
            return tot_l / torch.where(tot_w > 0, tot_w, 1.0), tot_w
    with mesh_context(mesh):
        losses = dispatch.xent_loss(hidden, w, labels,
                                    vocab_size=cfg.vocab_size,
                                    weights=weights, transposed=tied,
                                    h_sharding=h_sh, w_sharding=w_sh)
        valid = labels >= 0
        if weights is not None:
            ws = torch.where(valid, weights.float(), 0.0).sum()
        else:
            ws = valid.float().sum()
        return losses.sum() / torch.where(ws > 0, ws, 1.0), ws


def loss_fn(params, cfg: ModelConfig, batch: dict, aux_coef: float = 0.01,
            rules: Rules = None, mesh=None):
    """Full training loss. batch: tokens, labels, [image_embeds],
    [positions, segment_ids, loss_weights] (the last three:
    packed-document batches). -> (total, {"loss", "aux", "weight"}).
    ``mesh``: see ``forward`` and ``lm_loss``.
    """
    hidden, _, aux = forward(params, cfg, batch["tokens"],
                             image_embeds=batch.get("image_embeds"),
                             mode="train",
                             positions=batch.get("positions"),
                             segment_ids=batch.get("segment_ids"),
                             rules=rules, mesh=mesh)
    loss, weight = lm_loss(params, cfg, hidden, batch["labels"],
                           weights=batch.get("loss_weights"), rules=rules,
                           mesh=mesh)
    with mesh_context(mesh):
        total = loss + aux_coef * aux
    return total, {"loss": loss, "aux": aux, "weight": weight}
