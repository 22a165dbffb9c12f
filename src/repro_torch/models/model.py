"""Top-level model API: spec, init, caches, forward, logits, loss (dense).

Parameter tree layout, as in ``repro.models.model``::

    {"tok_embed": {"w"},
     "segments": {"seg<i>_<kind>": {...stacked super-block params...}},
     "final_norm": {"s"},
     "lm_head": {"w"}}          # absent with cfg.tie_embeddings

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


# ----------------------------------------------------------------- spec tree

def _stacked(spec_tree: dict, n: int) -> dict:
    return {k: _stacked(v, n) if isinstance(v, dict)
            else L.Spec((n,) + tuple(v.shape), v.init)
            for k, v in spec_tree.items()}


def model_spec(cfg: ModelConfig) -> dict:
    V, D = cfg.padded_vocab, cfg.d_model
    segs = {f"seg{i}_{kind}": _stacked(T.superblock_spec(cfg, kind), n)
            for i, (kind, n) in enumerate(cfg.segments)}
    out = {
        "tok_embed": {"w": L.Spec((V, D))},
        "segments": segs,
        "final_norm": {"s": L.Spec((D,), "ones")},
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": L.Spec((D, V))}
    if cfg.pos_embed == "learned":
        out["pos_embed"] = {"w": L.Spec((cfg.max_position, D))}
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


def count_params(shapes: dict) -> int:
    return int(sum(math.prod(s) for s in shapes.values()))


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
    """Random params: normal(0, 0.02) matrices, ones for norms, zero biases.

    The init rules are the JAX package's; the draws come from ``generator``
    (in path order, on the generator's device) and differ from
    ``jax.random``'s. ``device`` defaults to ``cuda``.
    """
    device = resolve_device(device)
    flat = {}
    for path, spec in flatten(model_spec(cfg)).items():
        if spec.init == "ones":
            x = torch.ones(spec.shape)
        elif spec.init == "zeros":
            x = torch.zeros(spec.shape)
        else:
            x = 0.02 * torch.randn(spec.shape, generator=generator,
                                   device=generator.device)
        flat[path] = x.to(device=device, dtype=cfg.torch_dtype)
    return Params(flat)


# -------------------------------------------------------------------- cache

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache, per segment (L, B, max_seq, K, hd) like the JAX one."""
    dtype = dtype or cfg.torch_dtype
    device = resolve_device(device)
    out = {}
    for i, (kind, n) in enumerate(cfg.segments):
        one = T.superblock_cache(cfg, kind, batch, max_seq, dtype, device)
        out[f"seg{i}_{kind}"] = {
            name: {k: x.new_zeros((n,) + x.shape) for k, x in c.items()}
            for name, c in one.items()}
    return out


# ------------------------------------------------------------------ forward

def forward(params, cfg: ModelConfig, tokens, *, mode: str = "train",
            cache=None, cache_index=None, positions=None):
    """Run the backbone on tokens (B, S). Returns (hidden, new_cache, aux).

    ``mode`` is train | prefill | decode (see ``layers.apply_attention``);
    decode positions are ``cache_index + arange(S)``. ``aux`` (the MoE
    load-balance loss in the JAX package) is 0 for the dense family.
    """
    x = params["tok_embed"]["w"][tokens]
    S = x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)
        if mode == "decode":
            positions = cache_index + positions
    if cfg.pos_embed == "learned":
        x = x + params["pos_embed"]["w"][positions]

    new_cache = {} if cache is not None else None
    for i, (kind, n) in enumerate(cfg.segments):
        name = f"seg{i}_{kind}"
        seg_cache = cache[name] if cache is not None else None
        x, seg_cache = T.apply_segment(kind, n, cfg, params["segments"][name],
                                       x, positions, mode, seg_cache,
                                       cache_index)
        if new_cache is not None:
            new_cache[name] = seg_cache
    x = L.rmsnorm(x, params["final_norm"]["s"], cfg.rms_eps)
    return x, new_cache, torch.zeros((), device=x.device)


def head_weight(params, cfg: ModelConfig):
    """(w, transposed): lm_head.w (D, V), or the tied tok_embed.w (V, D)."""
    if cfg.tie_embeddings:
        return params["tok_embed"]["w"], True
    return params["lm_head"]["w"], False


def logits_from_hidden(params, cfg: ModelConfig, hidden):
    """Full-vocab logits (serving). hidden (B, S, D) -> (B, S, V_padded)."""
    w, tied = head_weight(params, cfg)
    out = hidden @ (w.T if tied else w)
    return _mask_pad_vocab(out, cfg)


def _mask_pad_vocab(logits, cfg: ModelConfig):
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits,
                       torch.tensor(-1e9, dtype=logits.dtype,
                                    device=logits.device))


# --------------------------------------------------------------------- loss

def lm_loss(params, cfg: ModelConfig, hidden, labels, weights=None):
    """Cross-entropy over the LM head without full-sequence logits.

    The route is ``kernels.dispatch.xent_loss``: the xent kernels behind a
    ``torch.autograd.Function``, whose logits live only as a tile. The JAX
    package's chunked-scan route (``REPRO_FUSED=off``) has no counterpart:
    the port has no such switch. labels (B, S) int, -1 = masked;
    ``weights`` (optional, (B, S) f32) scales each token's loss, and the
    mean divides by the summed effective weight of the tokens with label
    >= 0 (an all-masked batch gives loss 0). Returns (mean_loss,
    total_weight). The tied head and the audio codebook heads raise until
    they are ported (ROADMAP.md Queue 1 items 7 and 13).
    """
    if cfg.family == "audio":
        raise NotImplementedError("lm_loss: the audio codebook heads are not "
                                  "ported yet; ROADMAP.md Queue 1 item 13")
    w, tied = head_weight(params, cfg)
    if tied:
        raise NotImplementedError("lm_loss: the tied head in training is not "
                                  "ported yet; ROADMAP.md Queue 1 item 7")
    losses = dispatch.xent_loss(hidden, w, labels, vocab_size=cfg.vocab_size,
                                weights=weights)
    valid = labels >= 0
    if weights is not None:
        ws = torch.where(valid, weights.float(), 0.0).sum()
    else:
        ws = valid.float().sum()
    return losses.sum() / torch.where(ws > 0, ws, 1.0), ws


def loss_fn(params, cfg: ModelConfig, batch: dict, aux_coef: float = 0.01):
    """Full training loss. batch: tokens, labels, [positions,
    loss_weights]. -> (total, {"loss", "aux", "weight"}).

    Segment ids (packed documents) and image embeddings are not ported yet
    and raise (ROADMAP.md Queue 1 items 6 and 13).
    """
    for key, item in (("segment_ids", 6), ("image_embeds", 13)):
        if batch.get(key) is not None:
            raise NotImplementedError(f"loss_fn: batch[{key!r}] is not "
                                      f"ported yet; ROADMAP.md Queue 1 item "
                                      f"{item}")
    hidden, _, aux = forward(params, cfg, batch["tokens"], mode="train",
                             positions=batch.get("positions"))
    loss, weight = lm_loss(params, cfg, hidden, batch["labels"],
                           weights=batch.get("loss_weights"))
    total = loss + aux_coef * aux
    return total, {"loss": loss, "aux": aux, "weight": weight}
