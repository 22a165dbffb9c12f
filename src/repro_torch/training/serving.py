"""Serving: batched prefill, then single-token greedy decode over a
preallocated KV cache (the port of ``repro.training.serving``).

The cache keeps the JAX layout, (L, B, max_seq, K, hd) per segment, and
the decode step writes it IN PLACE: the returned ``ServeState`` holds the
same cache tensors it was given. ``index`` is a 0-d int32 tensor on the
device, so a decode step never waits for the host.

The VLM's prefill and decode take ``image_embeds`` (B, T, D); its cross
sub-layers keep no cache and recompute their keys and values from them
at every step, as JAX does. An audio model's prompts are (B, C, S), its
decode tokens (B, C, 1) and its logits (B, C, 1, V).

On a ("data", "model") mesh (``rules``, ``mesh``) the cache is JAX's
sequence-sharded one (``models.model.cache_logical_axes``: its batch over
"data", its T over "model"), written in place shard by shard, for every
family whose attention is GQA (dense, MoE, the VLM, audio); MLA and
Mamba2 decode on a mesh raise (``models.model.check_mesh``).
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import forward, init_cache, logits_from_hidden
from repro_torch.models.sharding import (NamedSharding, P, Rules,
                                         batch_axes, full_value, is_dtensor,
                                         lay_out, shard_index,
                                         spec_mesh_axes, spec_of)


class ServeState(NamedTuple):
    cache: Any
    index: torch.Tensor  # current cache fill (next write position)


def _merge(full: dict, pre: dict) -> None:
    """Write the prefill's S-length caches into the front of ``full``.

    On a mesh (``full`` DTensors laid out per ``cache_logical_axes``) the
    prefill's leaf takes the cache's layout with its S dim whole, and each
    rank copies only the positions of its own shard of T: [r T_l, (r + 1)
    T_l) cut to the S written."""
    for k, f in full.items():
        if isinstance(f, dict):
            _merge(f, pre[k])
            continue
        p = pre[k]
        if not is_dtensor(f):
            f[tuple(slice(0, n) for n in p.shape)] = p
            continue
        sh = spec_of(f)
        cut = [d for d in range(f.ndim) if p.shape[d] != f.shape[d]]
        spec = tuple(None if d in cut else e for d, e in
                     enumerate(tuple(sh.spec) + (None,) * f.ndim))[:f.ndim]
        local = f.to_local()
        pl = lay_out(p, NamedSharding(sh.mesh, P(*spec))).to_local()
        for d in cut:  # the sequence dim: this rank's positions of S
            T_l = local.shape[d]
            lo = shard_index(sh.mesh, spec_mesh_axes(sh.spec, f.ndim)[d]) \
                * T_l
            lo = min(lo, p.shape[d])
            n = min(p.shape[d] - lo, T_l)
            local, pl = local.narrow(d, 0, n), pl.narrow(d, lo, n)
        local.copy_(pl)


def _lay_out_tokens(tokens, rules, mesh):
    """The prompt or decode tokens ((B, S), audio (B, C, S)) laid out per
    ``sharding.batch_axes`` on ``mesh`` (as they are without one)."""
    if mesh is None:
        return tokens
    return lay_out(tokens, rules.sharding(batch_axes("tokens", tokens.ndim),
                                          mesh, tokens.shape))


def _local(x):
    return x.to_local() if is_dtensor(x) else x


def make_prefill_step(cfg, max_seq: int, rules: Rules = None, mesh=None):
    """prefill(params, tokens[, image_embeds]) -> (ServeState, last_logits
    (B, 1, V); audio (B, C, 1, V)).

    The cache is sized ``max_seq`` so decode can continue in place. Runs
    on the device of ``tokens``. ``mesh`` (params DTensors laid out per
    ``rules``, default ``Rules(cfg.rule_overrides)``): the tokens are
    laid out per ``sharding.batch_axes`` (the images per ``IMAGE_AXES``,
    in ``forward``), the cache per ``cache_logical_axes`` (T over
    "model"), each rank writing its own positions of the prefill's k/v,
    and the logits per ``LOGITS_AXES``.
    """
    rules = rules or Rules(cfg.rule_overrides)

    @torch.no_grad()
    def prefill_step(params, tokens, image_embeds=None):
        B, S = tokens.shape[0], tokens.shape[-1]
        device = _local(tokens).device
        tokens = _lay_out_tokens(tokens, rules, mesh)
        cache = init_cache(cfg, B, max_seq, device=device, rules=rules,
                           mesh=mesh)
        hidden, pre_cache, _ = forward(params, cfg, tokens,
                                       image_embeds=image_embeds,
                                       mode="prefill", cache=cache,
                                       rules=rules, mesh=mesh)
        _merge(cache, pre_cache)
        logits = logits_from_hidden(params, cfg, hidden[:, -1:], rules)
        index = torch.tensor(S, dtype=torch.int32, device=device)
        return ServeState(cache, index), logits

    return prefill_step


def make_decode_step(cfg, rules: Rules = None, mesh=None):
    """decode(params, state, tokens[, image_embeds]) -> (state, logits).
    tokens (B, 1); audio (B, C, 1). ``mesh``: as ``make_prefill_step``;
    each rank writes the new k/v into its shard of the cache only where it
    owns ``state.index``, and attention runs each rank's shard on the
    decode kernel, the partials combined over "model" by their lse
    (``dispatch.decode_attention``)."""
    rules = rules or Rules(cfg.rule_overrides)

    @torch.no_grad()
    def decode_step(params, state: ServeState, tokens, image_embeds=None):
        hidden, cache, _ = forward(params, cfg,
                                   _lay_out_tokens(tokens, rules, mesh),
                                   image_embeds=image_embeds, mode="decode",
                                   cache=state.cache,
                                   cache_index=state.index, rules=rules,
                                   mesh=mesh)
        logits = logits_from_hidden(params, cfg, hidden, rules)
        return ServeState(cache, state.index + tokens.shape[-1]), logits

    return decode_step


def _next_token(logits) -> torch.Tensor:
    """(B, 1) int32: the argmax of the last row of the full logits (an
    audio model's last codebook's, as JAX's)."""
    return full_value(logits)[:, -1].argmax(dim=-1).to(torch.int32)[:, None]


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def greedy_generate(cfg, params, prompt, n_steps: int, max_seq: int,
                    rules: Rules = None, mesh=None, device=None,
                    logger=None) -> torch.Tensor:
    """Greedy generation: one prefill, then ``n_steps - 1`` decode steps.

    ``prompt`` (B, S) int tokens (tensor or array); ``params`` must live on
    ``device`` (default ``cuda``). Returns (B, n_steps) int32 tokens.

    As JAX's, it passes no image embeddings (a VLM's cross sub-layers then
    run causal self-attention over the text). For an audio prompt (B, C,
    S) it takes ``logits[:, -1]``, the last codebook's (B, 1, V), as JAX's
    does: each next token is (B, 1, 1), every codebook of the next step
    embeds it (``models.model._embed``), and the result is (B, n_steps,
    1).

    ``logger``: an optional :class:`repro_torch.obs.MetricsLogger`. Prefill
    and decode latencies then go through the training metrics plane, as
    in the JAX package: one ``kind="serve"`` record per phase — the
    prefill's wall time and prompt tokens/s, and the decode latency
    distribution (mean/p50/p99 per token, tokens/s) over the generated
    steps. Only with a logger does the loop wait for the card
    (``torch.cuda.synchronize``) after each phase and step, so the times
    are real step latencies. The first decode step is reported apart as
    ``compile_ms``: in the port it carries the decode kernels' lazy
    loads (JAX's carries its compile).

    ``rules``, ``mesh``: serving on a mesh (``make_prefill_step``,
    ``make_decode_step``; ``params`` laid out by
    ``models.model.place_params``); each next token is the argmax of the
    full logits (``sharding.full_value``), so the result is a plain
    tensor, the same on every rank.
    """
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device)
    if prompt.shape[-1] + n_steps - 1 > max_seq:
        # the decode steps write the cache at a device-side index, which
        # cannot be checked there without a host sync
        raise ValueError(f"prompt of {prompt.shape[-1]} + {n_steps - 1} "
                         f"decode steps exceeds max_seq={max_seq}")
    w = _local(params["tok_embed"]["w"])
    if w.device != prompt.device:
        raise ValueError(f"params on {w.device}, generation on {device}")

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prefill = make_prefill_step(cfg, max_seq, rules, mesh)
    decode = make_decode_step(cfg, rules, mesh)
    B = int(prompt.shape[0])
    if logger is not None:
        wait()
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt)
    if logger is not None:
        wait()
        dt = time.perf_counter() - t0
        n_prompt = B * int(prompt.shape[-1])
        logger.log("serve", 0, phase="prefill", batch=B,
                   prompt_tokens=n_prompt, latency_ms=1e3 * dt,
                   tokens_per_s=n_prompt / max(dt, 1e-9))
    tok = _next_token(logits)
    out = [tok]
    lat: list = []
    for _ in range(n_steps - 1):
        t0 = time.perf_counter()
        state, logits = decode(params, state, tok)
        tok = _next_token(logits)
        if logger is not None:
            wait()
            lat.append(time.perf_counter() - t0)
        out.append(tok)
    if logger is not None and lat:
        # the first decode step pays the lazy kernel loads: report it apart
        # from the steady distribution
        steady = sorted(lat[1:]) if len(lat) > 1 else sorted(lat)
        logger.log("serve", 0, phase="decode", batch=B,
                   decode_steps=len(lat), compile_ms=1e3 * lat[0],
                   mean_ms=1e3 * sum(steady) / len(steady),
                   p50_ms=1e3 * _quantile(steady, 0.50),
                   p99_ms=1e3 * _quantile(steady, 0.99),
                   tokens_per_s=B * len(steady) / max(sum(steady), 1e-9))
    return torch.cat(out, dim=1)
