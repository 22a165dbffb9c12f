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
"""
from __future__ import annotations

import time
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import forward, init_cache, logits_from_hidden


class ServeState(NamedTuple):
    cache: Any
    index: torch.Tensor  # current cache fill (next write position)


def _merge(full: dict, pre: dict) -> None:
    """Write the prefill's S-length caches into the front of ``full``."""
    for k, f in full.items():
        if isinstance(f, dict):
            _merge(f, pre[k])
        else:
            f[tuple(slice(0, n) for n in pre[k].shape)] = pre[k]


def make_prefill_step(cfg, max_seq: int):
    """prefill(params, tokens[, image_embeds]) -> (ServeState, last_logits
    (B, 1, V); audio (B, C, 1, V)).

    The cache is sized ``max_seq`` so decode can continue in place. Runs
    on the device of ``tokens``.
    """

    @torch.no_grad()
    def prefill_step(params, tokens, image_embeds=None):
        B, S = tokens.shape[0], tokens.shape[-1]
        cache = init_cache(cfg, B, max_seq, device=tokens.device)
        hidden, pre_cache, _ = forward(params, cfg, tokens,
                                       image_embeds=image_embeds,
                                       mode="prefill", cache=cache)
        _merge(cache, pre_cache)
        logits = logits_from_hidden(params, cfg, hidden[:, -1:])
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        return ServeState(cache, index), logits

    return prefill_step


def make_decode_step(cfg):
    """decode(params, state, tokens[, image_embeds]) -> (state, logits).
    tokens (B, 1); audio (B, C, 1)."""

    @torch.no_grad()
    def decode_step(params, state: ServeState, tokens, image_embeds=None):
        hidden, cache, _ = forward(params, cfg, tokens,
                                   image_embeds=image_embeds, mode="decode",
                                   cache=state.cache,
                                   cache_index=state.index)
        logits = logits_from_hidden(params, cfg, hidden)
        return ServeState(cache, state.index + tokens.shape[-1]), logits

    return decode_step


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def greedy_generate(cfg, params, prompt, n_steps: int, max_seq: int,
                    device=None, logger=None) -> torch.Tensor:
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
    """
    device = resolve_device(device)
    prompt = torch.as_tensor(prompt, device=device)
    if prompt.shape[-1] + n_steps - 1 > max_seq:
        # the decode steps write the cache at a device-side index, which
        # cannot be checked there without a host sync
        raise ValueError(f"prompt of {prompt.shape[-1]} + {n_steps - 1} "
                         f"decode steps exceeds max_seq={max_seq}")
    w = params["tok_embed"]["w"]
    if w.device != prompt.device:
        raise ValueError(f"params on {w.device}, generation on {device}")

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
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
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = [tok]
    lat: list = []
    for _ in range(n_steps - 1):
        t0 = time.perf_counter()
        state, logits = decode(params, state, tok)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
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
