"""Serving: batched prefill, then single-token greedy decode over a
preallocated KV cache (the port of ``repro.training.serving``).

The cache keeps the JAX layout, (L, B, max_seq, K, hd) per segment, and
the decode step writes it IN PLACE: the returned ``ServeState`` holds the
same cache tensors it was given. ``index`` is a 0-d int32 tensor on the
device, so a decode step never waits for the host.
"""
from __future__ import annotations

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
    """prefill(params, tokens) -> (ServeState, last_logits (B, 1, V)).

    The cache is sized ``max_seq`` so decode can continue in place. Runs
    on the device of ``tokens``.
    """

    @torch.no_grad()
    def prefill_step(params, tokens):
        B, S = tokens.shape
        cache = init_cache(cfg, B, max_seq, device=tokens.device)
        hidden, pre_cache, _ = forward(params, cfg, tokens, mode="prefill",
                                       cache=cache)
        _merge(cache, pre_cache)
        logits = logits_from_hidden(params, cfg, hidden[:, -1:])
        index = torch.tensor(S, dtype=torch.int32, device=tokens.device)
        return ServeState(cache, index), logits

    return prefill_step


def make_decode_step(cfg):
    """decode(params, state, tokens) -> (state, logits). tokens (B, 1)."""

    @torch.no_grad()
    def decode_step(params, state: ServeState, tokens):
        hidden, cache, _ = forward(params, cfg, tokens, mode="decode",
                                   cache=state.cache,
                                   cache_index=state.index)
        logits = logits_from_hidden(params, cfg, hidden)
        return ServeState(cache, state.index + tokens.shape[-1]), logits

    return decode_step


def greedy_generate(cfg, params, prompt, n_steps: int, max_seq: int,
                    device=None) -> torch.Tensor:
    """Greedy generation: one prefill, then ``n_steps - 1`` decode steps.

    ``prompt`` (B, S) int tokens (tensor or array); ``params`` must live on
    ``device`` (default ``cuda``). Returns (B, n_steps) int32 tokens.
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
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    state, logits = prefill(params, prompt)
    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
    out = [tok]
    for _ in range(n_steps - 1):
        state, logits = decode(params, state, tok)
        tok = logits[:, -1].argmax(dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)
