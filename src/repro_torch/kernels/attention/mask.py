"""Attention mask specification: a copy of ``repro.kernels.attention.mask``.

A position pair (query ``i``, key ``j``) is valid iff ALL live clauses
hold:

  * ``causal``:   ``offset + i >= j`` (rectangular causal; ``offset`` is
    ``T - S`` so ``T == S`` is ordinary causal and ``T > S`` a
    cached-prefill continuation);
  * ``kv_len``:   ``j < kv_len`` (decode over a partially filled cache);
  * ``segments``: ``q_seg[b, i] == kv_seg[b, j]`` (no cross-document
    attention in packed batches; pad positions carry segment id 0 and so
    form their own island).

``MaskSpec`` holds only hashable Python values; the operands it describes
(the ``kv_len`` scalar and the ``(B, S)``/``(B, T)`` segment ids) travel
beside q/k/v. ``segments`` and ``kv_len`` are mutually exclusive
(packing is a train-time format, the fill bound a decode-time one).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class MaskSpec(NamedTuple):
    """Static (hashable) description of an attention mask.

    ``offset`` is only meaningful when ``causal``; it is pinned to 0
    otherwise so specs compare canonically.
    """
    causal: bool = True
    offset: int = 0
    has_kv_len: bool = False
    has_segments: bool = False


def mask_spec(S: int, T: int, *, causal: bool = True, kv_len=None,
              segments=None) -> MaskSpec:
    """Canonical :class:`MaskSpec` for a (S query, T key) problem.

    Rejects causal with T < S (queries past the key range) and segments
    together with kv_len (packed batches have no partial cache fill).
    """
    if causal and T < S:
        raise ValueError(f"causal attention needs T >= S, got S={S} T={T}")
    if segments is not None and kv_len is not None:
        raise ValueError("segments and kv_len are mutually exclusive "
                         "(packed batches have no cache-fill bound)")
    return MaskSpec(causal=bool(causal), offset=(T - S) if causal else 0,
                    has_kv_len=kv_len is not None,
                    has_segments=segments is not None)


def mask_array(spec: MaskSpec, S: int, T: int, *, kv_len=None,
               segments: Optional[Tuple] = None,
               device=None) -> torch.Tensor:
    """Dense boolean validity mask for reference paths.

    ``(1, S, T)`` without a segment clause (the mask is batch-invariant)
    and ``(B, S, T)`` with one. Operands must be passed iff the spec
    declares them; ``kv_len`` may be an int or a 0-d integer tensor.
    """
    if spec.has_kv_len != (kv_len is not None):
        raise ValueError("kv_len operand does not match spec.has_kv_len")
    if spec.has_segments != (segments is not None):
        raise ValueError("segments operand does not match spec.has_segments")
    if device is None and segments is not None:
        device = segments[0].device
    cols = torch.arange(T, device=device)
    valid = torch.ones((1, S, T), dtype=torch.bool, device=device)
    if spec.causal:
        qpos = spec.offset + torch.arange(S, device=device)
        valid &= (qpos[:, None] >= cols[None, :])[None]
    if spec.has_kv_len:
        valid &= (cols < torch.as_tensor(kv_len, device=device))[None, None, :]
    if spec.has_segments:
        q_seg, kv_seg = segments
        valid = valid & (q_seg[:, :, None] == kv_seg[:, None, :])
    return valid
