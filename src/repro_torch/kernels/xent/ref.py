"""Plain PyTorch versions of the fused LM-head cross-entropy.

They materialize the full (N, V) logit matrix, as
``repro.kernels.xent.ref`` does, so they are test-scale references: the
CPU path of the wrappers in ``xent.py`` and the yardstick the CUDA kernels
are held against on the card. Logits are f32 products of the inputs
upcast, which is what the kernels accumulate.

``logits_masked``, ``lse_ll`` and ``losses`` are the JAX oracle's
functions (padded columns at -1e9, differentiable by autograd). The three
``*_ref`` functions compute exactly what their kernel emits from the same
arguments: columns at or past ``vocab_size`` (or past w's width) are left
out of the log-sum-exp, a label of -1 or one on a left-out column matches
nothing, and the backward's ``(softmax - onehot)`` is weighted by ``gl``.
"""
from __future__ import annotations

import torch

NEG = -1e9


def logits_masked(h, w, vocab_size: int):
    """f32 logits (..., V) with padded-vocab columns masked to -1e9."""
    logits = h.float() @ w.float()
    if vocab_size == w.shape[-1]:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < vocab_size, logits, NEG)


def lse_ll(h, w, labels, vocab_size: int):
    """Per-token (logsumexp, label-logit); ll is 0 for masked (-1) labels.

    h (..., D), w (D, V), labels (...) int -> two f32 tensors of
    labels.shape.
    """
    logits = logits_masked(h, w, vocab_size)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp_min(0).long()[..., None])[..., 0]
    return lse, torch.where(labels >= 0, ll, 0.0)


def losses(h, w, labels, vocab_size: int):
    """Per-token cross-entropy, 0 for masked (-1) labels; f32.

    Differentiable in (h, w): the value and gradient that
    ``dispatch.xent_loss`` must reproduce.
    """
    lse, ll = lse_ll(h, w, labels, vocab_size)
    return torch.where(labels >= 0, lse - ll, 0.0)


def _parts(h, w, labels, vocab_size: int):
    """(f32 logits (N, V), valid column mask (V,), label one-hot (N, V))."""
    logits = h.float() @ w.float()
    col = torch.arange(w.shape[1], device=h.device)
    valid = col < vocab_size
    onehot = (col[None, :] == labels[:, None].long()) & valid[None, :]
    return logits, valid, onehot


def xent_fwd_ref(h, w, labels, *, vocab_size: int):
    """(lse, ll): h (N, D), w (D, V), labels (N,) -> two (N,) f32."""
    logits, valid, onehot = _parts(h, w, labels, vocab_size)
    lse = torch.logsumexp(torch.where(valid, logits, float("-inf")), dim=1)
    ll = torch.where(onehot, logits, 0.0).sum(dim=1)
    return lse, ll


def dlogits_ref(h, w, labels, lse, gl, *, vocab_size: int):
    """The gl-weighted (softmax - onehot), (N, V) f32, 0 on left-out
    columns; the operand both backward kernels contract."""
    logits, valid, onehot = _parts(h, w, labels, vocab_size)
    p = torch.where(valid, torch.exp(logits - lse.float()[:, None]), 0.0)
    return (p - onehot.float()) * gl.float()[:, None]


def xent_bwd_dh_ref(h, w, labels, lse, gl, *, vocab_size: int,
                    out_dtype=torch.float32):
    """dH (N, D) = dlogits @ w^T, w zeroed on left-out columns."""
    dlog = dlogits_ref(h, w, labels, lse, gl, vocab_size=vocab_size)
    col = torch.arange(w.shape[1], device=w.device)
    w_eff = torch.where(col < vocab_size, w.float(), 0.0)
    return (dlog @ w_eff.T).to(out_dtype)


def xent_bwd_dw_ref(h, w, labels, lse, gl, *, vocab_size: int,
                    out_dtype=torch.float32):
    """dW (D, V) = h^T @ dlogits (tokens contracted)."""
    dlog = dlogits_ref(h, w, labels, lse, gl, vocab_size=vocab_size)
    return (h.float().T @ dlog).to(out_dtype)
