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
With ``transposed=True`` w is the tied head as stored, (V, D): its rows
are the vocabulary, and dW comes out (V, D) with the rows at or past
``vocab_size`` 0. ``col_offset`` makes w one shard of a vocabulary-sharded
head: its column c is the global id ``col_offset + c``, which the labels
and ``vocab_size`` are read against (a label another shard owns matches
nothing, and a shard with no valid column gives lse -inf and no
gradient).
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
    # the label's logit by a one-hot select (exact: one term), which
    # DTensor partitions where it cannot partition a gather
    col = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.where(col == labels[..., None], logits, 0.0).sum(-1)
    return lse, torch.where(labels >= 0, ll, 0.0)


def losses(h, w, labels, vocab_size: int):
    """Per-token cross-entropy, 0 for masked (-1) labels; f32.

    Differentiable in (h, w): the value and gradient that
    ``dispatch.xent_loss`` must reproduce.
    """
    lse, ll = lse_ll(h, w, labels, vocab_size)
    return torch.where(labels >= 0, lse - ll, 0.0)


def use_layout(w, transposed: bool):
    """w in the use layout (D, V): the tied (V, D) head as a view."""
    return w.t() if transposed else w


def _parts(h, w, labels, vocab_size: int, col_offset: int = 0):
    """(f32 logits (N, V), valid column mask (V,), label one-hot (N, V));
    w (D, V), its column c the global id ``col_offset + c``."""
    logits = h.float() @ w.float()
    col = col_offset + torch.arange(w.shape[1], device=h.device)
    valid = col < vocab_size
    onehot = (col[None, :] == labels[:, None].long()) & valid[None, :]
    return logits, valid, onehot


def xent_fwd_ref(h, w, labels, *, vocab_size: int, col_offset: int = 0,
                 transposed=False):
    """(lse, ll): h (N, D), w (D, V) or (V, D) when ``transposed``, labels
    (N,) -> two (N,) f32."""
    logits, valid, onehot = _parts(h, use_layout(w, transposed), labels,
                                   vocab_size, col_offset)
    lse = torch.logsumexp(torch.where(valid, logits, float("-inf")), dim=1)
    ll = torch.where(onehot, logits, 0.0).sum(dim=1)
    return lse, ll


def dlogits_ref(h, w, labels, lse, gl, *, vocab_size: int,
                col_offset: int = 0, transposed=False):
    """The gl-weighted (softmax - onehot), (N, V) f32, 0 on left-out
    columns; the operand both backward kernels contract."""
    logits, valid, onehot = _parts(h, use_layout(w, transposed), labels,
                                   vocab_size, col_offset)
    p = torch.where(valid, torch.exp(logits - lse.float()[:, None]), 0.0)
    return (p - onehot.float()) * gl.float()[:, None]


def xent_bwd_dh_ref(h, w, labels, lse, gl, *, vocab_size: int,
                    col_offset: int = 0, out_dtype=torch.float32,
                    transposed=False):
    """dH (N, D) = dlogits @ w^T (w (D, V); dlogits @ w for the tied (V,
    D)), w zeroed on left-out vocabulary entries."""
    dlog = dlogits_ref(h, w, labels, lse, gl, vocab_size=vocab_size,
                       col_offset=col_offset, transposed=transposed)
    wu = use_layout(w, transposed)
    col = col_offset + torch.arange(wu.shape[1], device=w.device)
    w_eff = torch.where(col < vocab_size, wu.float(), 0.0)
    return (dlog @ w_eff.T).to(out_dtype)


def xent_bwd_dw_ref(h, w, labels, lse, gl, *, vocab_size: int,
                    col_offset: int = 0, out_dtype=torch.float32,
                    transposed=False):
    """dW = h^T @ dlogits (tokens contracted), (D, V); for the tied head
    dlogits^T @ h, (V, D)."""
    dlog = dlogits_ref(h, w, labels, lse, gl, vocab_size=vocab_size,
                       col_offset=col_offset, transposed=transposed)
    if transposed:
        return (dlog.T @ h.float()).to(out_dtype)
    return (h.float().T @ dlog).to(out_dtype)
