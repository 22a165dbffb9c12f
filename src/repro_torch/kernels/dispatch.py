"""Kernel entry points for the model code and the optimizer.

Routing is by the tensors' device alone: a wrapper runs the plain version
on the CPU and the CUDA kernel on the card. Unlike
``repro.kernels.dispatch`` there is no ``REPRO_FUSED`` switch, no guarded
fallback and no sharding plan: a kernel that fails on the card raises
instead of quietly becoming the reference, and so does an entry point
that ``REPRO_FAULTS=dispatch_fail@<op>`` names (``FaultError``, before
any launch; the op names are the entry points' own).

Optimizer coverage (``supported``), as in the JAX package: 2-D and stacked
3-D leaves, norm kinds col/row/larger (``larger`` resolved per shape by
``resolve_kind``), float32/bfloat16 on the card, arbitrary shapes. Other
leaves take the plain path of the same maths (the jnp oracle of
``repro.kernels.dispatch``); that is coverage, not a fallback.

The write-mode entry points (``norm_update``, ``momentum_norm_update``)
update theta and the momentum in place on every route and return them;
``momentum_norm`` updates the momentum in place.

Attention (``flash_attention``) is the autograd ``FlashAttention`` over
``mha_fwd``, ``mha_bwd_dq`` and ``mha_bwd_dkv``.

Cross-entropy (``xent_loss``) is the LM head's loss as a
``torch.autograd.Function`` over the three xent kernels, with the contract
of the JAX package's ``custom_vjp``; h of 2 or 3 dims against a 2-D head
is covered (``xent_supported``), and other shapes raise.
"""
from __future__ import annotations

import os

import torch

from .attention import attention as _attn
from .attention.attention import mha_bwd_dkv, mha_bwd_dq, mha_fwd
from .colnorm import ref as _cref
from .colnorm.colnorm import canon3, norm_apply, norm_sumsq, update_apply
from .scale_head.ref import one_minus
from .scale_head.scale_head import head_update_apply, momentum_sumsq
from .xent.xent import xent_bwd_dh, xent_bwd_dw, xent_fwd

FUSED_KINDS = ("col", "row", "larger")
FUSED_NDIMS = (2, 3)


def _fault_gate(op: str) -> None:
    """``REPRO_FAULTS=dispatch_fail@<op>`` (or ``@*``) makes entry point
    ``op`` raise ``FaultError`` before any launch; a no-op when the
    variable is unset (see ``repro_torch.training.faults``)."""
    if os.environ.get("REPRO_FAULTS"):
        from repro_torch.training import faults
        faults.dispatch_gate(op)


class FlashAttention(torch.autograd.Function):
    """Blockwise (flash) attention, kernels both ways: the counterpart of
    the JAX package's ``custom_vjp`` (``dispatch._attn_fused``).

    forward(q, k, v, kv_len, q_seg, kv_seg, scale, causal): ``mha_fwd``
    gives (out, lse), and (q, k, v, out, lse) are saved. backward: delta =
    rowsum(f32(dO) * f32(out)) in the (B, H, S) layout, formed here outside
    the kernels as JAX's ``_bwd_parts`` does, then ``mha_bwd_dq`` for dQ
    and ``mha_bwd_dkv`` for dK and dV, each only when asked for.
    ``kv_len``, the segment ids (``q_seg``, ``kv_seg``: int32, or both
    None), ``scale`` and ``causal`` get no gradient (JAX: float0
    cotangents). Each step takes its plain version on CPU tensors and its
    kernel on CUDA tensors.
    """

    @staticmethod
    def forward(ctx, q, k, v, kv_len, q_seg, kv_seg, scale: float,
                causal: bool):
        segments = None if q_seg is None else (q_seg, kv_seg)
        out, lse = mha_fwd(q, k, v, kv_len, scale=scale, causal=causal,
                           segments=segments)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kv_len, ctx.segments = kv_len, segments
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()  # autograd may hand an expanded gradient
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        args = (q, k, v, dout, lse, delta.contiguous(), ctx.kv_len)
        kw = dict(scale=ctx.scale, causal=ctx.causal, segments=ctx.segments)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = mha_bwd_dq(*args, **kw)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = mha_bwd_dkv(*args, **kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None, segments=None):
    """Blockwise (flash) attention through :class:`FlashAttention`.

    q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv) with H % K == 0 —
    the GQA repeat is never materialized, and dK, dV come back in kv's own
    (B, T, K, *) layout. ``kv_len`` bounds the key positions for decode
    over a partially filled cache and needs ``causal=False`` (the kernels
    implement no causal-over-fill mask). ``segments``, a (q_seg (B, S),
    kv_seg (B, T)) int32 pair, forbids attention across packed-document
    boundaries (ids must match; pad id 0 is its own island) and excludes
    ``kv_len``. Returns (B, S, H, hdv) in q's dtype.

    Where a caller has put another forward in this module's ``mha_fwd``
    (the tests and ``chip_smoke.py`` swap in ``mha_fwd_ref`` this way),
    that forward is differentiated by plain autograd instead: an
    independent reference for the kernels' gradients.
    """
    _fault_gate("flash_attention")
    if mha_fwd is not _attn.mha_fwd:
        return mha_fwd(q, k, v, kv_len, scale=scale, causal=causal,
                       segments=segments)[0]
    q_seg, kv_seg = (None, None) if segments is None else segments
    return FlashAttention.apply(q, k, v, kv_len, q_seg, kv_seg, scale,
                                causal)


# --------------------------------------------------------- cross-entropy

def xent_supported(h_shape, w_shape, transposed: bool = False) -> bool:
    """True when (h, w) shapes are covered by the xent kernels.

    ``transposed``: w is a tied embedding stored (V, D).
    """
    if len(h_shape) not in (2, 3) or len(w_shape) != 2:
        return False
    if h_shape[-1] != w_shape[1 if transposed else 0]:
        return False
    return all(d >= 1 for d in tuple(h_shape) + tuple(w_shape))


class XentLoss(torch.autograd.Function):
    """Per-token cross-entropy of the LM head, kernels both ways.

    forward(h (..., D), w (D, V), labels int32 h.shape[:-1], vocab_size,
    transposed): ``xent_fwd`` gives (lse, ll), and the losses are lse - ll
    where the label is >= 0, else 0. It saves (h, w, labels, lse).
    backward: with gl = g * (labels >= 0) in f32, dH from ``xent_bwd_dh``
    in h's dtype and dW from ``xent_bwd_dw`` in w's dtype and layout, each
    only when asked for; the labels get no gradient. ``transposed``: w is
    the tied head as stored, (V, D), read in place by the kernels both
    ways, and dW comes back (V, D). h is flattened to (N, D) as the JAX
    package's ``_fwd_parts`` does.
    """

    @staticmethod
    def forward(ctx, h, w, labels, vocab_size: int, transposed: bool):
        lab = labels.reshape(-1)
        lse, ll = xent_fwd(h.reshape(-1, h.shape[-1]), w, lab,
                           vocab_size=vocab_size, transposed=transposed)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.vocab_size, ctx.transposed = vocab_size, transposed
        return torch.where(lab >= 0, lse - ll, 0.0).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        lab = labels.reshape(-1)
        gl = g.reshape(-1).float() * (lab >= 0)
        args = (h.reshape(-1, h.shape[-1]), w, lab, lse, gl)
        kw = {"vocab_size": ctx.vocab_size, "transposed": ctx.transposed}
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = xent_bwd_dh(*args, out_dtype=h.dtype, **kw).reshape(h.shape)
        if ctx.needs_input_grad[1]:
            dw = xent_bwd_dw(*args, out_dtype=w.dtype, **kw)
        return dh, dw, None, None, None


def xent_loss(h, w, labels, *, vocab_size: int, weights=None,
              transposed: bool = False):
    """Per-token LM-head cross-entropy (see :class:`XentLoss`).

    h (..., D), w (D, V), or with ``transposed`` the tied head's (V, D)
    storage, labels h.shape[:-1] (-1 = masked). Returns f32 losses of
    labels.shape; masked tokens are 0 in the value and in the (h, w)
    gradients, and w's gradient comes back in w's own layout. ``weights``
    (labels.shape, f32) scales each token's loss and gradient outside the
    Function, as in JAX: zero-weight tokens are demoted to label -1 before
    the kernels. Columns at or past ``vocab_size`` never enter the
    log-sum-exp. Shapes ``xent_supported`` does not cover raise.
    """
    _fault_gate("xent_loss")
    if not xent_supported(h.shape, w.shape, transposed):
        raise ValueError(f"xent_loss: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)}; need h (B, S, D) or (N, D) and "
                         f"w {'(V, D)' if transposed else '(D, V)'}")
    if weights is not None:
        labels = torch.where(weights > 0, labels, -1)
    losses = XentLoss.apply(h, w, labels.to(torch.int32), vocab_size,
                            transposed)
    if weights is not None:
        losses = losses * weights.to(losses.dtype)
    return losses


# -------------------------------------------------------------- optimizer

def resolve_kind(kind: str, shape) -> str:
    """Resolve ``larger`` to col/row by shape (ties go to col); see
    ``core.normalization.resolve_larger``, the one source of the rule."""
    from repro_torch.core.normalization import resolve_larger
    return resolve_larger(kind, shape)


def supported(shape, kind: str) -> bool:
    """True when (shape, kind) is covered by the optimizer kernels."""
    if len(shape) not in FUSED_NDIMS or kind not in FUSED_KINDS:
        return False
    return all(d >= 1 for d in shape)


def _ref_norm(g, kind: str, eps: float, out_dtype=None):
    """Plain normalization for any kind (col/row honour eps; the others
    delegate to ``core.normalization``, whose kinds have no eps knob)."""
    kind = resolve_kind(kind, g.shape)
    if kind in ("col", "row"):
        return _cref.normalize(g, kind, eps, out_dtype)
    from repro_torch.core.normalization import normalize as _core_normalize
    out = _core_normalize(g, kind)
    return out if out_dtype is None else out.to(out_dtype)


def _scaled_ref(g, gscale):
    # the JAX oracle multiplies by gscale as an f32 array, so a bf16 g
    # promotes to f32 there
    if gscale is None:
        return g
    return (g.to(torch.promote_types(g.dtype, torch.float32))
            * _cref.f32_scalar(gscale))


def normalize(g, kind: str = "col", eps: float = 1e-8, *, gscale=None,
              out_dtype=None):
    """gscale * g / (||slice|| + eps): two kernels (``norm_sumsq``,
    ``norm_apply``) on covered leaves.

    Math is f32; the result has ``out_dtype`` (default: g's, or f32 where
    gscale promotes g on the plain path, as in JAX).
    ``normalize(g, out_dtype=torch.float32)`` is the JAX package's
    ``normalize(g.astype(f32))`` without the f32 copy of g.
    """
    _fault_gate("normalize")
    if not supported(g.shape, kind):
        return _ref_norm(_scaled_ref(g, gscale), kind, eps, out_dtype)
    axis = resolve_kind(kind, g.shape)
    g3 = canon3(g)
    ss = norm_sumsq(g3, axis, gscale=gscale)
    return norm_apply(g3, ss, axis, eps=eps, gscale=gscale,
                      out_dtype=out_dtype).reshape(g.shape)


def norm_update(theta, g, lr, kind: str = "col", eps: float = 1e-8, *,
                gscale=None):
    """theta - lr * normalize(gscale * g), written into theta (returned).

    Covered leaves take two kernels: ``norm_sumsq`` then the in-place
    ``update_apply`` (4 passes over a matrix: g; theta, g, theta').
    """
    _fault_gate("norm_update")
    if not supported(theta.shape, kind):
        d = _ref_norm(_scaled_ref(g, gscale), kind, eps)
        return theta.copy_(theta.float() - _cref.f32_scalar(lr) * d.float())
    axis = resolve_kind(kind, theta.shape)
    g3 = canon3(g)
    ss = norm_sumsq(g3, axis, gscale=gscale)
    update_apply(canon3(theta), g3, ss, lr, axis, eps=eps, gscale=gscale)
    return theta


def _momentum_ref(m, g, beta, gscale):
    b = _cref.f32_scalar(beta)
    m_new = b * m.float() + one_minus(b) * _scaled_ref(g, gscale).float()
    m.copy_(m_new)  # cast-on-write: storage in m's dtype
    return m_new


def momentum_norm(m, g, beta, kind: str = "col", eps: float = 1e-8, *,
                  gscale=None):
    """(m', d): m' = beta*m + (1-beta)*gscale*g written into m (returned),
    d = normalize(m') in f32.

    On covered leaves ``momentum_sumsq`` forms m' and its f32 sums of
    squares in one kernel and ``norm_apply`` reads the *stored* m' (bf16
    under bf16 momentum storage); the plain path normalizes the pre-cast
    f32 m', as in JAX.
    """
    _fault_gate("momentum_norm")
    if not supported(m.shape, kind):
        m_new = _momentum_ref(m, g, beta, gscale)
        return m, _ref_norm(m_new, kind, eps)
    axis = resolve_kind(kind, m.shape)
    m3, ss = momentum_sumsq(canon3(m), canon3(g), beta, axis, gscale=gscale)
    d = norm_apply(m3, ss, axis, eps=eps, out_dtype=torch.float32)
    return m, d.reshape(m.shape)


def momentum_norm_update(theta, m, g, beta, lr, kind: str = "col",
                         eps: float = 1e-8, *, gscale=None):
    """(theta', m'), both written in place: ``momentum_sumsq`` then the
    head's ``update_apply`` on covered leaves (two kernel calls)."""
    _fault_gate("momentum_norm_update")
    if not supported(theta.shape, kind):
        m_new = _momentum_ref(m, g, beta, gscale)
        d = _ref_norm(m_new, kind, eps)
        theta.copy_(theta.float() - _cref.f32_scalar(lr) * d.float())
        return theta, m
    axis = resolve_kind(kind, theta.shape)
    m3, ss = momentum_sumsq(canon3(m), canon3(g), beta, axis, gscale=gscale)
    head_update_apply(canon3(theta), m3, ss, lr, axis, eps=eps)
    return theta, m
