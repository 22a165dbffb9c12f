"""Kernel entry points for the model code and the optimizer.

Routing is by the tensors' device alone: a wrapper runs the plain version
on the CPU and the CUDA kernel on the card. Unlike
``repro.kernels.dispatch`` there is no ``REPRO_FUSED`` switch and no
guarded fallback: a kernel that fails on the card raises instead of
quietly becoming the reference, and so does an entry point that
``REPRO_FAULTS=dispatch_fail@<op>`` names (``FaultError``, before any
launch; the op names are the entry points' own).

Sharded dispatch (``torch.distributed`` meshes). Tensors on a mesh are
DTensors laid out per ``models.sharding.Rules``; each entry point takes
its operands' ``NamedSharding`` (``sharding``, ``h_sharding`` /
``w_sharding``, ``q_sharding`` / ``kv_sharding``; by default read off the
DTensors themselves) and plans as the JAX package's ``shard_map``s do:
the operands are redistributed to the plan's layout, each rank runs the
kernels on its local shard, and the reductions that cross shards are
``all_reduce``d over exactly the mesh axes that shard the reduced dim —
the optimizer's f32 sums of squares over the axes sharding a col norm's
rows or a row norm's columns (``ShardPlan``); the loss's (lse, ll) over
the vocabulary axes (max, then the sum of the exps), its f32 dH over the
vocabulary axes and f32 dW over the token axes, each cast after the sum
(``XentPlan``; every vocabulary shard passes its ``col_offset``, the
global id of its first column, into the kernels, and w's embed dim is
gathered at entry); attention needs none (``AttnPlan``: batch and heads
are local); serving's decode over a sequence-sharded KV cache combines
each rank's partial (out, lse) over the T axes (``SeqSplitPlan``,
forward only; ``decode_attention``). A layout the plans cannot express exactly (``"ref"``, as
in JAX: a dim its axes do not divide, hidden states sharded past the
batch dim, tokens and vocabulary on one mesh axis, q and kv sharded
apart) takes the plain versions on the DTensors, whose ops DTensor
partitions as GSPMD partitions the jnp code, on the CPU; on the card it
raises and names the layout. A replicated layout runs the single-device
path on each rank.

Optimizer coverage (``supported``), as in the JAX package: 2-D and stacked
3-D leaves, norm kinds col/row/larger (``larger`` resolved per shape by
``resolve_kind``), float32/bfloat16 on the card, arbitrary shapes. Other
leaves take the plain path of the same maths (the jnp oracle of
``repro.kernels.dispatch``); that is coverage, not a fallback.

The write-mode entry points (``norm_update``, ``momentum_norm_update``)
update theta and the momentum in place on every route and return them;
``momentum_norm`` updates the momentum in place.

Attention (``flash_attention``) is the autograd ``FlashAttention`` over
``mha_fwd``, ``mha_bwd_dq`` and ``mha_bwd_dkv``; ``decode_attention`` is
``mha_fwd`` alone (no gradient), on a mesh per the cache's own layout.

Cross-entropy (``xent_loss``) is the LM head's loss as a
``torch.autograd.Function`` over the three xent kernels, with the contract
of the JAX package's ``custom_vjp``; h of 2 or 3 dims against a 2-D head
is covered (``xent_supported``), and other shapes raise.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.models.sharding import (NamedSharding, P, full_value,
                                         is_dtensor, lay_out, mesh_axes,
                                         placements, replicated_plain,
                                         spec_mesh_axes, spec_of, wrap)
from repro_torch.models.sharding import all_reduce as _all_reduce
from repro_torch.models.sharding import shard_index as _shard_index

from .attention import attention as _attn
from .attention.attention import mha_bwd_dkv, mha_bwd_dq, mha_fwd
from .colnorm import ref as _cref
from .colnorm.colnorm import canon3, norm_apply, norm_sumsq, update_apply
from .scale_head.ref import one_minus
from .scale_head.scale_head import head_update_apply, momentum_sumsq
from .xent.xent import xent_bwd_dh, xent_bwd_dw, xent_fwd

FUSED_KINDS = ("col", "row", "larger")
FUSED_NDIMS = (2, 3)


# ---------------------------------------------------------- sharded layouts

def _sharding_of(x, sharding):
    """The given sharding, else the DTensor's own (None for a plain
    tensor)."""
    return sharding if sharding is not None else spec_of(x)


def _axes_prod(mesh, axes):
    sizes = mesh_axes(mesh)
    if any(a not in sizes for a in axes):
        return None
    return math.prod(sizes[a] for a in axes)


def _mesh_of(*shardings):
    """The one mesh of ``shardings`` (None entries skipped) -> (mesh, ok):
    ok is False for a sharding that is not a NamedSharding, or two
    meshes."""
    mesh = None
    for sh in shardings:
        if sh is None:
            continue
        if not isinstance(sh, NamedSharding):
            return None, False
        if mesh is not None and sh.mesh != mesh:
            return None, False
        mesh = sh.mesh
    return mesh, True


def _ref_on_card(op: str, layout, *xs) -> None:
    """A layout the plans send to ``"ref"`` runs the plain version on the
    CPU only; on the card it raises, naming the layout."""
    if any(torch.is_tensor(x) and x.device.type == "cuda" for x in xs):
        raise NotImplementedError(
            f"{op}: the sharded layout {layout} has no kernel plan (the JAX "
            "package's 'ref' route); the port runs no plain version on the "
            "card")


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


class AttnPlan(NamedTuple):
    """The sharded attention's recipe: ``batch_axes`` shard the leading
    (batch) dim of q and kv, ``head_axes`` q's H and kv's K (both divide,
    so each shard keeps the GQA group ratio). No reduction crosses
    shards."""
    mesh: object
    batch_axes: tuple
    head_axes: tuple


def _plan_attn(q_sharding, kv_sharding, q_shape, kv_shape):
    """-> None (single-device) | "ref" | AttnPlan, as JAX's ``_plan_attn``:
    "ref" for sequence- or head_dim-sharded operands, q and kv sharded
    apart, or dims their axes do not divide."""
    if q_sharding is None and kv_sharding is None:
        return None
    mesh, ok = _mesh_of(q_sharding, kv_sharding)
    if not ok:
        return "ref"
    qper = spec_mesh_axes(q_sharding.spec, 4) if q_sharding is not None \
        else ((),) * 4
    kper = spec_mesh_axes(kv_sharding.spec, 4) if kv_sharding is not None \
        else ((),) * 4
    if any(qper[1]) or any(qper[3]) or any(kper[1]) or any(kper[3]):
        return "ref"
    if qper[0] != kper[0] or qper[2] != kper[2]:
        return "ref"
    batch_axes, head_axes = tuple(qper[0]), tuple(qper[2])
    if not batch_axes and not head_axes:
        return None
    kb = _axes_prod(mesh, batch_axes)
    kh = _axes_prod(mesh, head_axes)
    if kb is None or kh is None:
        return "ref"
    if q_shape[0] % kb or q_shape[2] % kh or kv_shape[2] % kh:
        return "ref"
    return AttnPlan(mesh, batch_axes, head_axes)


def attn_route(q_shape, kv_shape, q_sharding=None, kv_sharding=None):
    """-> ("ref", None) | ("kernel", None | AttnPlan): JAX's ``attn_route``
    for the shardings (every (q, kv) shape ``flash_attention`` takes is
    covered; the others raise in the kernels' checks)."""
    plan = _plan_attn(q_sharding, kv_sharding, q_shape, kv_shape)
    return ("ref", None) if plan == "ref" else ("kernel", plan)


def _attention(q, k, v, kv_len, segments, scale, causal):
    if mha_fwd is not _attn.mha_fwd:
        return mha_fwd(q, k, v, kv_len, scale=scale, causal=causal,
                       segments=segments)[0]
    q_seg, kv_seg = (None, None) if segments is None else segments
    return FlashAttention.apply(q, k, v, kv_len, q_seg, kv_seg, scale,
                                causal)


def flash_attention(q, k, v, *, scale: float, causal: bool = True,
                    kv_len=None, segments=None, q_sharding=None,
                    kv_sharding=None):
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

    On a mesh (``q_sharding``, ``kv_sharding``, or DTensor operands) the
    operands are laid out per ``attn_route``'s plan and every rank runs
    the kernels on its (B/n, S, H/m, hd) x (B/n, T, K/m, hd) shard; the
    segment ids follow the batch axes. Returns a DTensor laid out as q.
    """
    _fault_gate("flash_attention")
    q_sh = _sharding_of(q, q_sharding)
    kv_sh = _sharding_of(k, kv_sharding)
    if q_sh is None and kv_sh is None:
        return _attention(q, k, v, kv_len, segments, scale, causal)
    route, plan = attn_route(q.shape, k.shape, q_sh, kv_sh)
    if route == "ref":
        _ref_on_card("flash_attention", (q_sh, kv_sh), q, k, v)
        from .attention.ref import mha_fwd_ref
        with replicated_plain():
            return mha_fwd_ref(q, k, v, kv_len, scale=scale, causal=causal,
                               segments=segments)[0]
    mesh = (q_sh or kv_sh).mesh
    bt = (plan.batch_axes or None) if plan else None
    hx = (plan.head_axes or None) if plan else None
    spec = P(bt, None, hx, None)
    sh = NamedSharding(mesh, spec)
    ql, kl, vl = (lay_out(x, sh).to_local() for x in (q, k, v))
    if segments is not None:
        segments = tuple(lay_out(x, NamedSharding(mesh, P(bt, None)))
                         .to_local() for x in segments)
    kv_len = full_value(kv_len)
    out = _attention(ql, kl, vl, kv_len, segments, scale, causal)
    return wrap(out, sh, tuple(q.shape[:3]) + (v.shape[3],))


# ------------------------------------------------ sequence-split decode

class SeqSplitPlan(NamedTuple):
    """The sharded decode's recipe over a sequence-sharded KV cache (JAX's
    ``cache_seq`` -> "model"): ``batch_axes`` shard the leading dim of q
    and the cache, ``seq_axes`` the cache's T; every rank keeps every
    head. Each rank attends over its own T/n keys, and the partial (out,
    lse) pairs are combined over ``seq_axes`` (``lse_combine``)."""
    mesh: object
    batch_axes: tuple
    seq_axes: tuple


def _plan_decode(kv_sharding, kv_shape):
    """The cache's layout -> AttnPlan (its T whole: its batch axes only) |
    SeqSplitPlan. A layout the plan cannot express raises
    ``NotImplementedError`` naming it: no mesh, the cache's kv heads or
    head dim sharded (every rank needs every head of its rows), or dims
    their axes do not divide. q is re-laid out to the cache's rows."""
    if kv_sharding is None:
        raise NotImplementedError(
            "decode_attention: the cache is not on a mesh; off a mesh "
            "decode takes flash_attention")
    mesh = kv_sharding.mesh
    kper = spec_mesh_axes(kv_sharding.spec, 4)
    batch_axes, seq_axes = tuple(kper[0]), tuple(kper[1])
    if any(kper[2]) or any(kper[3]):
        raise NotImplementedError(
            f"decode_attention: the cache layout {kv_sharding.spec} shards "
            "its kv heads or head dim; the sequence-split plan takes the "
            "cache's batch and T sharded, each rank with every head")
    kb, ks = _axes_prod(mesh, batch_axes), _axes_prod(mesh, seq_axes)
    if kb is None or ks is None or kv_shape[0] % kb or kv_shape[1] % ks:
        raise NotImplementedError(
            f"decode_attention: the layout {kv_sharding.spec} does not "
            f"divide the cache {tuple(kv_shape)}")
    if seq_axes:
        return SeqSplitPlan(mesh, batch_axes, seq_axes)
    return AttnPlan(mesh, batch_axes, ())


def lse_combine(outs, lses):
    """The attention over all keys from its partials over disjoint key
    sets: ``outs`` (R, B, S, H, hdv) (any float dtype) and their ``lses``
    (R, B, H, S) f32 -> (B, S, H, hdv) f32. In f32: M = max of the lse;
    out = sum_r exp(lse_r - M) out_r / sum_r exp(lse_r - M), as
    ``XentLoss.forward`` combines its vocabulary shards. A partial with no
    valid key (out 0, lse about -1e30) weighs 0; one partial returns its
    out exactly (exp(0) = 1)."""
    w = torch.exp(lses - lses.amax(0)).transpose(-1, -2)[..., None]
    return (w * outs.float()).sum(0) / w.sum(0)


def seq_split_decode(q, k, v, kv_len, *, scale: float, mesh, seq_axes):
    """One rank's part of the sequence-split decode, on local tensors: q
    (B, S, H, hd) with every head, this rank's cache shard k (B, T_l, K,
    hd) and v (B, T_l, K, hdv), the global fill ``kv_len`` (a 0-d int32
    tensor or an int; None: every key). ``mha_fwd`` runs on the shard with
    the local fill clamp(kv_len - r * T_l, 0, T_l), computed on the device;
    the partials are summed into this rank's slot of an (R, ...) f32
    buffer of both over ``seq_axes`` (the plan's one collective: every
    rank then holds every partial, exactly) and combined by
    ``lse_combine``. -> (B, S, H, hdv) in q's dtype, the same on every
    rank of ``seq_axes``. The profiler sees it as the span
    ``seq_split_decode``."""
    n, r = _axes_prod(mesh, seq_axes), _shard_index(mesh, seq_axes)
    T_l = k.shape[1]
    with record_function("seq_split_decode"):
        if kv_len is not None:
            kv_len = (torch.as_tensor(kv_len, dtype=torch.int32,
                                      device=q.device)
                      - r * T_l).clamp(0, T_l).to(torch.int32)
        out, lse = mha_fwd(q, k, v, kv_len, scale=scale, causal=False)
        parts = out.new_zeros((n, out.numel() + lse.numel()),
                              dtype=torch.float32)
        parts[r, :out.numel()] = out.reshape(-1)
        parts[r, out.numel():] = lse.reshape(-1)
        _all_reduce(parts, mesh, seq_axes)
        return lse_combine(parts[:, :out.numel()].reshape(n, *out.shape),
                           parts[:, out.numel():].reshape(n, *lse.shape)
                           ).to(q.dtype)


def decode_attention(q, k, v, *, scale: float, kv_len=None):
    """Forward-only non-causal attention of S <= 4 queries over a KV cache
    on a mesh (serving's decode), keys bounded by ``kv_len``.

    q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv), the cache
    DTensors. The plan follows the cache's own layout: a cache whose T is
    sharded (JAX's ("cache_batch", "cache_seq", None, "cache_kv")) takes
    ``SeqSplitPlan`` — q re-laid out with its batch over the cache's batch
    axes and every head on every rank, each rank's shard on
    ``seq_split_decode`` — and a cache whose T the divisibility guard
    left whole takes ``flash_attention``'s batch-only ``AttnPlan``. JAX
    sends the sequence-sharded cache to its chunked jnp route under GSPMD
    (a local softmax per T-shard plus small lse all-reduces); this is that
    arithmetic on the kernel. Returns a DTensor laid out as q's rows.
    Raises ``RuntimeError`` if an operand requires grad (no backward), and
    ``NotImplementedError`` for a layout the plan cannot express.
    """
    _fault_gate("decode_attention")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("decode_attention: forward only (serving's "
                           "decode); an operand requires grad")
    plan = _plan_decode(spec_of(k), k.shape)
    bt = plan.batch_axes or None
    row = NamedSharding(plan.mesh, P(bt, None, None, None))
    if isinstance(plan, AttnPlan):
        return flash_attention(q, k, v, scale=scale, causal=False,
                               kv_len=kv_len, q_sharding=row,
                               kv_sharding=row)
    kv_l = NamedSharding(plan.mesh, P(bt, plan.seq_axes, None, None))
    ql = lay_out(q, row).to_local()
    kl, vl = (lay_out(x, kv_l).to_local() for x in (k, v))
    out = seq_split_decode(ql, kl, vl, full_value(kv_len), scale=scale,
                           mesh=plan.mesh, seq_axes=plan.seq_axes)
    return wrap(out, row, tuple(q.shape[:3]) + (v.shape[3],))


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


class XentPlan(NamedTuple):
    """The sharded loss's recipe: ``tok_axes`` shard the leading (batch)
    dim of h and the labels, ``voc_axes`` w's vocabulary dim (dim 1; dim
    0 of the tied (V, D) head). w's embed dim is gathered at entry."""
    mesh: object
    tok_axes: tuple
    voc_axes: tuple


class XentLoss(torch.autograd.Function):
    """Per-token cross-entropy of the LM head, kernels both ways.

    forward(h (..., D), w (D, V), labels int32 h.shape[:-1], vocab_size,
    transposed, plan, col_offset): ``xent_fwd`` gives (lse, ll), and the
    losses are lse - ll where the label is >= 0, else 0. It saves (h, w,
    labels, lse). backward: with gl = g * (labels >= 0) in f32, dH from
    ``xent_bwd_dh`` in h's dtype and dW from ``xent_bwd_dw`` in w's dtype
    and layout, each only when asked for; the labels get no gradient.
    ``transposed``: w is the tied head as stored, (V, D), read in place by
    the kernels both ways, and dW comes back (V, D). h is flattened to
    (N, D) as the JAX package's ``_fwd_parts`` does.

    Under an :class:`XentPlan` the operands are one rank's shards (w's
    first column the global id ``col_offset``): the forward combines the
    shards' (lse, ll) over the vocabulary axes (``all_reduce`` MAX of
    lse, then lse = max + log of the summed exp(lse - max); ll summed),
    and the backward writes dH and dW in f32 where they are summed — dH
    over the vocabulary axes, dW over the token axes — and casts each to
    its dtype after the sum.
    """

    @staticmethod
    def forward(ctx, h, w, labels, vocab_size: int, transposed: bool,
                plan=None, col_offset: int = 0):
        lab = labels.reshape(-1)
        lse, ll = xent_fwd(h.reshape(-1, h.shape[-1]), w, lab,
                           vocab_size=vocab_size, col_offset=col_offset,
                           transposed=transposed)
        if plan is not None and plan.voc_axes:
            m = _all_reduce(lse.clone(), plan.mesh, plan.voc_axes,
                            dist.ReduceOp.MAX)
            lse = m + torch.log(_all_reduce(torch.exp(lse - m), plan.mesh,
                                            plan.voc_axes))
            ll = _all_reduce(ll, plan.mesh, plan.voc_axes)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.vocab_size, ctx.transposed = vocab_size, transposed
        ctx.plan, ctx.col_offset = plan, col_offset
        return torch.where(lab >= 0, lse - ll, 0.0).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        plan = ctx.plan
        voc = plan.voc_axes if plan is not None else ()
        tok = plan.tok_axes if plan is not None else ()
        lab = labels.reshape(-1)
        gl = g.reshape(-1).float() * (lab >= 0)
        args = (h.reshape(-1, h.shape[-1]), w, lab, lse, gl)
        kw = {"vocab_size": ctx.vocab_size, "transposed": ctx.transposed,
              "col_offset": ctx.col_offset}
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = xent_bwd_dh(*args, out_dtype=torch.float32 if voc
                             else h.dtype, **kw)
            if voc:
                dh = _all_reduce(dh, plan.mesh, voc).to(h.dtype)
            dh = dh.reshape(h.shape)
        if ctx.needs_input_grad[1]:
            dw = xent_bwd_dw(*args, out_dtype=torch.float32 if tok
                             else w.dtype, **kw)
            if tok:
                dw = _all_reduce(dw, plan.mesh, tok).to(w.dtype)
        return dh, dw, None, None, None, None, None


def _plan_xent(h_sharding, w_sharding, h_shape, w_shape,
               transposed: bool = False):
    """-> None (single-device) | "ref" | XentPlan, as JAX's
    ``_plan_xent``: "ref" for hidden states sharded past their batch dim,
    one mesh axis sharding both tokens and vocabulary (each rank would
    combine statistics across token shards), or dims their axes do not
    divide."""
    if h_sharding is None and w_sharding is None:
        return None
    mesh, ok = _mesh_of(h_sharding, w_sharding)
    if not ok:
        return "ref"
    voc_dim = 0 if transposed else 1
    tok_axes = voc_axes = ()
    if h_sharding is not None:
        per = spec_mesh_axes(h_sharding.spec, len(h_shape))
        if any(per[1:]):
            return "ref"
        tok_axes = per[0]
    if w_sharding is not None:
        voc_axes = spec_mesh_axes(w_sharding.spec, 2)[voc_dim]
    if not tok_axes and not voc_axes:
        return None
    if set(tok_axes) & set(voc_axes):
        return "ref"
    kt = _axes_prod(mesh, tok_axes)
    kv = _axes_prod(mesh, voc_axes)
    if kt is None or kv is None or h_shape[0] % kt or w_shape[voc_dim] % kv:
        return "ref"
    return XentPlan(mesh, tuple(tok_axes), tuple(voc_axes))


def xent_route(h_shape, w_shape, h_sharding=None, w_sharding=None,
               transposed: bool = False):
    """-> ("ref", None) | ("kernel", None | XentPlan): JAX's
    ``xent_route`` (shapes ``xent_supported`` does not cover are "ref"
    there and raise in ``xent_loss`` here)."""
    if not xent_supported(h_shape, w_shape, transposed):
        return "ref", None
    plan = _plan_xent(h_sharding, w_sharding, h_shape, w_shape, transposed)
    return ("ref", None) if plan == "ref" else ("kernel", plan)


def _xent_sharded(h, w, labels, vocab_size, transposed, plan, mesh):
    """The loss on each rank's shards per ``plan`` (None: the replicated
    layout) -> a DTensor of the losses laid out as the token shards."""
    tok = (plan.tok_axes or None) if plan else None
    voc = (plan.voc_axes or None) if plan else None
    rest = (None,) * (h.ndim - 1)
    hl = lay_out(h, NamedSharding(mesh, P(tok, *rest))).to_local()
    wl = lay_out(w, NamedSharding(mesh, P(voc, None) if transposed
                                  else P(None, voc))).to_local()
    lsh = NamedSharding(mesh, P(tok, *rest[1:]))
    ll = lay_out(labels, lsh).to_local()
    off = 0
    if voc:
        off = _shard_index(mesh, plan.voc_axes) * wl.shape[0 if transposed
                                                            else 1]
    losses = XentLoss.apply(hl, wl, ll, vocab_size, transposed, plan, off)
    return wrap(losses, lsh, labels.shape)


def xent_loss(h, w, labels, *, vocab_size: int, weights=None,
              transposed: bool = False, h_sharding=None, w_sharding=None):
    """Per-token LM-head cross-entropy (see :class:`XentLoss`).

    h (..., D), w (D, V), or with ``transposed`` the tied head's (V, D)
    storage, labels h.shape[:-1] (-1 = masked). Returns f32 losses of
    labels.shape; masked tokens are 0 in the value and in the (h, w)
    gradients, and w's gradient comes back in w's own layout. ``weights``
    (labels.shape, f32) scales each token's loss and gradient outside the
    Function, as in JAX: zero-weight tokens are demoted to label -1 before
    the kernels. Columns at or past ``vocab_size`` never enter the
    log-sum-exp. Shapes ``xent_supported`` does not cover raise.

    On a mesh (``h_sharding``, ``w_sharding``, or DTensor operands) the
    loss follows ``xent_route``'s plan: tokens over the axes sharding h's
    batch dim, the vocabulary over those sharding w's vocabulary dim, each
    shard with its ``col_offset`` (see :class:`XentLoss`); the losses come
    back as a DTensor laid out as the token shards.
    """
    _fault_gate("xent_loss")
    if not xent_supported(h.shape, w.shape, transposed):
        raise ValueError(f"xent_loss: h {tuple(h.shape)} and w "
                         f"{tuple(w.shape)}; need h (B, S, D) or (N, D) and "
                         f"w {'(V, D)' if transposed else '(D, V)'}")
    if weights is not None:
        labels = torch.where(weights > 0, labels, -1)
    labels = labels.to(torch.int32)
    h_sh, w_sh = _sharding_of(h, h_sharding), _sharding_of(w, w_sharding)
    if h_sh is None and w_sh is None:
        losses = XentLoss.apply(h, w, labels, vocab_size, transposed)
    else:
        route, plan = xent_route(h.shape, w.shape, h_sh, w_sh, transposed)
        if route == "ref":
            _ref_on_card("xent_loss", (h_sh, w_sh), h, w)
            losses = _xent_ref(h, w, labels, vocab_size, transposed)
        else:
            losses = _xent_sharded(h, w, labels, vocab_size, transposed,
                                   plan, (h_sh or w_sh).mesh)
    if weights is not None:
        losses = losses * weights.to(losses.dtype)
    return losses


def _xent_ref(h, w, labels, vocab_size: int, transposed: bool):
    """The full-logit plain loss, differentiable, on the layouts DTensor
    partitions (JAX's ``_xent_ref``)."""
    from .xent.ref import losses
    with replicated_plain():
        return losses(h, w.T if transposed else w, labels, vocab_size)


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


class ShardPlan(NamedTuple):
    """The sharded optimizer's recipe for one canonical (L, m, n) leaf:
    ``spec3[d]`` is the tuple of mesh axes sharding canon3 dim ``d``."""
    mesh: object
    spec3: tuple


def _plan_sharding(sharding, shape):
    """-> None (single-device) | "ref" | ShardPlan, as JAX's
    ``_plan_sharding``: "ref" for a sharding that is not a NamedSharding
    or names axes the mesh lacks, and for dims their axes do not
    divide."""
    if sharding is None:
        return None
    if not isinstance(sharding, NamedSharding):
        return "ref"
    per_dim = spec_mesh_axes(sharding.spec, len(shape))
    if len(shape) == 2:
        per_dim = ((),) + per_dim
    if all(not axs for axs in per_dim):
        return None
    shape3 = (1,) + tuple(shape) if len(shape) == 2 else tuple(shape)
    for dim, axs in zip(shape3, per_dim):
        k = _axes_prod(sharding.mesh, axs)
        if k is None or dim % k:
            return "ref"
    return ShardPlan(sharding.mesh, per_dim)


def _route(shape, kind, sharding):
    """-> ("ref", None) | ("kernel", None | ShardPlan)."""
    if not supported(shape, kind):
        return "ref", None
    plan = _plan_sharding(sharding, shape)
    return ("ref", None) if plan == "ref" else ("kernel", plan)


def _red_axes(plan: ShardPlan, axis: str) -> tuple:
    """The mesh axes the per-slice sums of squares are summed over: those
    sharding the rows for a col norm, the columns for a row norm."""
    return plan.spec3[1 if axis == "col" else 2]


def _psum_ss(ss, plan, axis):
    return _all_reduce(ss, plan.mesh, _red_axes(plan, axis)) if plan else ss


def _op_route(op: str, x, kind: str, sharding):
    """-> (route, plan, sharding): the entry point's plan for leaf ``x``;
    a sharded layout the plans cannot express raises on the card."""
    sh = _sharding_of(x, sharding)
    route, plan = _route(x.shape, kind, sh)
    if route == "ref" and sh is not None and supported(x.shape, kind):
        _ref_on_card(op, sh, x)
    return route, plan, sh


def _mapped(sh, *xs):
    """canon3 of each operand's local shard, laid out per ``sh`` (the
    operands themselves without a sharding): JAX's ``shard_map`` entry."""
    if sh is None:
        return tuple(canon3(x) for x in xs)
    return tuple(canon3(lay_out(x, sh).to_local()) for x in xs)


def _written(sh, x):
    """canon3 of the local storage of ``x``, which the kernels write in
    place: ``x`` must already be laid out per ``sh``."""
    if sh is None:
        return canon3(x)
    want = placements(sh.spec, sh.mesh, x.ndim)
    if not is_dtensor(x) or tuple(x.placements) != want:
        raise ValueError(f"the in-place operand must be a DTensor laid out "
                         f"as {sh.spec} on the mesh, got "
                         f"{getattr(x, 'placements', 'a plain tensor')}")
    return canon3(x.to_local())


def _unmapped(sh, y, shape):
    """A rank's local result as the leaf's global value."""
    if sh is None:
        return y.reshape(shape)
    return wrap(y.reshape(_local_shape(y, shape)), sh, shape)


def _local_shape(y, shape) -> tuple:
    # canon3 put a unit layer axis in front of a 2-D leaf
    return tuple(y.shape[1:]) if len(shape) == 2 else tuple(y.shape)


def _scalar(x):
    """A scalar operand (lr, beta, gscale) as the kernels take it: a
    DTensor's global value."""
    return full_value(x)


def normalize(g, kind: str = "col", eps: float = 1e-8, *, gscale=None,
              out_dtype=None, sharding=None):
    """gscale * g / (||slice|| + eps): two kernels (``norm_sumsq``,
    ``norm_apply``) on covered leaves.

    Math is f32; the result has ``out_dtype`` (default: g's, or f32 where
    gscale promotes g on the plain path, as in JAX).
    ``normalize(g, out_dtype=torch.float32)`` is the JAX package's
    ``normalize(g.astype(f32))`` without the f32 copy of g. ``sharding``
    (default: g's own, for a DTensor): the kernels run on the local shard
    and the f32 sums of squares are all-reduced over the axes sharding
    the reduced dim (``_red_axes``).
    """
    _fault_gate("normalize")
    route, plan, sh = _op_route("normalize", g, kind, sharding)
    if route == "ref":
        return _ref_norm(_scaled_ref(g, gscale), kind, eps, out_dtype)
    axis = resolve_kind(kind, g.shape)
    gscale = _scalar(gscale)
    (g3,) = _mapped(sh, g)
    ss = _psum_ss(norm_sumsq(g3, axis, gscale=gscale), plan, axis)
    return _unmapped(sh, norm_apply(g3, ss, axis, eps=eps, gscale=gscale,
                                    out_dtype=out_dtype), g.shape)


def norm_update(theta, g, lr, kind: str = "col", eps: float = 1e-8, *,
                gscale=None, sharding=None):
    """theta - lr * normalize(gscale * g), written into theta (returned).

    Covered leaves take two kernels: ``norm_sumsq`` then the in-place
    ``update_apply`` (4 passes over a matrix: g; theta, g, theta').
    ``sharding`` (default: theta's own): as ``normalize``; theta is a
    DTensor in that layout, written shard by shard, and g is laid out as
    it.
    """
    _fault_gate("norm_update")
    route, plan, sh = _op_route("norm_update", theta, kind, sharding)
    if route == "ref":
        d = _ref_norm(_scaled_ref(g, gscale), kind, eps)
        return theta.copy_(theta.float() - _cref.f32_scalar(lr) * d.float())
    axis = resolve_kind(kind, theta.shape)
    gscale, lr = _scalar(gscale), _scalar(lr)
    t3 = _written(sh, theta)
    (g3,) = _mapped(sh, g)
    ss = _psum_ss(norm_sumsq(g3, axis, gscale=gscale), plan, axis)
    update_apply(t3, g3, ss, lr, axis, eps=eps, gscale=gscale)
    return theta


def _momentum_ref(m, g, beta, gscale):
    b = _cref.f32_scalar(beta)
    m_new = b * m.float() + one_minus(b) * _scaled_ref(g, gscale).float()
    m.copy_(m_new)  # cast-on-write: storage in m's dtype
    return m_new


def momentum_norm(m, g, beta, kind: str = "col", eps: float = 1e-8, *,
                  gscale=None, sharding=None):
    """(m', d): m' = beta*m + (1-beta)*gscale*g written into m (returned),
    d = normalize(m') in f32.

    On covered leaves ``momentum_sumsq`` forms m' and its f32 sums of
    squares in one kernel and ``norm_apply`` reads the *stored* m' (bf16
    under bf16 momentum storage); the plain path normalizes the pre-cast
    f32 m', as in JAX. ``sharding`` (default: m's own): as
    ``norm_update``, m written shard by shard.
    """
    _fault_gate("momentum_norm")
    route, plan, sh = _op_route("momentum_norm", m, kind, sharding)
    if route == "ref":
        m_new = _momentum_ref(m, g, beta, gscale)
        return m, _ref_norm(m_new, kind, eps)
    axis = resolve_kind(kind, m.shape)
    m3 = _written(sh, m)
    (g3,) = _mapped(sh, g)
    m3, ss = momentum_sumsq(m3, g3, _scalar(beta), axis,
                            gscale=_scalar(gscale))
    ss = _psum_ss(ss, plan, axis)
    d = norm_apply(m3, ss, axis, eps=eps, out_dtype=torch.float32)
    return m, _unmapped(sh, d, m.shape)


def momentum_norm_update(theta, m, g, beta, lr, kind: str = "col",
                         eps: float = 1e-8, *, gscale=None, sharding=None):
    """(theta', m'), both written in place: ``momentum_sumsq`` then the
    head's ``update_apply`` on covered leaves (two kernel calls).
    ``sharding`` (default: theta's own): as ``norm_update``."""
    _fault_gate("momentum_norm_update")
    route, plan, sh = _op_route("momentum_norm_update", theta, kind,
                                sharding)
    if route == "ref":
        m_new = _momentum_ref(m, g, beta, gscale)
        d = _ref_norm(m_new, kind, eps)
        theta.copy_(theta.float() - _cref.f32_scalar(lr) * d.float())
        return theta, m
    axis = resolve_kind(kind, theta.shape)
    t3, m3 = _written(sh, theta), _written(sh, m)
    (g3,) = _mapped(sh, g)
    m3, ss = momentum_sumsq(m3, g3, _scalar(beta), axis,
                            gscale=_scalar(gscale))
    ss = _psum_ss(ss, plan, axis)
    head_update_apply(t3, m3, ss, _scalar(lr), axis, eps=eps)
    return theta, m
