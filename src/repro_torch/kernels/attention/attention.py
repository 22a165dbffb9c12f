"""Flash attention: the wrappers around the Hopper CUDA kernels.

``mha_fwd`` (forward: out and the per-row lse), ``mha_bwd_dq`` (dQ) and
``mha_bwd_dkv`` (dK, dV) take the model's (B, S, H, hd) layout and route
by the device of their tensors: CPU tensors go to the plain PyTorch
versions (``ref``), CUDA tensors to the hand-written kernels in
``csrc/mha_fwd.cu`` and ``csrc/mha_bwd.cu``, which replace the TPU kernels
of the same names in ``repro.kernels.attention.attention``. On the card
there is no fallback: a build or launch failure raises. Each wrapper's
``launches`` counts its kernel launches, so a run can show that it went
through the kernel.

The forward has three CUDA kernels, one per route, chosen by
``_fwd_route`` from dtype and shape alone: ``mma`` (tensor cores, bf16
with hd == hdv in {64, 128}: training, eval and prefill), ``decode``
(S <= 4) and ``fma`` (f32 FMAs: float32, and bf16 heads the tensor-core
kernel does not take). ``mha_fwd.route_launches`` counts launches by
route beside ``mha_fwd.launches``. The backward kernels have two routes
each, chosen by ``_bwd_route``: ``mma`` (tensor cores, bf16 with hd ==
hdv in {64, 128}: training) and ``fma`` (the rest); ``mha_bwd_dq`` and
``mha_bwd_dkv`` count theirs in ``route_launches`` too.

Packed batches pass ``segments``, a pair of (B, S) and (B, T) int32 ids
(query i sees key j only where they are equal; pad id 0 is its own
island), never with ``kv_len``. Every route takes them; the CUDA kernels
skip the tile pairs whose id ranges do not overlap. Each wrapper counts
its launches with segments in ``segment_launches`` as well.

A kernel's output carries no autograd history. The differentiable route
is ``dispatch.flash_attention``, an autograd Function whose backward runs
the two backward kernels; on the card a direct ``mha_fwd`` call that
would need a gradient raises rather than silently drop it. The CPU route
stays differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import mha_bwd_dkv_ref, mha_bwd_dq_ref, mha_fwd_ref

_DTYPES = (torch.bfloat16, torch.float32)
# the fma and decode kernels, forward and backward, stage their tiles as
# f32: 256 (gemma-2b's head) is the widest head whose tiles fit the H100's
# shared memory (csrc/mha_fwd.cu, csrc/mha_bwd.cu)
_MAX_HEAD_DIM = 256
# the tensor-core forward keeps a warp's (16, hdv) f32 output in registers;
# at 256 it would spill (csrc/mha_fwd.cu), so those heads take fma
_MMA_HEAD_DIMS = (64, 128)
# S at or below this takes the decode kernel (the C entry mha_fwd, which
# runs decode and fma, applies the same bound)
_DECODE_ROWS = 4


def _fwd_route(q, k, v) -> str:
    """The forward kernel a CUDA call takes: "decode" for S <= 4, "mma" for
    bf16 with hd == hdv in {64, 128}, "fma" otherwise (float32, and bf16
    with hd 256 or hd != hdv). By dtype and shape alone; every route
    computes the same function."""
    if q.shape[1] <= _DECODE_ROWS:
        return "decode"
    if (q.dtype == torch.bfloat16 and k.shape[3] == v.shape[3]
            and k.shape[3] in _MMA_HEAD_DIMS):
        return "mma"
    return "fma"


def _bwd_route(q, k, v) -> str:
    """The backward kernels a CUDA call takes: "mma" for bf16 with hd ==
    hdv in {64, 128}, "fma" otherwise (float32, and bf16 with hd != hdv or
    other widths). By dtype and shape alone; both routes compute the same
    function."""
    if (q.dtype == torch.bfloat16 and k.shape[3] == v.shape[3]
            and k.shape[3] in _MMA_HEAD_DIMS):
        return "mma"
    return "fma"


def _bind(lib: ctypes.CDLL, name: str = "mha_fwd"):
    """``mha_fwd`` (fma and decode kernels) or ``mha_fwd_mma`` of
    ``csrc/mha_fwd.cu``: one argument list."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i64, i64, i64, i64, i64, i64, i64, i64, i64,
                       ctypes.c_float, i, p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return fn


def _bind_bwd(lib: ctypes.CDLL, name: str):
    """``mha_bwd_dq`` or ``mha_bwd_dkv`` of ``csrc/mha_bwd.cu``, or their
    ``_mma`` twins with the same argument lists (dkv has one more output
    pointer)."""
    fn = getattr(lib, name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        outs = [p, p] if name.startswith("mha_bwd_dkv") else [p]
        fn.argtypes = [p, p, p, p, p, p, p, p, p, *outs, i, i, i, i, i, i, i, i,
                       ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i, p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return fn


def _check(q, k, v, kv_len, causal, name="mha_fwd", segments=None):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D (B, S|T, H|K, hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if min(B, S, H, T, K) < 1 or H % K:
        raise ValueError(f"{name}: need nonempty shapes and H % K == 0, got "
                         f"H={H} K={K}")
    for what, d in (("hd", hd), ("hdv", v.shape[3])):
        if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
            raise ValueError(f"{name}: {what}={d} must be a multiple of 8 "
                             f"in [8, {_MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "need one of bfloat16, float32 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices")
    if causal and kv_len is not None:
        raise ValueError(
            f"{name}: kv_len requires causal=False — the decode window is "
            "non-causal within the filled cache")
    if causal and T < S:
        raise ValueError(f"causal attention needs T >= S, got S={S} T={T}")
    if segments is not None:
        _check_segments(segments, kv_len, B, S, T, q.device, name)


def _check_segments(segments, kv_len, B, S, T, device, name):
    """The (q_seg, kv_seg) pair: (B, S) and (B, T) int32 on q's device, and
    never with ``kv_len`` (packed batches have no cache-fill bound)."""
    if kv_len is not None:
        raise ValueError(f"{name}: segments and kv_len are mutually "
                         "exclusive (packed batches have no cache-fill "
                         "bound)")
    if not (isinstance(segments, (tuple, list)) and len(segments) == 2
            and all(torch.is_tensor(x) for x in segments)):
        raise ValueError(f"{name}: segments must be a (q_seg, kv_seg) pair "
                         "of tensors")
    for what, x, shape in (("q_seg", segments[0], (B, S)),
                           ("kv_seg", segments[1], (B, T))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: {what} {tuple(x.shape)}; need {shape}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name}: {what} is {x.dtype}; need torch.int32")
        if x.device != device:
            raise ValueError(f"{name}: {what} on {x.device}, q on {device}")


def _seg_ptrs(segments, name):
    """The kernels' (q_seg, kv_seg) pointers: (None, None) without
    segments; the ids must be contiguous."""
    if segments is None:
        return None, None
    if not all(x.is_contiguous() for x in segments):
        raise ValueError(f"{name}: segment ids must be contiguous")
    return segments[0].data_ptr(), segments[1].data_ptr()


def _strides_ok(x: torch.Tensor) -> bool:
    # 16-byte row loads: last dim contiguous, rows 8-element aligned
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3]))


def mha_fwd(q, k, v, kv_len=None, *, scale: float, causal: bool = True,
            segments=None):
    """(out, lse): q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv).

    Masks: rectangular causal (query i sees keys <= T - S + i) or, with
    ``causal=False``, the optional ``kv_len`` fill bound (a 0-d int32
    tensor on q's device, or an int); and ``segments``, a (q_seg (B, S),
    kv_seg (B, T)) int32 pair, on top of either (not with ``kv_len``).
    A query with no valid key gives 0 and an lse of about -1e30. Returns
    out (B, S, H, hdv) in q's dtype and lse (B, H, S) f32.
    """
    _check(q, k, v, kv_len, causal, segments=segments)
    if q.device.type == "cpu":
        return mha_fwd_ref(q, k, v, kv_len, scale=scale, causal=causal,
                           segments=segments)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError(
            "mha_fwd: the kernel's output has no autograd history, so it "
            "would silently drop the gradient of q, k and v; differentiate "
            "through dispatch.flash_attention (whose backward runs "
            "mha_bwd_dq and mha_bwd_dkv), or call under torch.no_grad()")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _strides_ok(x):
            raise ValueError(f"mha_fwd: {name} needs a contiguous last dim, "
                             "8-element-aligned strides and a 16-byte-aligned "
                             "start")
    route = _fwd_route(q, k, v)
    out, lse = _launch_fwd(route, q, k, v, kv_len, scale, causal, segments)
    mha_fwd.launches += 1
    mha_fwd.route_launches[route] += 1
    mha_fwd.segment_launches += segments is not None
    return out, lse


mha_fwd.launches = 0
mha_fwd.route_launches = {"mma": 0, "fma": 0, "decode": 0}
mha_fwd.segment_launches = 0


def _launch_fwd(route, q, k, v, kv_len, scale, causal, segments=None):
    """(out, lse) from the kernel of ``route`` on checked CUDA operands.
    ``mha_fwd`` passes ``_fwd_route``'s choice; chip_smoke.py also times
    the fma kernel at shapes the mma route takes, beside it. Counts
    nothing."""
    q_seg, kv_seg = _seg_ptrs(segments, "mha_fwd")
    kv_len = _kv_len_tensor(kv_len, q.device, "mha_fwd")
    B, S, H, hd = q.shape
    T, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.library("mha_fwd")
    fn = _bind(lib, "mha_fwd_mma" if route == "mma" else "mha_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(), q_seg, kv_seg,
                 out.data_ptr(), lse.data_ptr(), int(q.dtype == torch.bfloat16),
                 B, S, T, H, K, hd, hdv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(scale), int(causal), stream)
    if err:
        raise RuntimeError(f"mha_fwd: CUDA launch failed ({route} route): "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    return out, lse


def _kv_len_tensor(kv_len, device, name):
    if kv_len is None:
        return None
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    if kv_len.numel() != 1:
        raise ValueError(f"{name}: kv_len must be a scalar")
    return kv_len


def _check_bwd(name, q, k, v, dout, lse, delta, kv_len, causal,
               segments=None):
    """Shape, dtype and device checks of the backward kernels' operands."""
    _check(q, k, v, kv_len, causal, name, segments)
    B, S, H, _ = q.shape
    if tuple(dout.shape) != (B, S, H, v.shape[3]) or dout.dtype != q.dtype:
        raise ValueError(f"{name}: dout {tuple(dout.shape)} {dout.dtype}; "
                         f"need {(B, S, H, v.shape[3])} in {q.dtype}")
    for what, x in (("lse", lse), ("delta", delta)):
        if tuple(x.shape) != (B, H, S) or x.dtype != torch.float32:
            raise ValueError(f"{name}: {what} {tuple(x.shape)} {x.dtype}; "
                             f"need {(B, H, S)} float32")
    if not all(x.device == q.device for x in (dout, lse, delta)):
        raise ValueError(f"{name}: operands on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {q.device}")


def _launch_bwd(name, route, outs, q, k, v, dout, lse, delta, kv_len, scale,
                causal, segments=None):
    """Launch the ``route`` kernel of ``name`` in ``csrc/mha_bwd.cu`` writing
    ``outs``; raises on operands the kernel does not take and on a failed
    launch. The wrappers pass ``_bwd_route``'s choice; chip_smoke.py also
    times the fma kernels at shapes the mma route takes, beside it. Counts
    nothing."""
    for what, x in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if not _strides_ok(x):
            raise ValueError(f"{name}: {what} needs a contiguous last dim, "
                             "8-element-aligned strides and a 16-byte-aligned "
                             "start")
    for what, x in (("lse", lse), ("delta", delta)):
        if not x.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    q_seg, kv_seg = _seg_ptrs(segments, name)
    kv_len = _kv_len_tensor(kv_len, q.device, name)
    B, S, H, hd = q.shape
    T, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3], *dout.stride()[:3])
    lib = _build.library("mha_bwd")
    fn = _bind_bwd(lib, f"{name}_mma" if route == "mma" else name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(), q_seg, kv_seg,
                 *(o.data_ptr() for o in outs), int(q.dtype == torch.bfloat16),
                 B, S, T, H, K, hd, hdv, strides, float(scale), int(causal),
                 stream)
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed ({route} route): "
                           f"{lib.cuda_error_string(err).decode()} ({err})")


def mha_bwd_dq(q, k, v, dout, lse, delta, kv_len=None, *, scale: float,
               causal: bool = True, segments=None):
    """dQ (B, S, H, hd) in q's dtype.

    q, k, v as for ``mha_fwd``; dout (B, S, H, hdv) in q's dtype; ``lse``
    (B, H, S) f32 is the forward's log-sum-exp and ``delta`` (B, H, S) f32
    is ``sum(f32(dout) * f32(out), -1)``. Masks (and ``segments``) as
    ``mha_fwd``'s.
    """
    _check_bwd("mha_bwd_dq", q, k, v, dout, lse, delta, kv_len, causal,
               segments)
    if q.device.type == "cpu":
        return mha_bwd_dq_ref(q, k, v, dout, lse, delta, kv_len, scale=scale,
                              causal=causal, segments=segments)
    route = _bwd_route(q, k, v)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("mha_bwd_dq", route, (dq,), q, k, v, dout, lse, delta,
                kv_len, scale, causal, segments)
    mha_bwd_dq.launches += 1
    mha_bwd_dq.route_launches[route] += 1
    mha_bwd_dq.segment_launches += segments is not None
    return dq


def mha_bwd_dkv(q, k, v, dout, lse, delta, kv_len=None, *, scale: float,
                causal: bool = True, segments=None):
    """(dK (B, T, K, hd), dV (B, T, K, hdv)) in k's and v's dtype.

    The G = H / K query heads of each kv head are summed inside the kernel,
    so the gradients come out in the kv storage layout. Operands as for
    ``mha_bwd_dq``.
    """
    _check_bwd("mha_bwd_dkv", q, k, v, dout, lse, delta, kv_len, causal,
               segments)
    if q.device.type == "cpu":
        return mha_bwd_dkv_ref(q, k, v, dout, lse, delta, kv_len,
                               scale=scale, causal=causal, segments=segments)
    route = _bwd_route(q, k, v)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _launch_bwd("mha_bwd_dkv", route, (dk, dv), q, k, v, dout, lse, delta,
                kv_len, scale, causal, segments)
    mha_bwd_dkv.launches += 1
    mha_bwd_dkv.route_launches[route] += 1
    mha_bwd_dkv.segment_launches += segments is not None
    return dk, dv


mha_bwd_dq.launches = 0
mha_bwd_dq.route_launches = {"mma": 0, "fma": 0}
mha_bwd_dq.segment_launches = 0
mha_bwd_dkv.launches = 0
mha_bwd_dkv.route_launches = {"mma": 0, "fma": 0}
mha_bwd_dkv.segment_launches = 0
