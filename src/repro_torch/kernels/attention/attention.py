"""Flash-attention forward: the wrapper around the Hopper CUDA kernel.

``mha_fwd`` takes the model's (B, S, H, hd) layout and routes by the
device of its tensors: CPU tensors go to the plain PyTorch version
(``ref.mha_fwd_ref``), CUDA tensors to the hand-written kernel in
``csrc/mha_fwd.cu``, which replaces the TPU kernel
``repro.kernels.attention.attention.mha_fwd``. On the card there is no
fallback: a build or launch failure raises. ``mha_fwd.launches`` counts
kernel launches, so a run can show that it went through the kernel.

The kernel's output carries no autograd history, so on the card a call
that would need a gradient raises until attention backward is ported;
the CPU route stays differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import mha_fwd_ref

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_HEAD_DIM = 256  # the largest K+V tile that fits the H100's shared memory


def _bind(lib: ctypes.CDLL):
    fn = lib.mha_fwd
    if fn.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i64, i64, i64, i64, i64, i64, i64, i64, i64,
                       ctypes.c_float, i, p]
        fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return fn


def _check(q, k, v, kv_len, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("mha_fwd: q, k, v must be 4-D (B, S|T, H|K, hd)")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"mha_fwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if min(B, S, H, T, K) < 1 or H % K:
        raise ValueError(f"mha_fwd: need nonempty shapes and H % K == 0, got "
                         f"H={H} K={K}")
    for name, d in (("hd", hd), ("hdv", v.shape[3])):
        if d % 8 or not 8 <= d <= _MAX_HEAD_DIM:
            raise ValueError(f"mha_fwd: {name}={d} must be a multiple of 8 "
                             f"in [8, {_MAX_HEAD_DIM}]")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"mha_fwd: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "need one of bfloat16, float32 for all three")
    if not (q.device == k.device == v.device):
        raise ValueError("mha_fwd: q, k, v on different devices")
    if causal and kv_len is not None:
        raise ValueError(
            "mha_fwd: kv_len requires causal=False — the decode window is "
            "non-causal within the filled cache")
    if causal and T < S:
        raise ValueError(f"causal attention needs T >= S, got S={S} T={T}")


def _strides_ok(x: torch.Tensor) -> bool:
    # 16-byte row loads: last dim contiguous, rows 8-element aligned
    return (x.stride(3) == 1 and x.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in x.stride()[:3]))


def mha_fwd(q, k, v, kv_len=None, *, scale: float, causal: bool = True):
    """(out, lse): q (B, S, H, hd); k (B, T, K, hd), v (B, T, K, hdv).

    Masks: rectangular causal (query i sees keys <= T - S + i) or, with
    ``causal=False``, the optional ``kv_len`` fill bound (a 0-d int32
    tensor on q's device, or an int). Returns out (B, S, H, hdv) in q's
    dtype and lse (B, H, S) f32.
    """
    _check(q, k, v, kv_len, causal)
    if q.device.type == "cpu":
        return mha_fwd_ref(q, k, v, kv_len, scale=scale, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"mha_fwd: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "mha_fwd: the CUDA kernel has no backward yet, so its output would "
            "silently drop the gradient of q, k and v; attention backward "
            "(kernels mha_bwd_dq and mha_bwd_dkv) lands with the training "
            "step. Call under torch.no_grad(), or on CPU tensors")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not _strides_ok(x):
            raise ValueError(f"mha_fwd: {name} needs a contiguous last dim, "
                             "8-element-aligned strides and a 16-byte-aligned "
                             "start")
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device)
        if kv_len.numel() != 1:
            raise ValueError("mha_fwd: kv_len must be a scalar")
    B, S, H, hd = q.shape
    T, K, hdv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, hdv), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    lib = _build.library("mha_fwd")
    fn = _bind(lib)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 None if kv_len is None else kv_len.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), int(q.dtype == torch.bfloat16),
                 B, S, T, H, K, hd, hdv,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 float(scale), int(causal), stream)
    if err:
        raise RuntimeError(f"mha_fwd: CUDA launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")
    mha_fwd.launches += 1
    return out, lse


mha_fwd.launches = 0
