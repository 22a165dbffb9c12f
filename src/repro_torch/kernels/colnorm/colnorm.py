"""Column/row-norm kernels of the SCALE update: wrappers around the Hopper
CUDA kernels in ``csrc/colnorm.cu``.

They replace the TPU kernels of ``repro.kernels.colnorm.colnorm``
(``norm_sumsq``, ``norm_apply``, ``update_apply``) and take the same
canonical (L, m, n) operands (``canon3`` gives 2-D leaves a unit layer
axis). Routing is by the tensors' device: CPU tensors go to the plain
PyTorch versions in ``ref.py``, CUDA tensors to the kernels. On the card
there is no fallback: a build or launch failure raises. Each wrapper
counts its kernel launches in ``.launches`` (one per call, even where a
call is two CUDA launches: ``norm_sumsq`` adds its split partial sums in
a second one).

Scalar operands (``lr``, ``gscale``) are either 0-d f32 tensors on the
operands' device, which the kernels read from device memory (no host
synchronisation), or Python numbers, passed by value as f32.
``gscale=None`` means 1. Tensors of any strides and alignment are taken;
dtypes are float32 and bfloat16.

``update_apply`` has two CUDA routes, chosen by ``_route`` from the
operands' dtypes, shapes, strides and addresses alone (nothing is read
from the device) and counted in ``update_apply.route_launches``:
``vec`` where theta and g are contiguous and reach a 16-byte boundary at
the same element (every launch of the training step): the tensor is
walked as one flat run, split by ``vec_split`` into a ragged head, 16-byte
vectors and a ragged tail, by a persistent grid; ``strided`` for any other
layout (transposed views, operands at different offsets), one block per
row per 1024 columns through the tensors' strides. Both compute each
element with the same operations in the same order, so they agree bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import (EPS, canon3, check_axis, norm_apply_ref, norm_sumsq_ref,
                  update_apply_ref)

__all__ = ["canon3", "norm_sumsq", "norm_apply", "update_apply"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Split reductions: enough blocks to fill 132 SMs at 8 blocks of 256
# threads each, at most 64 terms per lane and at least 8 before a split.
_TARGET_BLOCKS = 132 * 8
_MAX_TERMS, _MIN_TERMS = 64, 8
_MAX_SPLITS = 65535  # gridDim.y
_EW_COLS = 1024      # element-wise kernels: columns per block
_VEC_BYTES = 16      # update_apply's vec route: 16-byte accesses
_VEC_MAX = 2**31     # its flat offsets and divisions are 32-bit


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(axis: str, L: int, m: int, n: int) -> tuple:
    """(S, chunk): the reduce axis cut into S ranges of ``chunk``.

    Lanes along the reduce axis per block: 8 warps striding rows (col), or
    32 lanes of one warp striding columns (row). Depends on the shape
    alone, so repeated runs sum in the same order.
    """
    if axis == "col":
        tiles, red, lanes = L * cdiv(n, 32), m, 8
    else:
        tiles, red, lanes = L * cdiv(m, 8), n, 32
    S = max(cdiv(_TARGET_BLOCKS, tiles), cdiv(red, _MAX_TERMS * lanes))
    S = max(1, min(S, cdiv(red, _MIN_TERMS * lanes), _MAX_SPLITS))
    chunk = cdiv(red, S)
    return cdiv(red, chunk), chunk


def scalar_arg(x, name: str, device) -> tuple:
    """(device pointer or None, value) of a scalar operand."""
    if torch.is_tensor(x):
        if x.numel() != 1 or x.dtype != torch.float32 or x.device != device:
            raise ValueError(f"{name} must be a Python number or a 1-element "
                             f"float32 tensor on {device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
        return x.data_ptr(), 0.0
    return None, float(x)


def check_operands(op: str, *tensors) -> torch.device:
    """Common device and dtype checks; -> the operands' device."""
    dev = tensors[0].device
    for t in tensors:
        if t.ndim != 3:
            raise ValueError(f"{op}: operands must be canonical (L, m, n), got "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{op}: operands on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {dev}")
    if dev.type == "cuda":
        for t in tensors:
            if t.dtype not in _DTYPES:
                raise ValueError(f"{op}: dtype {t.dtype}; the kernel takes "
                                 "float32 and bfloat16")
            if min(t.shape) < 1:
                raise ValueError(f"{op}: empty operand {tuple(t.shape)}")
        L, m, n = tensors[0].shape
        if L * m >= 2**31 or cdiv(n, _EW_COLS) > 65535 or L > 65535:
            raise ValueError(f"{op}: shape {tuple(tensors[0].shape)} exceeds "
                             "the kernels' grid")
    return dev


def check_ss(op: str, ss, axis: str, L: int, m: int, n: int):
    want = (L, 1, n) if axis == "col" else (L, m, 1)
    if tuple(ss.shape) != want or ss.dtype != torch.float32:
        raise ValueError(f"{op}: ss must be float32 {want}, got {ss.dtype} "
                         f"{tuple(ss.shape)}")
    return ss.contiguous()


def check_distinct(op: str, out, inp):
    if out.untyped_storage().data_ptr() == inp.untyped_storage().data_ptr():
        raise ValueError(f"{op}: the in-place operand shares storage with an "
                         "input")


def vec_width(theta, g) -> int:
    """Elements per vector of the vec route: 16 bytes of the narrower
    operand (8 with a bf16 operand, 4 for two f32 ones)."""
    return _VEC_BYTES // min(theta.element_size(), g.element_size())


def vec_head(theta, g):
    """The fewest leading elements (fewer than ``vec_width``) after which
    theta and g both start on a 16-byte boundary, or None if there is no
    such count."""
    for h in range(vec_width(theta, g)):
        if all((t.data_ptr() + h * t.element_size()) % _VEC_BYTES == 0
               for t in (theta, g)):
            return h
    return None


def vec_split(numel: int, head: int, width: int) -> tuple:
    """(head, vectors, tail) of the vec route's flat run of ``numel``
    elements: ``head`` elements one by one, then ``vectors`` runs of
    ``width``, then the ``tail`` elements one by one."""
    head = min(head, numel)
    nvec = (numel - head) // width
    return head, nvec, numel - head - nvec * width


def _route(theta, g) -> str:
    """The update_apply kernel a CUDA call takes: "vec" where theta and g
    are contiguous, reach a 16-byte boundary at the same element and hold
    fewer than 2**31 elements; "strided" otherwise. By dtype, shape,
    strides and address alone; both routes compute the same function."""
    if (theta.is_contiguous() and g.is_contiguous()
            and theta.numel() < _VEC_MAX and vec_head(theta, g) is not None):
        return "vec"
    return "strided"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.norm_sumsq.argtypes is None:
        p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
        lib.norm_sumsq.argtypes = [p, i, i64, i64, i64, i, i, i, i, p, f, p,
                                   p, i, i, p]
        lib.update_apply.argtypes = [p, i, i64, i64, i64, p, i, i64, i64, i64,
                                     p, i, i, i, i, p, f, p, f, f, p]
        lib.update_apply_vec.argtypes = [p, i, p, i, p, i, i, i, i, i, i, i,
                                         p, f, p, f, f, p]
        lib.norm_apply.argtypes = [p, i, i64, i64, i64, p, p, i, i, i, i, i,
                                   p, f, f, p]
        for fn in (lib.norm_sumsq, lib.update_apply, lib.update_apply_vec,
                   lib.norm_apply):
            fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(source: str, bind, op: str, device, *args) -> None:
    """Call kernel function ``op`` of library ``source`` on the current
    stream of ``device``; raise on a launch error."""
    lib = bind(_build.library(source))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, op)(*args, stream)
    if err:
        raise RuntimeError(f"{op}: CUDA launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")


def norm_sumsq(g, axis: str = "col", *, gscale=None) -> torch.Tensor:
    """Sum of squares of gscale * g along rows (col) or columns (row).

    g (L, m, n) -> f32 (L, 1, n) for col, (L, m, 1) for row.
    """
    check_axis(axis)
    dev = check_operands("norm_sumsq", g)
    if dev.type == "cpu":
        return norm_sumsq_ref(g, axis, gscale=gscale)
    L, m, n = g.shape
    S, chunk = split_plan(axis, L, m, n)
    out = torch.empty((L, 1, n) if axis == "col" else (L, m, 1),
                      dtype=torch.float32, device=dev)
    part = out if S == 1 else torch.empty(
        (L, S, n if axis == "col" else m), dtype=torch.float32, device=dev)
    gs_p, gs_v = scalar_arg(1.0 if gscale is None else gscale, "gscale", dev)
    launch("colnorm", _bind, "norm_sumsq", dev, g.data_ptr(), _DTYPES[g.dtype],
           *g.stride(), L, m, n, int(axis == "row"), gs_p, gs_v,
           part.data_ptr(), out.data_ptr(), S, chunk)
    norm_sumsq.launches += 1
    return out


def norm_apply(g, ss, axis: str = "col", *, eps: float = EPS, gscale=None,
               out_dtype=None) -> torch.Tensor:
    """gscale * g / (sqrt(ss) + eps) with ss broadcast along the reduce axis.

    Math is f32; ``out_dtype`` (float32 or bfloat16) overrides the output
    dtype, g's by default.
    """
    check_axis(axis)
    dev = check_operands("norm_apply", g)
    L, m, n = g.shape
    if dev.type == "cpu":
        return norm_apply_ref(g, ss, axis, eps=eps, gscale=gscale,
                              out_dtype=out_dtype)
    ss = check_ss("norm_apply", ss, axis, L, m, n)
    out_dtype = out_dtype or g.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"norm_apply: out_dtype {out_dtype}; the kernel "
                         "writes float32 and bfloat16")
    out = torch.empty((L, m, n), dtype=out_dtype, device=dev)
    gs_p, gs_v = scalar_arg(1.0 if gscale is None else gscale, "gscale", dev)
    launch("colnorm", _bind, "norm_apply", dev, g.data_ptr(), _DTYPES[g.dtype],
           *g.stride(), ss.data_ptr(), out.data_ptr(), _DTYPES[out_dtype],
           L, m, n, int(axis == "row"), gs_p, gs_v, float(eps))
    norm_apply.launches += 1
    return out


def update_apply(theta, g, ss, lr, axis: str = "col", *, eps: float = EPS,
                 gscale=None) -> torch.Tensor:
    """theta - lr * gscale * g / (sqrt(ss) + eps), written into theta.

    The fused SCALE parameter write: theta is updated in place (the TPU
    kernel aliases it to its output) and returned. On the card the kernel
    is the one ``_route`` names.
    """
    check_axis(axis)
    dev = check_operands("update_apply", theta, g)
    L, m, n = theta.shape
    if tuple(g.shape) != (L, m, n):
        raise ValueError(f"update_apply: theta {tuple(theta.shape)} and g "
                         f"{tuple(g.shape)} differ")
    if dev.type == "cpu":
        return update_apply_ref(theta, g, ss, lr, axis, eps=eps,
                                gscale=gscale)
    ss = check_ss("update_apply", ss, axis, L, m, n)
    check_distinct("update_apply", theta, g)
    lr_p, lr_v = scalar_arg(lr, "lr", dev)
    gs_p, gs_v = scalar_arg(1.0 if gscale is None else gscale, "gscale", dev)
    route = _route(theta, g)
    if route == "vec":
        split = vec_split(L * m * n, vec_head(theta, g), vec_width(theta, g))
        launch("colnorm", _bind, "update_apply_vec", dev, theta.data_ptr(),
               _DTYPES[theta.dtype], g.data_ptr(), _DTYPES[g.dtype],
               ss.data_ptr(), L, m, n, int(axis == "row"), *split, lr_p,
               lr_v, gs_p, gs_v, float(eps))
    else:
        launch("colnorm", _bind, "update_apply", dev, theta.data_ptr(),
               _DTYPES[theta.dtype], *theta.stride(), g.data_ptr(),
               _DTYPES[g.dtype], *g.stride(), ss.data_ptr(), L, m, n,
               int(axis == "row"), lr_p, lr_v, gs_p, gs_v, float(eps))
    update_apply.launches += 1
    update_apply.route_launches[route] += 1
    return theta


norm_sumsq.launches = 0
norm_apply.launches = 0
update_apply.launches = 0
update_apply.route_launches = {"vec": 0, "strided": 0}
