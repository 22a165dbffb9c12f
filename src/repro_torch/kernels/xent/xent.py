"""Fused LM-head cross-entropy: wrappers around the Hopper CUDA kernels in
``csrc/xent.cu``.

They replace the TPU kernels of ``repro.kernels.xent.xent``
(``xent_fwd``, ``xent_bwd_dh``, ``xent_bwd_dw``) with the same arguments,
less ``block`` and ``interpret``: tile sizes are the kernels' own. Routing
is by the tensors' device: CPU tensors go to the plain PyTorch versions in
``ref.py``, CUDA tensors to the kernels. On the card there is no
fallback: a build or launch failure raises. Each wrapper counts its kernel
launches in ``.launches``.

The kernels take h (N, D) and w (D, V) of any strides, both bfloat16 or
both float32, with N, D and V below 2**31, labels (N,) int32 and, for the
backward, lse and gl (N,) float32. Each function has two routes: bf16
operands whose rows are contiguous and 16-byte aligned, with D a multiple
of 16 (``mma_layout``), take the tensor cores, other layouts and float32
the f32-FMA kernels (``fma``). The tensor-core forward (``wgmma``) runs on
wgmma and TMA: blocks of 128 token rows walk a split of the vocabulary
(``split_plan``) in tiles of 256 columns, their K loop over D in tiles of
64, and a second launch combines the splits' partials in order. The
tensor-core backward (``mma``) is chunked: per chunk of the vocabulary
(and, past 2**17 tokens, of the tokens; ``chunk_plan``) a G kernel writes
G = (softmax - onehot) * gl as two bf16 halves to a workspace of at most
64 MiB, and a GEMM contracts it with w (dH, summed over the chunks in f32)
or h (dW). The FMA kernels walk D in slabs of 2048 (two at llama-7b's
D = 4096), summing each logit tile over the slabs in order before they use
it; the backward's blocks each own one slab of the output's D and
recompute the logits for it. No route holds an on-chip accumulator that
grows with D, and every sum runs in a fixed order, so two runs are bitwise equal.
``.launches`` counts one per wrapper call, however many launches it
makes; each wrapper also counts by route in ``route_launches``. Not
ported yet, and raising ``NotImplementedError``:
``transposed=True`` (the tied (V, D) head, ROADMAP Queue 1 item 7) and a
non-zero ``col_offset`` (vocab-sharded heads, item 12).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import xent_bwd_dh_ref, xent_bwd_dw_ref, xent_fwd_ref

__all__ = ["xent_fwd", "xent_bwd_dh", "xent_bwd_dw", "chunk_plan"]

_DTYPES = (torch.float32, torch.bfloat16)
# tensor-core forward: 128 token rows per block, vocab tiles of 256
# columns, the vocab split so that the grid holds about one block (of 192 KB
# of shared memory) per SM of the H100
_WG_ROWS, _WG_COLS, _WG_TARGET_BLOCKS = 128, 256, 132
# tensor-core backward: G's hi and lo halves of one chunk (4 bytes per
# element) fit this; chunks are whole GEMM tiles of 128 columns
_G_BYTES, _G_TILE = 64 * 2**20, 128


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.xent_fwd.argtypes is None:
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        head = [p, i64, i64, p, i64, i64, i]  # h, strides, w, strides, is_bf16
        lib.xent_fwd.argtypes = head + [p, p, p, i, i, i, p]
        for fn in (lib.xent_bwd_dh, lib.xent_bwd_dw):
            fn.argtypes = head + [p, p, p, p, i, i, i, i, i, p]
        lib.xent_fwd_wgmma.argtypes = [p, i64, p, i64, p, p, p, p, i, i, i,
                                       i, i, p]
        lib.xent_bwd_chunks.argtypes = [i, p, i64, p, i64, p, p, p, p, p, p,
                                        i, i, i, i, i, i, i, p]
        for fn in (lib.xent_fwd, lib.xent_fwd_wgmma, lib.xent_bwd_dh,
                   lib.xent_bwd_dw, lib.xent_bwd_chunks):
            fn.restype = i
        lib.cuda_error_string.argtypes = [i]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def _not_ported(op: str, col_offset, transposed: bool) -> None:
    if transposed:
        raise NotImplementedError(
            f"{op}: transposed=True (the tied (V, D) head) is not ported yet; "
            "ROADMAP.md Queue 1 item 7")
    if not (isinstance(col_offset, int) and col_offset == 0):
        raise NotImplementedError(
            f"{op}: a non-zero col_offset (vocab-sharded heads) is not ported "
            "yet; ROADMAP.md Queue 1 item 12")


def _check(op: str, h, w, labels, vectors=()) -> torch.device:
    """Shape and device checks on every route; dtype and size checks on the
    card. -> the operands' device."""
    if h.ndim != 2 or w.ndim != 2 or h.shape[1] != w.shape[0]:
        raise ValueError(f"{op}: need h (N, D) and w (D, V), got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    N, D = h.shape
    V = w.shape[1]
    for name, x in (("labels", labels), *vectors):
        if tuple(x.shape) != (N,):
            raise ValueError(f"{op}: {name} must be ({N},), got "
                             f"{tuple(x.shape)}")
    dev = h.device
    for x in (w, labels, *(x for _, x in vectors)):
        if x.device != dev:
            raise ValueError(f"{op}: operands on {x.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: unsupported device {dev}")
    if dev.type == "cuda":
        if h.dtype not in _DTYPES or w.dtype != h.dtype:
            raise ValueError(f"{op}: dtypes {h.dtype}, {w.dtype}; the kernel "
                             "takes h and w both float32 or both bfloat16")
        if labels.dtype != torch.int32:
            raise ValueError(f"{op}: labels must be int32, got {labels.dtype}")
        for name, x in vectors:
            if x.dtype != torch.float32:
                raise ValueError(f"{op}: {name} must be float32, got "
                                 f"{x.dtype}")
        # the kernels index rows, columns and D with 32-bit ints
        if min(N, D, V) < 1 or max(N, D, V) >= 2**31:
            raise ValueError(f"{op}: shape N={N} D={D} V={V}; the kernel takes "
                             "N, D and V in [1, 2**31)")
    return dev


def _launch(op: str, dev, *args) -> None:
    lib = _bind(_build.library("xent"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, op)(*args, stream)
    if err:
        raise RuntimeError(f"{op}: CUDA launch failed: "
                           f"{lib.cuda_error_string(err).decode()} ({err})")


def _head_args(h, w):
    return (h.data_ptr(), *h.stride(), w.data_ptr(), *w.stride(),
            int(h.dtype == torch.bfloat16))


def mma_layout(h, w) -> bool:
    """True when the tensor-core kernels take (h, w): bf16, rows contiguous
    along D and V and 16-byte aligned, D a multiple of 16 and V of 8."""
    return (h.dtype == w.dtype == torch.bfloat16
            and h.stride(1) == 1 and w.stride(1) == 1
            and h.stride(0) % 8 == 0 and w.stride(0) % 8 == 0
            and h.shape[1] % 16 == 0 and w.shape[1] % 8 == 0
            and h.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def split_plan(N: int, ncols: int) -> tuple:
    """(splits, vocab tiles per split) of the tensor-core forward: the
    vocab tiles of ``_WG_COLS`` cut so that the grid of row tiles by splits
    holds at most ``_WG_TARGET_BLOCKS`` blocks (or one split when the row
    tiles alone are more). Depends on the shape alone, so runs sum in the
    same order."""
    row_tiles = -(-N // _WG_ROWS)
    v_tiles = -(-ncols // _WG_COLS)
    splits = max(1, min(v_tiles, _WG_TARGET_BLOCKS // row_tiles))
    per = -(-v_tiles // splits)
    return -(-v_tiles // per), per


def chunk_plan(N: int, ncols: int) -> tuple:
    """(rows, cols) of one chunk of the tensor-core backward: the vocab is
    cut into chunks of ``cols`` columns (a multiple of 128; the last chunk
    takes the rest) and the tokens into chunks of ``rows``, so that G's two
    bf16 halves, (min(N, rows), cols), fit ``_G_BYTES``. Tokens are cut
    only when a chunk of 128 columns over all N does not fit (N > 2**17).
    Depends on (N, ncols) alone, so runs sum in the same order."""
    tiles = -(-ncols // _G_TILE)
    cols = _G_TILE * max(1, min(tiles, _G_BYTES // (4 * N * _G_TILE)))
    rows = N if 4 * N * cols <= _G_BYTES else (
        _G_BYTES // (4 * cols) // _G_TILE * _G_TILE)
    return rows, cols


def _ncols(w, vocab_size: int) -> int:
    if vocab_size < 1:
        raise ValueError(f"vocab_size must be >= 1, got {vocab_size}")
    return min(w.shape[1], vocab_size)


def xent_fwd(h, w, labels, *, vocab_size: int, col_offset=0,
             transposed: bool = False):
    """Per-token (lse, ll): h (N, D), w (D, V), labels (N,) int32.

    Returns two (N,) f32 tensors: the log-sum-exp over the valid columns
    (< V and < vocab_size) and the logit at the label (0 for a -1 label or
    one on an invalid column). ``loss = lse - ll`` for valid tokens.
    """
    _not_ported("xent_fwd", col_offset, transposed)
    dev = _check("xent_fwd", h, w, labels)
    ncols = _ncols(w, vocab_size)
    if dev.type == "cpu":
        return xent_fwd_ref(h, w, labels, vocab_size=vocab_size)
    N, D = h.shape
    lse = torch.empty(N, dtype=torch.float32, device=dev)
    ll = torch.empty(N, dtype=torch.float32, device=dev)
    labels = labels.contiguous()
    if mma_layout(h, w):
        route = "wgmma"
        splits, per = split_plan(N, ncols)
        part = torch.empty((3, N, splits), dtype=torch.float32, device=dev)
        _launch("xent_fwd_wgmma", dev, h.data_ptr(), h.stride(0),
                w.data_ptr(), w.stride(0), labels.data_ptr(), part.data_ptr(),
                lse.data_ptr(), ll.data_ptr(), N, D, ncols, splits, per)
    else:
        route = "fma"
        _launch("xent_fwd", dev, *_head_args(h, w), labels.data_ptr(),
                lse.data_ptr(), ll.data_ptr(), N, D, ncols)
    xent_fwd.launches += 1
    xent_fwd.route_launches[route] += 1
    return lse, ll


def _bwd(fn, h, w, labels, lse, gl, vocab_size, col_offset, out_dtype,
         transposed, ref, out_shape):
    op = fn.__name__
    _not_ported(op, col_offset, transposed)
    dev = _check(op, h, w, labels, (("lse", lse), ("gl", gl)))
    ncols = _ncols(w, vocab_size)
    if dev.type == "cpu":
        return ref(h, w, labels, lse, gl, vocab_size=vocab_size,
                   out_dtype=out_dtype)
    if out_dtype not in _DTYPES:
        raise ValueError(f"{op}: out_dtype {out_dtype}; the kernel writes "
                         "float32 and bfloat16")
    (N, D), V = h.shape, w.shape[1]
    out = torch.empty(out_shape, dtype=out_dtype, device=dev)
    labels, lse, gl = labels.contiguous(), lse.contiguous(), gl.contiguous()
    out_bf16 = int(out_dtype == torch.bfloat16)
    if mma_layout(h, w):
        route, dh = "mma", op == "xent_bwd_dh"
        rows, cols = chunk_plan(N, ncols)
        g = torch.empty((2, min(N, rows), cols), dtype=torch.bfloat16,
                        device=dev)
        # an f32 sum across chunks, unless the output is f32 and holds it
        summed = ncols > cols if dh else N > rows
        acc = (torch.empty((min(N, rows), D) if dh else (D, cols),
                           dtype=torch.float32, device=dev)
               if out_bf16 and summed else None)
        _launch("xent_bwd_chunks", dev, int(dh), h.data_ptr(), h.stride(0),
                w.data_ptr(), w.stride(0), labels.data_ptr(), lse.data_ptr(),
                gl.data_ptr(), g.data_ptr(),
                None if acc is None else acc.data_ptr(), out.data_ptr(),
                out_bf16, N, D, V, ncols, rows, cols)
    else:
        route = "fma"
        _launch(op, dev, *_head_args(h, w), labels.data_ptr(),
                lse.data_ptr(), gl.data_ptr(), out.data_ptr(), out_bf16, N, D,
                V, ncols)
    fn.launches += 1
    fn.route_launches[route] += 1
    return out


def xent_bwd_dh(h, w, labels, lse, gl, *, vocab_size: int, col_offset=0,
                out_dtype=torch.float32, transposed: bool = False):
    """dH (N, D) in ``out_dtype``: the gl-weighted (softmax - onehot)
    contracted with w. ``gl`` (N,) f32 is the per-token cotangent (0 for
    masked labels), ``lse`` the forward's log-sum-exp."""
    return _bwd(xent_bwd_dh, h, w, labels, lse, gl, vocab_size, col_offset,
                out_dtype, transposed, xent_bwd_dh_ref, tuple(h.shape))


def xent_bwd_dw(h, w, labels, lse, gl, *, vocab_size: int, col_offset=0,
                out_dtype=torch.float32, transposed: bool = False):
    """dW (D, V) in ``out_dtype``: h^T contracted with the gl-weighted
    (softmax - onehot); columns at or past ``vocab_size`` are 0."""
    return _bwd(xent_bwd_dw, h, w, labels, lse, gl, vocab_size, col_offset,
                out_dtype, transposed, xent_bwd_dw_ref, tuple(w.shape))


xent_fwd.launches = 0
xent_fwd.route_launches = {"wgmma": 0, "fma": 0}
xent_bwd_dh.launches = 0
xent_bwd_dw.launches = 0
xent_bwd_dh.route_launches = {"mma": 0, "fma": 0}
xent_bwd_dw.route_launches = {"mma": 0, "fma": 0}
