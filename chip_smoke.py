#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It builds the port's CUDA kernels with
nvcc (one process per source, in parallel), then runs nine phases and fails
(non-zero exit, no result line) if any of them fails:

1. device: the card's name and power limit, the kernels' ptxas report;
2. every kernel against its plain PyTorch version on the card, at the
   main paths' shapes and at the edge cases, with stated tolerances;
   ``mha_fwd`` on the route its wrapper picks (``mma`` tensor cores,
   ``fma`` or ``decode``), with the route counted, and the fma kernel
   also at the eval shape in bf16; ``mha_bwd_dq`` and ``mha_bwd_dkv`` on
   the route their wrappers pick (``mma`` tensor cores for bf16, ``fma``
   for f32 and for gemma-2b's bf16 heads of 256 over one kv head),
   counted, and the fma kernels also at the training shape in bf16; the
   xent kernels on the route their wrappers pick (for aligned
   bf16 ``wgmma``, the forward on wgmma and TMA, and ``mma``, the chunked
   tensor-core backward; ``fma`` for f32 and other layouts), counted,
   with each backward output's largest error over its tolerance, at
   llama-1b's, llama-7b's (D = 4096) and gemma-2b's (V = 256000) loss
   shapes among others (and a D of 4100 that ends the FMA kernels' last
   slab of D mid-way); the tensor-core forwards, the
   optimizer, cross-entropy and attention-backward kernels also run twice
   (bitwise equal), and the optimizer kernels show that they write in
   place where the TPU kernels alias; ``update_apply`` on its ``vec`` route
   (16-byte vectors over the flat run) at a common offset of 0-7 elements
   of theta and g, for bf16, bf16 with an f32 g and f32, col and row, lr
   and gscale by value and by device pointer, bitwise equal to its
   ``strided`` route on the same values laid out transposed, with both
   routes counted;
3. the serving path: greedy serving of llama-130m at full width and
   depth (bf16, seeded random weights; batch 8, a 512-token prompt, 64
   new tokens), checked against a full-sequence forward, with the kernel
   launch counts of the run (the prefill's on the ``mma`` route, every
   decode step's on ``decode``);
4. kernel times with CUDA events beside their bound, the plain version
   and one PyTorch library call computing the same function; for the
   attention kernels also their device time (torch.profiler) and, where
   they take the tensor cores, the fma kernels' time at the same shape
   (the backward pair at the training shape and at qwen2-500m's GQA
   shape), and, as ``mha_fwd``, at phase 9's training shapes of llama-7b
   (hd 128) and gemma-2b (hd 256, the fma route); for the xent kernels,
   at llama-1b's, llama-7b's and gemma-2b's loss shapes, also their device
   time and, for the backward, a second library yardstick that recomputes
   the logits, at llama-1b's and llama-7b's also the FMA kernels (one and
   two slabs of D), and
   variants of the xent sources built beside them, timed against the
   real kernels (of the backward: the fold taken out, the copies taken
   out; of the forward: the softmax epilogue taken out, and the wgmma
   too); the optimizer kernels and their library calls also by device
   time, in turns; ``update_apply`` also at the head (bf16 theta, f32 m')
   and, in turns, beside its ``strided`` route on the same bytes and a
   variant that only loads and stores them;
5. where the serving time goes: device busy time and the top kernels of
   one prefill and of decode steps, from torch.profiler;
6. the optimizer path: SCALE steps of llama-1b at full width and depth
   (bf16 params and grads from the seed, the clip factor from the global
   norm, ``scale_fused`` with the warmup-cosine schedule and lr_scaling):
   three ``update_params`` steps and three ``update`` + ``apply_updates``
   steps, their kernel launch counts checked per step (``update_apply``'s
   on the ``vec`` route), the result held
   against ``impl="jnp"`` on the same card, one step under
   ``torch.cuda.set_sync_debug_mode("error")``, step times beside the
   bound, the step's device busy time and top kernels (torch.profiler),
   and peak memory;
7. the loss path: llama-1b at full width and depth (bf16, seeded random
   weights; batch 16 of 256 tokens from the ported ``SyntheticLM``):
   ``make_eval_step`` (exactly 24 ``mha_fwd``, all on the ``mma`` route,
   and 1 ``xent_fwd``, on ``wgmma``), its loss against the plain
   full-logit route on the same hidden, against a forward whose attention
   is the plain ``mha_fwd_ref``, and beside ln(V) + sigma^2/2; the loss
   and its gradient at the head (exactly 1 launch of each xent kernel, the
   forward on ``wgmma``, the backward pair on ``mma``), held against the
   plain route's autograd, once under ``set_sync_debug_mode("error")``; times,
   top device kernels and the peak memory each route adds;
8. the training step: llama-1b at full width and depth (bf16, seeded
   random weights, batches of 16 x 256 from ``SyntheticLM``,
   ``scale_fused`` with clip 1.0 and ``remat="full"``): the launcher's
   ``main`` for three steps, then ``make_train_step`` for eight, each step's
   launches checked on every kernel counter (48 ``mha_fwd``, all on the
   ``mma`` route, 24 of each attention backward kernel, all on the ``mma``
   route, one of each xent kernel, the forward on ``wgmma``, the backward
   pair on ``mma``, 8 ``norm_sumsq``, 9 ``update_apply``, all on the
   ``vec`` route, one ``momentum_sumsq``), the loss falling and held to
   the curve of the same steps with attention through plain ``mha_fwd_ref``
   autograd, one step under ``set_sync_debug_mode("error")``, every leaf's
   gradient held against the plain-attention route (bf16 at full depth,
   f32 at 4 layers), the step's time, tokens/s, device busy time, idle
   share, top kernels and peak memory;
9. the training step of the paper's two largest models at full width and
   depth: llama-7b (32 layers, D = 4096, 32 heads of 128) and gemma-2b (18
   layers, 8 heads of 256 over one kv head, vocab 256000), each through
   the launcher for two steps and then ``make_train_step`` for four
   (bf16, batches of 16 x 256, ``scale_fused``, clip 1.0), every step's
   launches checked by route (llama-7b: 64 ``mha_fwd``, 32 of each
   attention backward kernel, all ``mma``; gemma-2b: 36, 18 and 18, all
   ``fma``; both: one of each xent kernel, the forward on ``wgmma`` and
   the backward on ``mma``, 8 ``norm_sumsq``, 9 ``update_apply`` on
   ``vec``, one ``momentum_sumsq``), the loss curve held to the same
   steps with attention through plain ``mha_fwd_ref`` autograd from the
   same seeded weights (full depth: the two routes run one after the
   other), step time, tokens/s, device busy time by kernel family, idle
   share and peak memory.

The line before the last is a JSON ``{"kernels": [...]}`` summary, the
last line ``{"ok": true, "device": {...}}``. It needs a CUDA card and
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import atexit
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12

# Kernel against plain version, per element (reasons in the comments):
# f32 out: both sides sum unit-scale products in f32 in other orders.
F32_OUT_ATOL = 2e-5
# bf16 out: the kernel rounds the running, unnormalized p to bf16, the plain
# version the normalized p; the output itself has 8 bits of mantissa.
BF16_OUT_ATOL, BF16_OUT_RTOL = 2e-2, 2e-2
# lse is f32 in both dtypes. f32 scores are f32 FMAs; bf16 scores (the
# tensor-core route) are exact bf16 products summed in f32 inside mma.sync,
# chained over at most 8 k-steps through its truncating f32 accumulator:
# some 1e-6 of a unit-scale score, and lse moves no more than its scores.
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# Last decode step's logits against the full-sequence forward (bf16,
# 12 layers): the two paths round each bf16 matmul output at different
# places (one row against 575), about 2^-8 relative each, compounding
# through 12 residual layers.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2

SRC_MHA = "src/repro_torch/kernels/attention/csrc/mha_fwd.cu"
TPU_MHA = "src/repro/kernels/attention/attention.py:223"
SRC_MHA_BWD = "src/repro_torch/kernels/attention/csrc/mha_bwd.cu"
SRC_COLNORM = "src/repro_torch/kernels/colnorm/csrc/colnorm.cu"
SRC_MOMENTUM = "src/repro_torch/kernels/scale_head/csrc/momentum_sumsq.cu"
SRC_XENT = "src/repro_torch/kernels/xent/csrc/xent.cu"
SRC_HOPPER = "src/repro_torch/kernels/xent/csrc/hopper_gemm.cuh"
TPU_KERNELS = {  # the Pallas kernel bodies each CUDA kernel replaces
    "norm_sumsq": "src/repro/kernels/colnorm/colnorm.py:113",
    "update_apply": "src/repro/kernels/colnorm/colnorm.py:219",
    "norm_apply": "src/repro/kernels/colnorm/colnorm.py:176",
    "momentum_sumsq": "src/repro/kernels/scale_head/scale_head.py:36",
    "xent_fwd": "src/repro/kernels/xent/xent.py:149",
    "xent_bwd_dh": "src/repro/kernels/xent/xent.py:218",
    "xent_bwd_dw": "src/repro/kernels/xent/xent.py:291",
    "mha_bwd_dq": "src/repro/kernels/attention/attention.py:321",
    "mha_bwd_dkv": "src/repro/kernels/attention/attention.py:401",
}
BWD_KERNELS = ("mha_bwd_dq", "mha_bwd_dkv")
XENT_KERNELS = ("xent_fwd", "xent_bwd_dh", "xent_bwd_dw")

# Optimizer kernels against their plain versions (phase 2), per element:
# sums of squares (f32): both sides sum positive f32 terms in other
# orders, the kernel in chains of at most 64 + 8 + S terms (S splits),
# torch in its own; the relative error of such a chain is at most
# (n - 1) * 2**-24, 1.5e-5 at n = 256.
SS_RTOL = 2e-5
# element-wise outputs, given the same ss: the same IEEE f32 operations in
# the same order on both sides (the kernels use _rn intrinsics, so nvcc
# contracts nothing into FMAs), one rounding to the output dtype: at most
# one ulp of the output dtype at the scale of the formula's terms.
EW_ULPS = 1
# Phase 6, impl="fused" against impl="jnp" after the six steps, per
# element of the bf16 params: each step rounds theta once on each route,
# and the routes round differently by design (the fused write rounds
# theta - lr*g/norm once from f32; the jnp route rounds the f32 update to
# bf16 and then the sum; its colnorm multiplies by a reciprocal, the kernel
# divides): at most 1.5 bf16 ulps of the element's peak magnitude (the
# largest |theta| or |step| of its trajectory) per step, so 8 in six steps.
STEP_ULPS = 8
# the f32 momentum: the kernel forms 1 - beta in f32 (as the TPU kernel),
# the jnp route in double (as JAX's jnp route), 2.4e-7 apart relative; six
# EMA steps of that plus rounding stay within 4e-6 of the leaf's max |m|.
MOMENTUM_RTOL = 4e-6
# Cross-entropy kernels against their plain versions (phase 2), with lse
# from the plain forward:
# lse and ll: f32 sums of D exact products in other orders (logits of
# order 1), and a log-sum-exp over V terms.
XENT_LSE_ATOL, XENT_LSE_RTOL = 1e-4, 1e-5
# dh and dw: f32 sums over the vocab (dh) or the tokens (dw) of recomputed
# logits, in other orders: 1e-5 of the largest |ref| plus 1e-4 relative;
# written as bf16, one rounding on each side adds 2**-8 relative, so 8e-3.
XENT_GRAD_SCALE_ATOL = 1e-5
XENT_GRAD_RTOL = {"float32": 1e-4, "bfloat16": 8e-3}
# Phase 7: the mean loss against the plain route on the same hidden (f32
# means of 4096 per-token losses of order 10, summed in other orders).
LOSS_ATOL = 1e-4
# Phase 7: the eval loss against a forward whose attention is mha_fwd_ref.
# The two forwards differ by the bf16 roundings of each attention output
# (the kernel rounds the running p, the plain version the normalized p),
# carried through 24 residual layers; a relative change e of the final
# hidden moves a per-token loss by about e times the spread of the logits
# (about 1 at this init), and the mean of 4096 such moves of either sign
# by far less than e.
EVAL_REF_ATOL = 2e-3
# Attention backward kernels against their plain versions (phase 2), with
# lse and delta from the plain forward, per element: f32, sums of up to a
# few thousand terms (dK of qwen2's 7-head groups over 512 rows) in other
# orders; bf16, p and ds are rounded to bf16 at the same places on both
# sides but from f32 values that differ in their last bits, so a rare term
# lands one bf16 ulp apart, and each output is rounded once on each side.
BWD_SCALE_ATOL = {"float32": 1e-5, "bfloat16": 2e-3}
BWD_RTOL = {"float32": 1e-5, "bfloat16": 8e-3}
# Phase 8, one loss-and-grad of llama-1b against the same call with the
# attention through plain mha_fwd_ref autograd, per leaf:
# f32 at full width and 4 layers, per element against the leaf's largest
# |gradient|: the two attentions agree to f32 rounding (about 1e-6
# relative, phase 2), which the backward through 4 layers carries at that
# size; 1e-4 leaves a wide margin.
TRAIN_GRAD_F32 = 1e-4
# bf16 at full depth, the leaf's relative error in norm: the forwards round
# each attention output differently (the kernel rounds the running p, the
# plain version the normalized p), about 2**-8 relative where they differ,
# compounding through 24 layers forward and back, and at random init the
# attention gradients are sums that cancel toward zero (ROADMAP reference
# caveat 1), where a few roundings are a large share.
TRAIN_GRAD_BF16 = 5e-2
# Phase 8, the loss curve of 8 steps against the plain-attention route's:
# each step's update differs by the gradients' bf16 difference above (a few
# % of a column-normalized step), which moves the next loss by a few % of
# that step's loss change (about 0.05 here), accumulating over 8 steps.
LOSS_CURVE_ATOL = 2e-2
TRAIN_STEPS = 8


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """One line per kernel of nvcc's -Xptxas -v log: registers and spills."""
    names, out, name, spill = [], [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            names.append(name)
            out.append(f"{line.split(':', 1)[1].strip()}; {spill}")
    if shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True, timeout=60,
                               check=True).stdout.splitlines()
    names = [n.replace("(anonymous namespace)::", "").split("(")[0]
             .removeprefix("void ") for n in names]
    return [f"{n}: {o}" for n, o in zip(names, out)]


def attention_cases():
    # name -> (B, S, T, H, K, hd, causal, kv_len)
    return {
        "prefill llama-130m": (8, 512, 512, 12, 12, 64, True, None),
        "decode kv_len=0": (8, 1, 576, 12, 12, 64, False, 0),
        "decode kv_len=1": (8, 1, 576, 12, 12, 64, False, 1),
        "decode kv_len=300": (8, 1, 576, 12, 12, 64, False, 300),
        "decode kv_len=576": (8, 1, 576, 12, 12, 64, False, 576),
        "rect causal S=64 T=576": (8, 64, 576, 12, 12, 64, True, None),
        "gqa qwen2-500m H=14 K=2": (8, 512, 512, 14, 2, 64, True, None),
        "ragged S=T=37": (8, 37, 37, 12, 12, 64, True, None),
        "hd=128": (4, 512, 512, 8, 8, 128, True, None),
        "hd=256": (2, 512, 512, 8, 1, 256, True, None),
        "eval llama-1b": (16, 256, 256, 32, 32, 64, True, None),
        # the edges of the tensor-core (mma) route
        "S=5 past decode": (8, 5, 5, 12, 12, 64, True, None),
        "ragged S=T=200": (8, 200, 200, 12, 12, 64, True, None),
        "rect causal S=64 T=576 hd=128": (8, 64, 576, 12, 12, 128, True,
                                          None),
        "gqa H=14 K=2 S=T=100 hd=128": (4, 100, 100, 14, 2, 128, True, None),
        "kv_len=300 S=16": (8, 16, 576, 12, 12, 64, False, 300),
        # phase 9's training shapes: llama-7b (mma, hd 128) and gemma-2b
        # (fma, 8 heads of 256 over 1 kv head)
        "train llama-7b hd=128": (16, 256, 256, 32, 32, 128, True, None),
        "train gemma-2b H=8 K=1 hd=256": (16, 256, 256, 8, 1, 256, True, None),
    }


# the wrappers that count launches by route
ROUTED = ("mha_fwd", *BWD_KERNELS, *XENT_KERNELS, "update_apply")


def _routed():
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.xent import xent as X
    return {k: getattr(C if k == "update_apply" else X if k.startswith("xent")
                       else A, k) for k in ROUTED}


def route_counts():
    """{routed wrapper: its launches by route}."""
    return {k: dict(f.route_launches) for k, f in _routed().items()}


def zero_route_counts():
    for f in _routed().values():
        for r in f.route_launches:
            f.route_launches[r] = 0


def check_routes(got, want, what, show=True):
    """``got`` (as route_counts gives it) against ``want``, {wrapper:
    {route: launches}}; a route left out of ``want`` is expected at 0."""
    want = {k: {r: want.get(k, {}).get(r, 0) for r in c}
            for k, c in got.items()}
    if show:
        print(f"  {what}: launches by route {got} (expect {want})")
    if got != want:
        raise AssertionError(f"{what}: routes {got}, not {want}")


def make_qkv(torch, gen, B, S, T, H, K, hd, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hd)


def phase_kernels(torch, gen):
    """Phase 2: mha_fwd against mha_fwd_ref on the card, each case on the
    route ``_fwd_route`` picks; at the eval shape in bf16 also the fma
    kernel that took it before the tensor-core route (phase 4 times it).
    -> max errors."""
    from repro_torch.kernels.attention.attention import (_fwd_route,
                                                         _launch_fwd, mha_fwd)
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    errs = {}
    cases = [(name, shape, dtype, None) for name, shape in
             attention_cases().items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(("eval llama-1b", attention_cases()["eval llama-1b"],
                  torch.bfloat16, "fma"))
    for name, (B, S, T, H, K, hd, causal, kl), dtype, forced in cases:
        q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype)
        kv_len = None if kl is None else torch.tensor(
            kl, dtype=torch.int32, device="cuda")
        route = forced or _fwd_route(q, k, v)
        before = route_counts()
        if forced:
            out, lse = _launch_fwd(forced, q, k, v, kv_len,
                                   hd ** -0.5, causal)
        else:
            out, lse = mha_fwd(q, k, v, kv_len, scale=hd ** -0.5,
                               causal=causal)
        torch.cuda.synchronize()
        after = route_counts()
        fwd = before["mha_fwd"]
        if not forced and after != {**before, "mha_fwd": {
                **fwd, route: fwd[route] + 1}}:
            raise AssertionError(f"mha_fwd {name}: routes {before} -> "
                                 f"{after}, expected one {route}")
        if route == "mma":  # bitwise on a second run
            again = mha_fwd(q, k, v, kv_len, scale=hd ** -0.5, causal=causal)
            if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
                raise AssertionError(f"mha_fwd {name}: a second run differs")
        ref, ref_lse = mha_fwd_ref(q, k, v, kv_len, scale=hd ** -0.5,
                                   causal=causal)
        if dtype == torch.float32:
            atol, rtol = F32_OUT_ATOL, 0.0
        else:
            atol, rtol = BF16_OUT_ATOL, BF16_OUT_RTOL
        d = (out.float() - ref.float()).abs()
        out_ok = bool((d <= atol + rtol * ref.float().abs()).all())
        rows = ref_lse > -1e29  # rows with at least one valid key
        dl = (lse - ref_lse).abs()[rows]
        lse_ok = bool((dl <= LSE_ATOL + LSE_RTOL
                       * ref_lse[rows].abs()).all())
        finite = bool(torch.isfinite(out.float()).all())
        zero_ok = kl != 0 or bool((out == 0).all())
        e_out = d.max().item()
        e_lse = dl.max().item() if dl.numel() else 0.0
        tag = str(dtype).replace("torch.", "")
        print(f"  {name:29s} {tag:8s} {route:6s} out err {e_out:.3e} "
              f"(tol {atol:g} + {rtol:g}|ref|)  lse err {e_lse:.3e} "
              f"(tol {LSE_ATOL:g} + {LSE_RTOL:g}|ref|)")
        if not (out_ok and lse_ok and finite and zero_ok):
            raise AssertionError(f"mha_fwd disagrees with the plain "
                                 f"version: {name} {tag} {route}")
        errs[(name, tag) if not forced else (name, tag, forced)] = e_out
    return errs


def bwd_cases():
    # name -> (B, S, T, H, K, hd, causal, kv_len)
    return {
        "train llama-1b": (16, 256, 256, 32, 32, 64, True, None),
        "gqa qwen2-500m H=14 K=2": (8, 512, 512, 14, 2, 64, True, None),
        "hd=128": (4, 512, 512, 8, 8, 128, True, None),
        "ragged S=T=200": (8, 200, 200, 12, 12, 64, True, None),
        "rect causal S=64 T=576": (8, 64, 576, 12, 12, 64, True, None),
        "kv_len=300 K=4": (8, 16, 576, 12, 4, 64, False, 300),
        "kv_len=0": (8, 16, 576, 12, 12, 64, False, 0),
        # the edges of the tensor-core (mma) route: dK, dV chained over
        # 4 x 1024 query rows, and the hd 128 layout on a ragged tile
        "long gqa S=T=1024 H=8 K=2": (1, 1024, 1024, 8, 2, 64, True, None),
        "hd=128 ragged S=T=200": (2, 200, 200, 4, 4, 128, True, None),
        # a bf16 head the mma route does not take: the fma kernels in bf16
        "hd=32 gqa ragged S=T=200": (4, 200, 200, 8, 4, 32, True, None),
        # gemma-2b's head, 8 query heads over 1 kv head of 256, on the fma
        # kernels: its training shape, the kv_len bound and S != T
        "train llama-7b hd=128": (16, 256, 256, 32, 32, 128, True, None),
        "train gemma-2b H=8 K=1 hd=256": (16, 256, 256, 8, 1, 256, True, None),
        "hd=256 kv_len=300 H=8 K=1": (2, 16, 576, 8, 1, 256, False, 300),
        "hd=256 rect causal S=64 T=576": (2, 64, 576, 8, 1, 256, True, None),
    }


def bwd_fma(torch, name, args, kw):
    """The fma kernel of backward kernel ``name`` on ``bwd_inputs``'s
    ``args``, whatever route the wrapper would take: phase 2 checks it, and
    phase 4 times it, at shapes the mma route takes. Counts nothing."""
    from repro_torch.kernels.attention.attention import _launch_bwd
    q, k, v = args[:3]
    outs = ((torch.empty_like(q),) if name == "mha_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    _launch_bwd(name, "fma", outs, *args, kw["scale"], kw["causal"])
    return outs[0] if name == "mha_bwd_dq" else outs


def bwd_inputs(torch, gen, B, S, T, H, K, hd, causal, kl, dtype):
    """(q, k, v, dout, lse, delta, kv_len) with lse and delta from the plain
    forward, so both sides get the same statistics."""
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    kv_len = None if kl is None else torch.tensor(kl, dtype=torch.int32,
                                                  device="cuda")
    out, lse = mha_fwd_ref(q, k, v, kv_len, scale=hd ** -0.5, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, kv_len


def _bwd_check(torch, name, got, want, tag, key):
    """-> (max abs error, the largest error over its element's tolerance,
    that element's error in ulps of the output dtype at its |ref|: 1 is
    one rounding of the output landing apart, more is drift)."""
    scale = want.float().abs().max().item()
    d = (got.float() - want.float()).abs()
    tol = BWD_SCALE_ATOL[tag] * scale + BWD_RTOL[tag] * want.float().abs()
    if not (bool(torch.isfinite(got.float()).all()) and bool((d <= tol).all())
            and got.dtype == want.dtype and got.shape == want.shape):
        raise AssertionError(f"{name} disagrees with the plain version: {key}, "
                             f"max err {d.max().item():.3e}")
    ratio = (d / tol.clamp_min(1e-30)).flatten()
    i = int(ratio.argmax())
    w = want.flatten()[i:i + 1]
    return (d.max().item(), ratio[i].item(),
            (d.flatten()[i] / ulp(torch, w, want.dtype)[0]).item())


def phase_bwd_kernels(torch, gen):
    """Phase 2: mha_bwd_dq and mha_bwd_dkv against their plain versions on
    the card, each case on the route ``_bwd_route`` picks (counted), each
    run twice (bitwise equal); at the training shape in bf16 also the fma
    kernels that took it before the tensor-core route (phase 4 times
    them). Prints each case's largest error over its element's tolerance,
    which shows the tensor cores' chained sums drifting. -> {(kernel,
    case, dtype[, forced route]): max abs error}."""
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    errs = {}
    cases = [(name, shape, dtype, None) for name, shape in bwd_cases().items()
             for dtype in (torch.bfloat16, torch.float32)]
    cases.append(("train llama-1b", bwd_cases()["train llama-1b"],
                  torch.bfloat16, "fma"))
    for name, (B, S, T, H, K, hd, causal, kl), dtype, forced in cases:
        tag = str(dtype).replace("torch.", "")
        key = f"{name} {tag}"
        args = bwd_inputs(torch, gen, B, S, T, H, K, hd, causal, kl, dtype)
        kw = dict(scale=hd ** -0.5, causal=causal)
        route = forced or _bwd_route(*args[:3])

        def run():
            if forced:
                return (bwd_fma(torch, "mha_bwd_dq", args, kw),
                        *bwd_fma(torch, "mha_bwd_dkv", args, kw))
            return mha_bwd_dq(*args, **kw), *mha_bwd_dkv(*args, **kw)
        before = route_counts()
        dq, dk, dv = run()
        torch.cuda.synchronize()
        after = route_counts()
        if not forced and after != {
                k: {**c, route: c[route] + 1} if k in BWD_KERNELS else c
                for k, c in before.items()}:
            raise AssertionError(f"attention backward {key}: routes {before} "
                                 f"-> {after}, expected one {route} each")
        e_q, r_q, u_q = _bwd_check(torch, "mha_bwd_dq", dq,
                                   mha_bwd_dq_ref(*args, **kw), tag, key)
        want_k, want_v = mha_bwd_dkv_ref(*args, **kw)
        e_k, r_k, u_k = _bwd_check(torch, "mha_bwd_dkv dK", dk, want_k, tag,
                                   key)
        e_v, r_v, u_v = _bwd_check(torch, "mha_bwd_dkv dV", dv, want_v, tag,
                                   key)
        del want_k, want_v
        again = run()
        _bitwise_again(torch, "mha_bwd_dq", dq, again[0], key)
        _bitwise_again(torch, "mha_bwd_dkv", torch.cat(
            [dk.flatten(), dv.flatten()]), torch.cat(
            [again[1].flatten(), again[2].flatten()]), key)
        if kl == 0 and not all(bool((g == 0).all()) for g in (dq, dk, dv)):
            raise AssertionError(f"kv_len=0 gradients are not 0: {key}")
        ek = (name, tag) if not forced else (name, tag, forced)
        errs[("mha_bwd_dq", *ek)] = e_q
        errs[("mha_bwd_dkv", *ek)] = max(e_k, e_v)
        torch.cuda.synchronize()
        mx = [x.float().abs().max().item() for x in (dq, dk, dv)]
        print(f"  {key:35s} {route:3s} dQ err {e_q:.3e}, dK {e_k:.3e}, dV "
              f"{e_v:.3e} (max |dQ|, |dK|, |dV| {mx[0]:.3g}, {mx[1]:.3g}, "
              f"{mx[2]:.3g}; tol {BWD_SCALE_ATOL[tag]:g}max|ref| + "
              f"{BWD_RTOL[tag]:g}|ref|; err/tol at most dQ {r_q:.3f}, dK "
              f"{r_k:.3f}, dV {r_v:.3f}, there {u_q:.3g}, {u_k:.3g}, "
              f"{u_v:.3g} ulps); bitwise repeatable")
        del args, dq, dk, dv, again
    return errs


def ulp(torch, x, dtype):
    """Spacing of ``dtype``'s numbers at |x| (f32 tensor)."""
    mant = 7 if dtype == torch.bfloat16 else 23
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - mant)


def optimizer_shapes():
    # name -> canonical (L, m, n): ragged, odd rows, llama-1b's leaves, and
    # the largest leaves of phase 9's models (llama-7b's stacked MLP leaf,
    # 1.44e9 elements, in bf16 alone: its f32 copies and checks would not
    # fit the card beside each other; gemma-2b's head)
    return {
        "ragged (3,77,129)": (3, 77, 129),
        "(1,5461,2048)": (1, 5461, 2048),
        "w_gate/w_up (24,2048,5461)": (24, 2048, 5461),
        "w_down (24,5461,2048)": (24, 5461, 2048),
        "tok_embed (1,32000,2048)": (1, 32000, 2048),
        "lm_head (1,2048,32000)": (1, 2048, 32000),
        "llama-7b w_gate/w_up (32,4096,11008)": (32, 4096, 11008),
        "gemma-2b lm_head (1,2048,256000)": (1, 2048, 256000),
    }


def _check_ew(torch, name, got, want, scale, dtype, errs, key):
    """got against want within EW_ULPS ulps of dtype at ``scale``."""
    d = (got.float() - want.float()).abs()
    tol = EW_ULPS * ulp(torch, scale, dtype)
    worst = (d / tol).max().item()
    if not (bool(torch.isfinite(got.float()).all()) and worst <= 1.0):
        raise AssertionError(f"{name} disagrees with the plain version: "
                             f"{key}, max err {d.max().item():.3e}, "
                             f"{worst:.2f} x tol")
    errs[key] = max(errs.get(key, 0.0), d.max().item())
    return d.max().item()


def _check_ss(torch, name, got, want, errs, key):
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    if not (bool(torch.isfinite(got).all()) and rel <= SS_RTOL):
        raise AssertionError(f"{name}: sums of squares off by {rel:.3e} "
                             f"relative (tol {SS_RTOL:g}): {key}")
    errs[key] = max(errs.get(key, 0.0), (got - want).abs().max().item())
    return rel


def _bitwise_again(torch, name, first, again, key):
    if not torch.equal(first, again):
        raise AssertionError(f"{name}: a second run on the same inputs "
                             f"differs: {key}")


def phase_optimizer_kernels(torch, gen):
    """Phase 2: the four optimizer kernels against their plain versions.

    -> {(kernel, shape name, dtype): max abs error}.
    """
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as H
    errs = {}
    lr = torch.tensor(0.01, device="cuda")
    for sname, shape in optimizer_shapes().items():
        big = shape[0] * shape[1] * shape[2] > 2**30
        for dtype in (torch.bfloat16, torch.float32)[:1 if big else 2]:
            g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            theta = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            m32 = 0.1 * torch.randn(shape, generator=gen, device="cuda")
            tag = str(dtype).replace("torch.", "")
            for axis in ("col", "row"):
                for gs in (None, 0.37):
                    # gscale and beta by value (Python) and by device pointer
                    gscale = None if gs is None else torch.tensor(
                        gs, device="cuda")
                    beta = 0.9 if gs is None else torch.tensor(
                        0.9, device="cuda")
                    key = f"{sname} {tag} {axis} gscale={gs}"
                    # norm_sumsq
                    ss = C.norm_sumsq(g, axis, gscale=gscale)
                    ss_p = CR.norm_sumsq_ref(g, axis, gscale=gscale)
                    r_ss = _check_ss(torch, "norm_sumsq", ss, ss_p, errs,
                                     ("norm_sumsq", sname, tag))
                    _bitwise_again(torch, "norm_sumsq", ss,
                                   C.norm_sumsq(g, axis, gscale=gscale), key)
                    # norm_apply, in g's dtype and in f32 (the update path)
                    e_na = 0.0
                    for out_dtype in {dtype, torch.float32}:
                        out = C.norm_apply(g, ss_p, axis, gscale=gscale,
                                           out_dtype=out_dtype)
                        want = CR.norm_apply_ref(g, ss_p, axis, gscale=gscale,
                                                 out_dtype=out_dtype)
                        e_na = max(e_na, _check_ew(
                            torch, "norm_apply", out, want, want, out_dtype,
                            errs, ("norm_apply", sname, tag)))
                        _bitwise_again(torch, "norm_apply", out, C.norm_apply(
                            g, ss_p, axis, gscale=gscale,
                            out_dtype=out_dtype), key)
                    # update_apply, in place
                    th = theta.clone()
                    got = C.update_apply(th, g, ss_p, lr, axis,
                                         gscale=gscale)
                    if got is not th or got.data_ptr() != th.data_ptr():
                        raise AssertionError(f"update_apply not in place: "
                                             f"{key}")
                    want = CR.update_apply_ref(theta.clone(), g, ss_p, lr,
                                               axis, gscale=gscale)
                    e_ua = _check_ew(torch, "update_apply", got, want,
                                     torch.maximum(theta.float().abs(),
                                                   want.float().abs()),
                                     dtype, errs, ("update_apply", sname, tag))
                    th2 = theta.clone()
                    C.update_apply(th2, g, ss_p, lr, axis, gscale=gscale)
                    _bitwise_again(torch, "update_apply", got, th2, key)
                    # momentum_sumsq, in place, f32 and bf16 storage
                    e_m = r_m = 0.0
                    for mdt in (torch.float32, torch.bfloat16):
                        m0 = m32.to(mdt)
                        m = m0.clone()
                        got_m, got_ss = H.momentum_sumsq(m, g, beta, axis,
                                                         gscale=gscale)
                        if got_m is not m or got_m.data_ptr() != m.data_ptr():
                            raise AssertionError(f"momentum_sumsq not in "
                                                 f"place: {key}")
                        want_m, want_ss = HR.momentum_sumsq_ref(
                            m0.clone(), g, beta, axis, gscale=gscale)
                        terms = (0.9 * m0.float().abs()
                                 + 0.1 * (gs or 1.0) * g.float().abs())
                        mk = ("momentum_sumsq", sname,
                              f"{tag} m {str(mdt).replace('torch.', '')}")
                        e_m = max(e_m, _check_ew(torch, "momentum_sumsq",
                                                 got_m, want_m, terms, mdt,
                                                 errs, mk))
                        r_m = max(r_m, _check_ss(torch, "momentum_sumsq",
                                                 got_ss, want_ss, errs, mk))
                        m2 = m0.clone()
                        _, ss2 = H.momentum_sumsq(m2, g, beta, axis,
                                                  gscale=gscale)
                        _bitwise_again(torch, "momentum_sumsq", got_m, m2,
                                       key)
                        _bitwise_again(torch, "momentum_sumsq", got_ss, ss2,
                                       key)
                    torch.cuda.synchronize()
                    print(f"  {key:52s} sumsq rel {r_ss:.2e}; norm_apply "
                          f"{e_na:.2e}; update_apply {e_ua:.2e}; momentum "
                          f"{e_m:.2e} (ss rel {r_m:.2e}); in place, "
                          f"bitwise repeatable")
            del g, theta, m32
    return errs


# update_apply's routes (phase 2): (theta dtype, g dtype) and shapes
UPDATE_PAIRS = {"bfloat16 g bfloat16": ("bfloat16", "bfloat16"),
                "bfloat16 g float32": ("bfloat16", "float32"),
                "float32 g float32": ("float32", "float32")}
UPDATE_SHAPES = {"ragged (3,77,129)": (3, 77, 129),
                 "w_gate/w_up (24,2048,5461)": (24, 2048, 5461),
                 "lm_head (1,2048,32000)": (1, 2048, 32000)}


def _on_route(fn, route, call):
    """call() -> its result, checking that it made exactly one launch of
    ``fn`` and that on ``route``."""
    was = dict(fn.route_launches)
    out = call()
    if fn.route_launches != {**was, route: was[route] + 1}:
        raise AssertionError(f"routes {was} -> {fn.route_launches}, expected "
                             f"one {route}")
    return out


def phase_update_routes(torch, gen):
    """Phase 2: update_apply's vec route against its strided route on the
    same values: contiguous at a common offset of 0-7 elements into their
    buffers (vec), and laid out transposed in memory and viewed back
    (strided), bitwise equal; the strided result within EW_ULPS of the
    plain version; vec in place and bitwise repeatable; operands at
    mismatched offsets on strided. -> {(kernel, shape, dtypes): max abs
    error against the plain version}."""
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    fn, errs = C.update_apply, {}
    for sname, (L, m, n) in UPDATE_SHAPES.items():
        def transposed(x):
            t = torch.empty((L, n, m), dtype=x.dtype, device="cuda")
            return t.transpose(1, 2).copy_(x)

        def at(x, off):
            buf = torch.empty(x.numel() + off, dtype=x.dtype, device="cuda")
            return buf[off:].view(x.shape).copy_(x)

        for pname, (tdn, gdn) in UPDATE_PAIRS.items():
            td, gd = getattr(torch, tdn), getattr(torch, gdn)
            theta = torch.randn((L, m, n), generator=gen, device="cuda").to(td)
            g = torch.randn((L, m, n), generator=gen, device="cuda").to(gd)
            key = ("update_apply", sname, pname)
            for axis in ("col", "row"):
                ss = CR.norm_sumsq_ref(g, axis)
                err = 0.0
                for by in ("value", "pointer"):
                    lr, gscale = (0.01, 0.37) if by == "value" else (
                        torch.tensor(0.01, device="cuda"),
                        torch.tensor(0.37, device="cuda"))
                    tag = f"{sname} {pname} {axis}, lr and gscale by {by}"
                    want = CR.update_apply_ref(theta.clone(), g, ss, lr, axis,
                                               gscale=gscale)
                    strided, gt = transposed(theta), transposed(g)
                    _on_route(fn, "strided", lambda: C.update_apply(
                        strided, gt, ss, lr, axis, gscale=gscale))
                    del gt
                    err = max(err, _check_ew(
                        torch, "update_apply", strided, want,
                        torch.maximum(theta.float().abs(), want.float().abs()),
                        td, errs, key))
                    del want
                    for off in range(8):
                        th, gv = at(theta, off), at(g, off)
                        got = _on_route(fn, "vec", lambda: C.update_apply(
                            th, gv, ss, lr, axis, gscale=gscale))
                        if got is not th or not torch.equal(th, strided):
                            raise AssertionError(
                                f"update_apply vec at offset {off} differs "
                                f"from strided or is not in place: {tag}")
                        if off == 0:  # bitwise repeatable
                            th = at(theta, 0)
                            C.update_apply(th, gv, ss, lr, axis, gscale=gscale)
                            if not torch.equal(th, strided):
                                raise AssertionError(f"update_apply vec: a "
                                                     f"second run differs: {tag}")
                    # theta and g at offsets whose 16-byte boundaries differ
                    th, gv = at(theta, 1), at(g, 2)
                    _on_route(fn, "strided", lambda: C.update_apply(
                        th, gv, ss, lr, axis, gscale=gscale))
                    if not torch.equal(th, strided):
                        raise AssertionError(f"update_apply at mismatched "
                                             f"offsets differs: {tag}")
                    del th, gv, strided
                torch.cuda.synchronize()
                print(f"  update_apply {sname:27s} {pname:19s} {axis}: vec at "
                      f"offsets 0-7 bitwise equal to strided (transposed "
                      f"layout) and repeatable, lr and gscale by value and by "
                      f"pointer; mismatched offsets strided; max err "
                      f"{err:.2e} against the plain version (tol {EW_ULPS} "
                      f"ulp)")
            del theta, g
    return errs


def phase_serving(torch, seed, power):
    """Phase 3: greedy serving of llama-130m through the port's entry points."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.models import (forward, init_params, logits_from_hidden)
    from repro_torch.training import (greedy_generate, make_decode_step,
                                      make_prefill_step)
    cfg = get_arch("llama-130m")
    B, P, N = 8, 512, 64
    max_seq = P + N
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, {cfg.num_params() / 1e6:.1f}M "
          f"params; batch {B}, prompt {P}, {N} new tokens")
    greedy_generate(cfg, params, prompt, 2, max_seq)  # warm-up, not counted
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    mha_fwd.launches = 0
    zero_route_counts()
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, N, max_seq)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = mha_fwd.launches
    routes = route_counts()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (1 + (N - 1))
    print(f"  greedy_generate: mha_fwd launches {launches} (expect "
          f"{cfg.n_layers} x (1 + {N - 1}) = {want})")
    if launches != want:
        raise AssertionError(f"mha_fwd launched {launches} times, not {want}")
    # the prompt's prefill on the tensor cores, every decode step on decode
    check_routes(routes, {"mha_fwd": {"mma": cfg.n_layers,
                                      "decode": cfg.n_layers * (N - 1)}},
                 "greedy_generate")
    if out.shape != (B, N) or not bool(((out >= 0)
                                        & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(out.shape)}")

    # the same path step by step, timed, for the per-phase launch counts
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    mha_fwd.launches = 0
    zero_route_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = mha_fwd.launches
    check_routes(route_counts(), {"mha_fwd": {"mma": cfg.n_layers}},
                 "prefill")
    mha_fwd.launches = 0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(N - 1):  # feed back the tokens greedy_generate chose
        state, logits = decode(params, state, out[:, i:i + 1])
    end.record()
    torch.cuda.synchronize()
    decode_ms = start.elapsed_time(end) / (N - 1)
    n_decode = mha_fwd.launches
    if n_prefill + n_decode != launches:
        raise AssertionError("step-by-step launches differ from the run's")

    # last decode step's logits against a full-sequence forward
    seq = torch.cat([prompt, out[:, :N - 1]], dim=1)
    with torch.no_grad():
        h, _, _ = forward(params, cfg, seq)
        ref = logits_from_hidden(params, cfg, h[:, -1:])[:, -1].float()
    got = logits[:, -1].float()
    got, ref = got[:, :cfg.vocab_size], ref[:, :cfg.vocab_size]
    err = (got - ref).abs()
    ok = bool((err <= SERVE_ATOL + SERVE_RTOL * ref.abs()).all())
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    print(f"  last decode logits vs full forward over {seq.shape[1]} tokens: "
          f"max err {err.max().item():.3e} (tol {SERVE_ATOL:g} + "
          f"{SERVE_RTOL:g}|ref|), |ref| max {ref.abs().max().item():.3f}, "
          f"argmax agreement {agree:.3f}, finite "
          f"{bool(torch.isfinite(got).all())}")
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError("serving logits disagree with the full forward")
    print(f"  [{power}] greedy_generate end to end {e2e_s * 1e3:.1f} ms for "
          f"{B * N} tokens ({B * N / e2e_s:.1f} tokens/s)")
    print(f"  [{power}] prefill {prefill_s * 1e3:.2f} ms ({B * P / prefill_s:.0f}"
          f" prompt tokens/s); decode {decode_ms:.3f} ms/step for batch {B} "
          f"({B * 1e3 / decode_ms:.1f} tokens/s)")
    print(f"  [{power}] torch.cuda.max_memory_allocated {peak / 2**20:.1f} MiB")
    return {"launches": launches, "prefill_launches": n_prefill,
            "decode_launches": n_decode, "prefill_ms": prefill_s * 1e3,
            "decode_ms": decode_ms, "mean_kv_len": P + N // 2}


def time_ms(torch, fn, iters, warm=5):
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, n, match=""):
    """Device time per call of the kernels whose name contains ``match``
    (all kernels by default), over ``n`` calls of ``fn`` under
    torch.profiler: the kernels' own time, without the host's launch cost
    that back-to-back CUDA-event timing includes when the host is the
    slower side. In a long process the profiler now and then records
    fewer launches than ran, or none: a session in which some kernel's
    recorded launches are not a multiple of ``n`` is made again (it says
    so), up to three sessions; the last one counts each kernel's mean
    time per recorded launch times its launches per call, rounded where
    that is not 0. None if no session recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type.name == "CUDA" and match in e.key
                   and e.count]
        short = [f"{c} of {k[:50]}" for k, c, _ in kernels if c % n]
        if kernels and not short:
            break
        print(f"  profiler, session {attempt + 1}: recorded "
              f"{', '.join(short) if kernels else 'no device time'} over "
              f"{n} calls")
    total = sum(t / c * (round(c / n) or c / n) for _, c, t in kernels)
    return total / 1e3 if total else None


def fmt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def attention_bound_ms(B, S, T, H, K, hd, causal, kv_len, el_bytes):
    """Least time: max(bytes once / HBM rate, FLOPs / bf16 peak)."""
    keys = kv_len if kv_len is not None else T
    # valid (query, key) pairs; rectangular causal: query i sees keys
    # <= T - S + i
    pairs = S * (T - S) + S * (S + 1) // 2 if causal else S * keys
    flops = 4 * hd * pairs * B * H  # q.k and p.v, 2 FLOPs per MAC
    nbytes = (el_bytes * (B * S * H * hd * 2 + 2 * B * keys * K * hd)
              + 4 * B * H * S)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S), \
        ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
         else "operations")


def phase_timing(torch, gen, power, serve, errs):
    """Phase 4: kernel, plain version and SDPA at the serving shapes, at
    the llama-1b eval step's (its launches are filled in after phase 7) and
    at phase 9's training shapes (llama-7b, gemma-2b).
    Where the tensor-core route runs, the fma kernel that ran these shapes
    before it is timed beside it, in the same run."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (_fwd_route,
                                                         _launch_fwd, mha_fwd)
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    kl = serve["mean_kv_len"]
    shapes = {
        "prefill": ((8, 512, 512, 12, 12, 64, True, None),
                    serve["prefill_launches"], 50, "prefill llama-130m"),
        "decode": ((8, 1, 576, 12, 12, 64, False, kl),
                   serve["decode_launches"], 500, "decode kv_len=300"),
        "eval": ((16, 256, 256, 32, 32, 64, True, None), None, 50,
                 "eval llama-1b"),
        # phase 9's training shapes (their launches are filled in after it)
        "train llama-7b": ((16, 256, 256, 32, 32, 128, True, None), None, 50,
                           "train llama-7b hd=128"),
        "train gemma-2b": ((16, 256, 256, 8, 1, 256, True, None), None, 10,
                           "train gemma-2b H=8 K=1 hd=256"),
    }
    rows = []
    for phase, (shape, launches, iters, err_case) in shapes.items():
        B, S, T, H, K, hd, causal, kv_len = shape
        q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, torch.bfloat16)
        kl_t = None if kv_len is None else torch.tensor(
            kv_len, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        route = _fwd_route(q, k, v)
        ms = time_ms(torch, lambda: mha_fwd(q, k, v, kl_t, scale=scale,
                                            causal=causal), iters)
        dev_ms = device_ms(torch, lambda: mha_fwd(
            q, k, v, kl_t, scale=scale, causal=causal), 10, "mha_fwd")
        fma_ms = fma_dev_ms = None
        if route == "mma":
            def fma():
                return _launch_fwd("fma", q, k, v, kl_t, scale, causal)
            fma_ms = time_ms(torch, fma, max(iters // 5, 5))
            fma_dev_ms = device_ms(torch, fma, 5, "mha_fwd")
        plain_ms = time_ms(torch, lambda: mha_fwd_ref(
            q, k, v, kl_t, scale=scale, causal=causal), max(iters // 10, 5))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if kv_len is not None:
            mask = (torch.arange(T, device="cuda") < kv_len)[None, None, None]

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, is_causal=causal, scale=scale)
        lib_ms = time_ms(torch, sdpa, iters)
        lib_dev_ms = device_ms(torch, sdpa, 10)
        bound, by = attention_bound_ms(B, S, T, H, K, hd, causal, kv_len, 2)
        print(f"  [{power}] mha_fwd {phase} B={B} S={S} T={T} H={H} hd={hd}"
              f"{' kv_len=%d' % kv_len if kv_len is not None else ''}, "
              f"{route} route: {ms:.4f} ms (device time {fmt_ms(dev_ms)}; "
              f"bound {bound:.4f} ms by {by}; plain {plain_ms:.4f} ms; SDPA "
              f"{lib_ms:.4f} ms, device time {fmt_ms(lib_dev_ms)})"
              + ("" if fma_ms is None else f"; the fma kernel at this shape "
                 f"{fma_ms:.4f} ms (device time {fmt_ms(fma_dev_ms)})"))
        rows.append({"name": "mha_fwd", "shape": phase, "route": "cuda",
                     "kernel_route": route,
                     "source": SRC_MHA, "replaces": TPU_MHA,
                     "launches": launches,
                     "max_abs_err": errs[(err_case, "bfloat16")],
                     "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                     "library_device_ms": lib_dev_ms, "fma_ms": fma_ms,
                     "fma_device_ms": fma_dev_ms})
    return rows


def bwd_bound_ms(B, S, T, H, K, hd, causal, kv_len, el_bytes, kernel):
    """Least time of an attention backward kernel: max(bytes once / HBM
    rate, FLOPs / bf16 peak). dQ: s, dp and ds.k, three products per valid
    (query, key) pair; dK, dV: four. Both read q, k, v, dout, lse and delta;
    dQ writes dQ, the other dK and dV."""
    keys = kv_len if kv_len is not None else T
    pairs = S * (T - S) + S * (S + 1) // 2 if causal else S * keys
    flops = (3 if kernel == "mha_bwd_dq" else 4) * 2 * hd * pairs * B * H
    q_el, kv_el = B * S * H * hd, B * T * K * hd
    nbytes = el_bytes * (2 * q_el + 2 * B * keys * K * hd) + 2 * 4 * B * H * S
    nbytes += el_bytes * (q_el if kernel == "mha_bwd_dq" else 2 * kv_el)
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def bwd_timing(torch, gen, power, errs):
    """Phase 4, the backward kernels at the training step's shape (llama-1b:
    B=16, S=T=256, 32 heads of 64, causal, bf16), at qwen2-500m's GQA
    shape (B=8, S=T=512, 14 heads over 2 kv heads of 64), and at phase 9's
    llama-7b (32 heads of 128) and gemma-2b (B=16, S=T=256, 8 heads over 1
    kv head of 256, the fma route): each
    kernel on its route by CUDA events and by device time (torch.profiler),
    where the mma route runs the fma kernel that took these shapes before
    it beside it in the same run, the plain version, the bound, and the
    library route (the backward of F.scaled_dot_product_attention: dQ, dK
    and dV together, in its own (B, H, S, hd) layout). -> one row per
    kernel, its training shape's numbers on top and every shape under
    "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    shapes = {"train": ((16, 256, 256, 32, 32, 64), "train llama-1b"),
              "gqa": ((8, 512, 512, 14, 2, 64), "gqa qwen2-500m H=14 K=2"),
              "llama-7b": ((16, 256, 256, 32, 32, 128),
                           "train llama-7b hd=128"),
              "gemma-2b": ((16, 256, 256, 8, 1, 256),
                           "train gemma-2b H=8 K=1 hd=256")}
    note = "backward of F.scaled_dot_product_attention (dQ, dK, dV together)"
    rows = {name: [] for name in BWD_KERNELS}
    for shape, ((B, S, T, H, K, hd), err_case) in shapes.items():
        args = bwd_inputs(torch, gen, B, S, T, H, K, hd, True, None,
                          torch.bfloat16)
        kw = dict(scale=hd ** -0.5, causal=True)
        q, k, v, do = args[:4]
        route = _bwd_route(q, k, v)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           scale=hd ** -0.5,
                                           enable_gqa=K != H)
        dot = do.transpose(1, 2).contiguous()

        def sdpa_bwd():
            return torch.autograd.grad(o, [qt, kt, vt], dot,
                                       retain_graph=True)
        lib_ms = time_ms(torch, sdpa_bwd, 20)
        lib_dev_ms = device_ms(torch, sdpa_bwd, 10)
        for name, kern, plain in (("mha_bwd_dq", mha_bwd_dq, mha_bwd_dq_ref),
                                  ("mha_bwd_dkv", mha_bwd_dkv,
                                   mha_bwd_dkv_ref)):
            def call():
                return kern(*args, **kw)

            def fma():
                return bwd_fma(torch, name, args, kw)
            ms = time_ms(torch, call, 20)
            dev_ms = device_ms(torch, call, 10, name)
            fma_ms = fma_dev_ms = None
            if route == "mma":  # the kernel that took the shape before
                fma_ms = time_ms(torch, fma, 5)
                fma_dev_ms = device_ms(torch, fma, 5, name)
            plain_ms = time_ms(torch, lambda: plain(*args, **kw), 5)
            bound, by = bwd_bound_ms(B, S, T, H, K, hd, True, None, 2, name)
            print(f"  [{power}] {name} {shape} B={B} S={S} T={T} H={H} K={K} "
                  f"hd={hd} causal bf16, {route} route: {ms:.4f} ms (device "
                  f"time {fmt_ms(dev_ms)}; bound {bound:.4f} ms by {by}"
                  + ("" if fma_ms is None else f"; the fma kernel at this "
                     f"shape {fma_ms:.4f} ms, device time "
                     f"{fmt_ms(fma_dev_ms)}")
                  + f"; plain {plain_ms:.4f} ms; {note} {lib_ms:.4f} ms, "
                  f"device time {fmt_ms(lib_dev_ms)})")
            rows[name].append({
                "name": name, "shape": f"{shape}: B={B} S={S} T={T} H={H} "
                f"K={K} hd={hd} causal bf16", "route": "cuda",
                "kernel_route": route, "source": SRC_MHA_BWD,
                "replaces": TPU_KERNELS[name], "launches": None,
                "max_abs_err": errs[(name, err_case, "bfloat16")],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms, "library_note": note,
                "fma_ms": fma_ms, "fma_device_ms": fma_dev_ms})
        del args, q, k, v, do, qt, kt, vt, o, dot
    out = []
    for name in BWD_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out


def update_call(torch, lib, route, theta, g, ss, lr):
    """A call of a colnorm library's update_apply C entry for ``route``
    ("vec" with this tree's split, or "strided") on these tensors, col,
    with no gscale."""
    from repro_torch.kernels.colnorm import colnorm as C
    L, m, n = theta.shape
    lr_p, lr_v = C.scalar_arg(lr, "lr", theta.device)
    T, G = C._DTYPES[theta.dtype], C._DTYPES[g.dtype]
    if route == "vec":
        split = C.vec_split(theta.numel(), C.vec_head(theta, g),
                            C.vec_width(theta, g))
        entry, args = lib.update_apply_vec, (
            theta.data_ptr(), T, g.data_ptr(), G, ss.data_ptr(), L, m, n, 0,
            *split, lr_p, lr_v, None, 1.0, C.EPS)
    else:
        entry, args = lib.update_apply, (
            theta.data_ptr(), T, *theta.stride(), g.data_ptr(), G,
            *g.stride(), ss.data_ptr(), L, m, n, 0, lr_p, lr_v, None, 1.0,
            C.EPS)

    def call():
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"update_apply ({route}): CUDA error {err}")
    return call


def update_timing(torch, gen, power, errs, procs, row, theta, g, ss, lr):
    """Phase 4, update_apply beyond its w_gate row: at the head (bf16
    theta, f32 m', as head_update_apply calls it) against its bound and
    addcdiv_; at w_gate, in turns there and back, the vec kernel, the
    strided kernel on the same bytes and the "update loads and stores only"
    variant, by CUDA events and by device time. Adds them to ``row``."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    head = (1, 2048, 32000)
    th = torch.randn(head, generator=gen, device="cuda").to(torch.bfloat16)
    m = 1e-3 * torch.randn(head, generator=gen, device="cuda")
    ss_h = C.norm_sumsq(m, "col")
    denom = torch.sqrt(ss_h) + 1e-8
    nh = th.numel()
    nbytes = (2 + 2 + 4) * nh + 4 * head[2]
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    kern = lambda: C.update_apply(th, m, ss_h, lr, "col")  # noqa: E731
    lib = lambda: th.addcdiv_(m, denom, value=-1e-6)  # noqa: E731
    if C._route(th, m) != "vec":
        raise AssertionError("update_apply at the head is not on vec")
    ms = time_ms(torch, kern, 50)
    plain_ms = time_ms(torch, lambda: CR.update_apply_ref(
        th, m, ss_h, lr, "col"), 10)
    lib_ms = time_ms(torch, lib, 50)
    turns = [device_ms(torch, f, 20) for f in (kern, lib, lib, kern)]
    dev = tuple(None if None in pair else sum(pair) / 2
                for pair in ((turns[0], turns[3]), (turns[1], turns[2])))
    print(f"  [{power}] update_apply lm_head (1,2048,32000) bf16 theta, f32 "
          f"m', col, vec: {ms:.4f} ms (bound {bound:.4f} ms by bytes, "
          f"{nbytes / 1e6:.1f} MB, {bound / ms:.3f} of it; plain "
          f"{plain_ms:.4f} ms; theta.addcdiv_(m, sqrt(ss)+eps, value=-lr) "
          f"{lib_ms:.4f} ms); device time in turns (kernel, library, "
          f"library, kernel) {', '.join(fmt_ms(t) for t in turns)}")
    row["shapes"] = [
        {k: row[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                             "library_ms", "device_ms", "library_device_ms",
                             "max_abs_err")},
        {"shape": "lm_head (1,2048,32000) theta bf16, m' f32", "ms": ms,
         "plain_ms": plain_ms, "bound_ms": bound, "library_ms": lib_ms,
         "device_ms": dev[0], "library_device_ms": dev[1],
         "max_abs_err": errs[("update_apply", "lm_head (1,2048,32000)",
                              "bfloat16 g float32")]}]
    del th, m, ss_h, denom
    # w_gate: the two routes and the variant on the same bytes, in turns
    lib = C._bind(_build.library("colnorm"))
    var = C._bind(_variant_lib(procs, "update loads and stores only"))
    calls = {"vec": update_call(torch, lib, "vec", theta, g, ss, lr),
             "strided": update_call(torch, lib, "strided", theta, g, ss, lr),
             "loads and stores only": update_call(torch, var, "vec", theta,
                                                  g, ss, lr)}
    order = list(calls) + list(calls)[::-1]
    ev, dv = {k: [] for k in calls}, {k: [] for k in calls}
    for k in order:
        ev[k].append(time_ms(torch, calls[k], 20))
    for k in order:
        dv[k].append(device_ms(torch, calls[k], 20))
    res = {}
    for k in calls:
        e = sum(ev[k]) / 2
        d = None if None in dv[k] else sum(dv[k]) / 2
        res[k] = {"ms": e, "device_ms": d, "runs": ev[k], "device_runs": dv[k]}
        print(f"  [{power}] update_apply w_gate bf16 col, {k}: {e:.4f} ms "
              f"(events, {' and '.join(f'{x:.4f}' for x in ev[k])}), device "
              f"{fmt_ms(d)} ({', '.join(fmt_ms(x) for x in dv[k])}); "
              f"{row['bound_ms'] / e:.3f} of the {row['bound_ms']:.4f} ms "
              f"bound")
    v, st = res["vec"], res["strided"]
    print(f"  [{power}] update_apply w_gate: vec {st['ms'] / v['ms']:.2f}x "
          f"the strided kernel by events" + (
              "" if None in (v["device_ms"], st["device_ms"]) else
              f", {st['device_ms'] / v['device_ms']:.2f}x by device time"))
    row["kernel_route"] = "vec"
    row["variants"] = res


def optimizer_timing(torch, gen, power, errs, procs):
    """Phase 4, optimizer kernels at their largest llama-1b shapes (bf16
    operands, col as on the main path): kernel, plain version, bound by
    bytes and one PyTorch library call doing the same work; update_apply
    also as ``update_timing`` says."""
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as H
    big, head = (24, 2048, 5461), (1, 2048, 32000)
    bf = torch.bfloat16
    g = torch.randn(big, generator=gen, device="cuda").to(bf)
    theta = torch.randn(big, generator=gen, device="cuda").to(bf)
    ss = C.norm_sumsq(g, "col")
    denom = torch.sqrt(ss) + 1e-8  # the library calls' divisor, f32
    lr = torch.tensor(1e-6, device="cuda")
    n, L, cols = g.numel(), big[0], big[2]
    gh = torch.randn(head, generator=gen, device="cuda").to(bf)
    m = 1e-3 * torch.randn(head, generator=gen, device="cuda")
    gh32 = gh.float()  # lerp_ takes its end in m's dtype
    nh = gh.numel()
    cases = [
        # name, shape name, bytes moved once, kernel, plain, library, note
        ("norm_sumsq", "w_gate/w_up (24,2048,5461)", 2 * n + 4 * L * cols,
         lambda: C.norm_sumsq(g, "col"),
         lambda: CR.norm_sumsq_ref(g, "col"),
         lambda: torch.linalg.vector_norm(g, dim=1, keepdim=True,
                                          dtype=torch.float32),
         "torch.linalg.vector_norm(dim=1, dtype=float32)"),
        ("update_apply", "w_gate/w_up (24,2048,5461)",
         3 * 2 * n + 4 * L * cols,
         lambda: C.update_apply(theta, g, ss, lr, "col"),
         lambda: CR.update_apply_ref(theta, g, ss, lr, "col"),
         lambda: theta.addcdiv_(g, denom, value=-1e-6),
         "theta.addcdiv_(g, sqrt(ss)+eps, value=-lr)"),
        ("norm_apply", "w_gate/w_up (24,2048,5461)",
         (2 + 4) * n + 4 * L * cols,
         lambda: C.norm_apply(g, ss, "col", out_dtype=torch.float32),
         lambda: CR.norm_apply_ref(g, ss, "col", out_dtype=torch.float32),
         lambda: torch.div(g, denom),
         "torch.div(g, sqrt(ss)+eps) -> float32"),
        ("momentum_sumsq", "lm_head (1,2048,32000)",
         (4 + 2 + 4) * nh + 4 * head[2],
         lambda: H.momentum_sumsq(m, gh, 0.9, "col"),
         lambda: HR.momentum_sumsq_ref(m, gh, 0.9, "col"),
         lambda: m.lerp_(gh32, 0.1),
         "m.lerp_(g, 1-beta), EMA only, g in f32"),
    ]
    rows = []
    for name, sname, nbytes, kern, plain, lib, lib_note in cases:
        src = SRC_MOMENTUM if name == "momentum_sumsq" else SRC_COLNORM
        ms = time_ms(torch, kern, 50)
        plain_ms = time_ms(torch, plain, 10)
        lib_ms = time_ms(torch, lib, 50)
        # kernel and library call also by device time, in turns (kernel,
        # library, library, kernel), so that the card's drift falls on both
        turns = [device_ms(torch, f, 20) for f in (kern, lib, lib, kern)]
        k1, l1, l2, k2 = turns
        dev = tuple(None if None in pair else sum(pair) / 2
                    for pair in ((k1, k2), (l1, l2)))
        bound = 1e3 * nbytes / HBM_BYTES_PER_S
        # phase 2's error at this shape and these dtypes (bf16 g; the
        # head's momentum in f32)
        dts = "bfloat16 m float32" if name == "momentum_sumsq" else "bfloat16"
        err = errs[(name, sname, dts)]
        print(f"  [{power}] {name} {sname} bf16 col: {ms:.4f} ms (bound "
              f"{bound:.4f} ms by bytes, {nbytes / 1e6:.1f} MB, "
              f"{bound / ms:.3f} of it; "
              f"{nbytes / ms / 1e6:.0f} GB/s; plain {plain_ms:.4f} ms; "
              f"{lib_note} {lib_ms:.4f} ms)" + (
                  "" if None in dev else
                  f"; device time in turns (kernel, library, library, "
                  f"kernel) {', '.join(fmt_ms(t) for t in turns)}: kernel "
                  f"{dev[0] / dev[1]:.3f}x the library"))
        rows.append({"name": name, "shape": sname, "route": "cuda",
                     "source": src, "replaces": TPU_KERNELS[name],
                     "launches": None, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "bytes", "library_ms": lib_ms,
                     "device_ms": dev[0], "library_device_ms": dev[1]})
    update_timing(torch, gen, power, errs, procs, rows[1], theta, g, ss, lr)
    return rows


def phase_profile(torch, seed, power, serve):
    """Phase 5: device busy time of one prefill and of decode steps.

    torch.profiler (CUPTI) sums the kernels' device time; the idle share
    is taken against the untraced times of phase 3.
    """
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.training import make_decode_step, make_prefill_step
    cfg = get_arch("llama-130m")
    B, P, steps = 8, 512, 8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, P + 64)
    decode = make_decode_step(cfg)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for phase, n in (("prefill", 1), ("decode", steps)):
        state, logits = prefill(params, prompt)
        tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            if phase == "prefill":
                prefill(params, prompt)
            else:
                for _ in range(n):
                    state, logits = decode(params, state, tok)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
        untraced = serve["prefill_ms"] if phase == "prefill" \
            else serve["decode_ms"]
        if busy_ms == 0:
            print(f"  {phase}: the profiler recorded no device time "
                  "(device busy share not measured)")
            continue
        print(f"  [{power}] {phase}: device busy {busy_ms:.3f} ms per "
              f"{'step' if n > 1 else 'call'} of {untraced:.3f} ms untraced "
              f"(idle share {1 - busy_ms / untraced:.3f}); "
              f"{sum(e.count for e in kernels) // n} kernel launches")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        for e in top:
            print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
                  f"x{e.count // n:<4d} {e.key[:90]}")


def counts():
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    return {"norm_sumsq": C.norm_sumsq.launches,
            "update_apply": C.update_apply.launches,
            "norm_apply": C.norm_apply.launches,
            "momentum_sumsq": H.momentum_sumsq.launches}


def zero_counts():
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    for fn in (C.norm_sumsq, C.update_apply, C.norm_apply, H.momentum_sumsq):
        fn.launches = 0


def step_bytes(params, labels):
    """Bytes an update_params step of SCALE must move (each once): a
    stateless matrix reads g twice (sums of squares, apply) and theta once
    and writes theta; the head reads g, reads and writes the f32 momentum,
    reads it again and reads and writes theta; an Adam vector reads g,
    reads and writes theta and both f32 moments."""
    total = 0
    for k, p in params.items():
        n, b = p.numel(), p.element_size()
        total += n * {"vector": 3 * b + 16, "last": 3 * b + 12}.get(
            labels[k], 4 * b)
    return total


def profile_step(torch, power, step, untraced_ms, n=3,
                 label="update_params step", top=8):
    """Device busy time and top kernels of ``n`` calls of ``step``
    (torch.profiler), and the update_apply kernels' sum where they ran; the
    idle share is against the untraced step time. -> (busy ms per call or
    None, [(kernel, launches per call, device ms per call)])."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        print("  the profiler recorded no device time (busy share not "
              "measured)")
        return None, []
    print(f"  [{power}] {label}: device busy {busy_ms:.3f} ms of "
          f"{untraced_ms:.3f} ms untraced (idle share "
          f"{1 - busy_ms / untraced_ms:.3f}); "
          f"{sum(e.count for e in kernels) // n} kernel launches")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3 / n:8.3f} ms "
              f"x{e.count // n:<4d} {e.key[:90]}")
    ua = [e for e in kernels if "update_apply" in e.key]
    if ua:  # both update_apply kernels (the head's may miss the top)
        print(f"  [{power}] {label}: update_apply kernels "
              f"{sum(e.self_device_time_total for e in ua) / 1e3 / n:.3f} ms "
              f"of device time, {sum(e.count for e in ua) // n} launches")
    return busy_ms, [(e.key, e.count / n, e.self_device_time_total / 1e3 / n)
                     for e in kernels]


def phase_optimizer(torch, seed, power):
    """Phase 6: SCALE optimizer steps of llama-1b at full width and depth."""
    from repro_torch.configs import get_arch
    from repro_torch.core import (apply_updates, global_norm, label_tree,
                                  linear_warmup_cosine, make_optimizer)
    from repro_torch.core import pipeline
    from repro_torch.models import init_params
    from repro_torch.models.model import flatten
    cfg = get_arch("llama-1b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = {k: p.detach() for k, p in
              flatten(init_params(cfg, gen, device="cuda")).items()}
    grads = {k: torch.randn(p.shape, generator=gen, device="cuda").to(p.dtype)
             for k, p in params.items()}
    labels = label_tree(params, require_last=True)
    n_el = sum(p.numel() for p in params.values())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; {len(params)} "
          f"leaves, {n_el / 1e9:.3f} G params; labels "
          f"{sorted(set(labels.values()))}")
    # the trainer's clip: gscale = min(1, clip / (|g| + 1e-9)), clip 1.0
    gnorm = global_norm(grads)
    gscale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
    # update() takes no grad_scale: the trainer scales the tree, and JAX
    # promotes bf16 * f32 to f32
    scaled = {k: pipeline.jax_mul(g, gscale) for k, g in grads.items()}
    sched = linear_warmup_cosine(1e-3, 1000)
    fused = make_optimizer("scale_fused", sched, lr_scaling=True)
    plain = make_optimizer("scale", sched, lr_scaling=True)
    pf = {k: p.clone() for k, p in params.items()}
    pr = {k: p.clone() for k, p in params.items()}
    sf, sr = fused.init(pf), plain.init(pr)
    torch.cuda.synchronize()
    expect = {"update_params": {"norm_sumsq": 8, "update_apply": 9,
                                "norm_apply": 0, "momentum_sumsq": 1},
              "update": {"norm_sumsq": 8, "update_apply": 0,
                         "norm_apply": 9, "momentum_sumsq": 1}}
    # every update_apply on the vec route
    expect_r = {"update_params": {"update_apply": {"vec": 9}}, "update": {}}

    def step(tx, p, s, entry):
        if entry == "update_params":
            return tx.update_params(grads, s, p, grad_scale=gscale)
        u, s = tx.update(scaled, s, p)
        return apply_updates(p, u), s

    entries = ["update_params"] * 3 + ["update"] * 3
    # the main path: counts set to 0 just before it, read just after
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    zero_route_counts()
    per_step = []
    for entry in entries:
        before, before_r = counts(), route_counts()
        pf, sf = step(fused, pf, sf, entry)
        per_step.append((entry, {k: v - before[k]
                                 for k, v in counts().items()},
                         {k: {r: n - before_r[k][r] for r, n in c.items()}
                          for k, c in route_counts().items()}))
    torch.cuda.synchronize()
    launches = counts()
    peak_mem = torch.cuda.max_memory_allocated()
    for i, (entry, c, r) in enumerate(per_step):
        print(f"  step {i} {entry:13s} launches {c}; update_apply by route "
              f"{r['update_apply']}")
        if c != expect[entry]:
            raise AssertionError(f"step {i} ({entry}) launched {c}, not "
                                 f"{expect[entry]}")
        check_routes(r, expect_r[entry], f"step {i} ({entry})", show=False)
    print(f"  launches over the six steps: {launches}")

    # the same six steps on the plain jnp route, tracking each element's
    # peak |theta| or |step| for the per-element bound
    peak = {k: p.float().abs() for k, p in pr.items()}
    for entry in entries:
        old = {k: p.clone() for k, p in pr.items()}
        pr, sr = step(plain, pr, sr, entry)
        for k, p in pr.items():
            peak[k] = torch.maximum(peak[k], torch.maximum(
                p.float().abs(), (p.float() - old[k].float()).abs()))
        del old
    worst, changed, moved = 0.0, 0, 0
    for k, p in pf.items():
        d = (p.float() - pr[k].float()).abs()
        worst = max(worst, (d / ulp(torch, peak[k], p.dtype)).max().item())
        changed += int((d > 0).sum())
        moved += int((pr[k] != params[k]).sum())
        if not bool(torch.isfinite(p.float()).all()):
            raise AssertionError(f"non-finite params in {k}")
    mf, mr = sf.mu["lm_head/w"], sr.mu["lm_head/w"]
    m_rel = ((mf - mr).abs().max() / mr.abs().max()).item()
    print(f"  fused vs jnp after 6 steps: params differ in {changed} of "
          f"{n_el} elements, at most {worst:.2f} bf16 ulps of the element's "
          f"peak (bound {STEP_ULPS}); {moved} elements moved from their "
          f"start; lm_head momentum max err {m_rel:.3e} of max |m| (bound "
          f"{MOMENTUM_RTOL:g}); count {int(sf.count)} / {int(sr.count)}")
    if worst > STEP_ULPS or m_rel > MOMENTUM_RTOL or int(sf.count) != 6:
        raise AssertionError("impl='fused' and impl='jnp' disagree")
    del pr, sr, peak

    # one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pf, sf = fused.update_params(grads, sf, pf, grad_scale=gscale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  update_params under set_sync_debug_mode('error'): no host "
          "synchronisation")

    nbytes = step_bytes(pf, labels)
    bound = 1e3 * nbytes / HBM_BYTES_PER_S
    t_fused = time_ms(torch, lambda: fused.update_params(
        grads, sf, pf, grad_scale=gscale), 10)
    t_upd = time_ms(torch, lambda: apply_updates(pf, fused.update(
        scaled, sf, pf)[0]), 5)
    pr = {k: p.clone() for k, p in params.items()}
    sr = plain.init(pr)
    t_plain = time_ms(torch, lambda: plain.update_params(
        grads, sr, pr, grad_scale=gscale), 3)
    print(f"  [{power}] update_params step: fused {t_fused:.3f} ms "
          f"({nbytes / t_fused / 1e6:.0f} GB/s), jnp {t_plain:.3f} ms; bound "
          f"{bound:.3f} ms ({nbytes / 1e9:.3f} GB by bytes)")
    print(f"  [{power}] update + apply_updates step (fused): {t_upd:.3f} ms")
    profile_step(torch, power, lambda: fused.update_params(
        grads, sf, pf, grad_scale=gscale), t_fused)
    print(f"  [{power}] torch.cuda.max_memory_allocated over the six steps "
          f"{peak_mem / 2**20:.1f} MiB")
    return {"launches": launches, "step_ms": t_fused, "bound_ms": bound}


# ------------------------------------------------------- the loss path


def xent_counts():
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.xent import xent as X
    return {"mha_fwd": mha_fwd.launches,
            **{k: getattr(X, k).launches for k in XENT_KERNELS}}


def zero_xent_counts():
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.xent import xent as X
    for fn in (mha_fwd, *(getattr(X, k) for k in XENT_KERNELS)):
        fn.launches = 0


def xent_cases():
    # name -> (N, D, V, vocab_size, share of -1 labels)
    return {
        "llama-1b N=4096": (4096, 2048, 32000, 32000, 0.0),
        "N=1": (1, 2048, 32000, 32000, 0.0),
        "N=4097 vocab_size=31990": (4097, 2048, 32000, 31990, 0.1),
        "all labels -1": (300, 2048, 32000, 32000, 1.0),
        # D not a multiple of the tensor-core backward's K-tile of 32
        "D=80": (300, 80, 1000, 1000, 0.2),
        # chunk_plan cuts the vocabulary into 32 chunks of 1024
        "N=16384": (16384, 2048, 32000, 32000, 0.0),
        # and the tokens into two chunks (dW summed across them)
        "N=140000 D=16 V=128": (140000, 16, 128, 128, 0.1),
        # one 128 x 256 tile of the wgmma forward, h and w exactly 64 x 64
        # and 64 x 256; one row with ragged K and vocab tiles
        "single tile N=64 D=64 V=256": (64, 64, 256, 256, 0.0),
        "N=1 D=96 V=264 vocab_size=260": (1, 96, 264, 260, 0.0),
        # llama-7b's loss: D = 4096, two slabs of D on the FMA kernels
        "llama-7b N=4096 D=4096": (4096, 4096, 32000, 32000, 0.0),
        # a D that ends the FMA kernels' last slab mid-way (not a multiple
        # of 16: bf16 takes the FMA kernels too)
        "D=4100": (300, 4100, 1000, 1000, 0.2),
        # gemma-2b's loss: V = 256000, 4 splits of the forward, 63 chunks
        # of the backward
        "gemma-2b N=4096 V=256000": (4096, 2048, 256000, 256000, 0.05),
    }


def xent_inputs(torch, gen, N, D, V, masked, dtype):
    h = torch.randn((N, D), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((D, V), generator=gen, device="cuda")
         / D ** 0.5).to(dtype)
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    drop = torch.rand((N,), generator=gen, device="cuda") < masked
    labels = torch.where(drop, -1, labels)
    gl = torch.rand((N,), generator=gen, device="cuda")
    return h, w, labels, gl


def _grad_check(torch, name, got, want, dtype, key):
    """-> (max abs error, the largest error over its element's
    tolerance)."""
    scale = want.float().abs().max().item()
    tag = str(dtype).replace("torch.", "")
    d = (got.float() - want.float()).abs()
    tol = XENT_GRAD_SCALE_ATOL * scale + XENT_GRAD_RTOL[tag] * want.float().abs()
    ok = bool(torch.isfinite(got.float()).all()) and bool((d <= tol).all())
    if not ok:
        raise AssertionError(f"{name} disagrees with the plain version: {key}, "
                             f"max err {d.max().item():.3e}")
    return d.max().item(), (d / tol.clamp_min(1e-30)).max().item()


def phase_xent_kernels(torch, gen):
    """Phase 2: the three xent kernels against their plain versions, each
    run twice (bitwise equal), on the route its wrapper picks (counted:
    ``wgmma`` for the forward and ``mma`` for the backward on aligned bf16,
    ``fma`` for f32 and for w read through its columns). Prints each
    backward output's largest error over its element's tolerance.
    -> {(kernel, case, dtype): max abs error}."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    errs = {}
    for cname, (N, D, V, vs, masked) in xent_cases().items():
        for dtype in (torch.bfloat16, torch.float32):
            tag = str(dtype).replace("torch.", "")
            key = f"{cname} {tag}"
            h, w, labels, gl = xent_inputs(torch, gen, N, D, V, masked, dtype)
            # aligned bf16 on the tensor cores; f32 and a D that is not a
            # multiple of 16 on the FMA kernels
            tc = dtype == torch.bfloat16 and D % 16 == 0
            fwd_route = "wgmma" if tc else "fma"
            was = dict(X.xent_fwd.route_launches)
            lse, ll = X.xent_fwd(h, w, labels, vocab_size=vs)
            torch.cuda.synchronize()
            if X.xent_fwd.route_launches != {**was, fwd_route:
                                             was[fwd_route] + 1}:
                raise AssertionError(f"xent_fwd: routes {was} -> "
                                     f"{X.xent_fwd.route_launches}, expected "
                                     f"one {fwd_route}: {key}")
            want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, vocab_size=vs)
            e_f = 0.0
            for got, want in ((lse, want_lse), (ll, want_ll)):
                d = (got - want).abs()
                if not (bool(torch.isfinite(got).all()) and bool(
                        (d <= XENT_LSE_ATOL + XENT_LSE_RTOL
                         * want.abs()).all())):
                    raise AssertionError(f"xent_fwd disagrees with the plain "
                                         f"version: {key}")
                e_f = max(e_f, d.max().item())
            bad = (labels < 0) | (labels >= vs)
            if not bool((ll[bad] == 0).all()):
                raise AssertionError(f"xent_fwd: ll of a masked label is not "
                                     f"0: {key}")
            _bitwise_again(torch, "xent_fwd", torch.stack([lse, ll]),
                           torch.stack(X.xent_fwd(h, w, labels,
                                                  vocab_size=vs)), key)
            errs[("xent_fwd", cname, tag)] = e_f
            msg = [f"fwd {fwd_route} {e_f:.2e}"]
            if X.mma_layout(h, w) != tc:
                raise AssertionError(f"xent_fwd: unexpected kernel for {key}")
            # the FMA kernels, which other bf16 layouts take
            w_cols = w.T.contiguous().T if tc else None
            if tc:
                e_fma = 0.0
                was = dict(X.xent_fwd.route_launches)
                got_cols = X.xent_fwd(h, w_cols, labels, vocab_size=vs)
                if X.xent_fwd.route_launches != {**was, "fma": was["fma"] + 1}:
                    raise AssertionError(f"xent_fwd: w_cols did not take the "
                                         f"fma route: {key}")
                for got, want in zip(got_cols, (want_lse, want_ll)):
                    d = (got - want).abs()
                    if not bool((d <= XENT_LSE_ATOL + XENT_LSE_RTOL
                                 * want.abs()).all()):
                        raise AssertionError(f"xent_fwd (FMA kernel) "
                                             f"disagrees: {key}")
                    e_fma = max(e_fma, d.max().item())
                msg.append(f"fwd FMA kernel {e_fma:.2e}")
            route = "mma" if tc else "fma"
            for name, fn, ref in (("xent_bwd_dh", X.xent_bwd_dh,
                                   XR.xent_bwd_dh_ref),
                                  ("xent_bwd_dw", X.xent_bwd_dw,
                                   XR.xent_bwd_dw_ref)):
                e = e_fma = 0.0
                r, r_fma = {}, {}  # err/tol by out dtype
                for out_dtype in (dtype, torch.float32)[:1 + (
                        dtype != torch.float32)]:
                    otag = str(out_dtype).replace("torch.", "")
                    args = (h, w, labels, want_lse, gl)
                    was = dict(fn.route_launches)
                    got = fn(*args, vocab_size=vs, out_dtype=out_dtype)
                    if fn.route_launches != {**was, route: was[route] + 1}:
                        raise AssertionError(f"{name}: routes {was} -> "
                                             f"{fn.route_launches}, expected "
                                             f"one {route}: {key}")
                    want = ref(*args, vocab_size=vs, out_dtype=out_dtype)
                    if got.dtype != out_dtype or got.shape != want.shape:
                        raise AssertionError(f"{name}: {got.dtype} "
                                             f"{tuple(got.shape)}: {key}")
                    e1, r[otag] = _grad_check(torch, name, got, want,
                                              out_dtype, key)
                    e = max(e, e1)
                    _bitwise_again(torch, name, got, fn(
                        *args, vocab_size=vs, out_dtype=out_dtype), key)
                    if name == "xent_bwd_dw" and not bool(
                            (got[:, vs:] == 0).all()):
                        raise AssertionError(f"xent_bwd_dw: padded columns "
                                             f"not 0: {key}")
                    if w_cols is not None:
                        was = dict(fn.route_launches)
                        e1, r_fma[otag] = _grad_check(
                            torch, f"{name} (FMA kernel)",
                            fn(h, w_cols, labels, want_lse, gl, vocab_size=vs,
                               out_dtype=out_dtype), want, out_dtype, key)
                        e_fma = max(e_fma, e1)
                        if fn.route_launches != {**was, "fma": was["fma"] + 1}:
                            raise AssertionError(f"{name}: w_cols did not take "
                                                 f"the fma route: {key}")
                    del got, want
                errs[(name, cname, tag)] = e
                ratios = ", ".join(f"{k} out {v:.3f}" for k, v in r.items())
                msg.append(f"{name[5:]} {route} {e:.2e} (err/tol {ratios})")
                if w_cols is not None:
                    ratios = ", ".join(f"{k} out {v:.3f}"
                                       for k, v in r_fma.items())
                    msg.append(f"{name[5:]} fma {e_fma:.2e} (err/tol "
                               f"{ratios})")
            torch.cuda.synchronize()
            print(f"  xent {key:34s} max err {'; '.join(msg)} (tols: lse/ll "
                  f"{XENT_LSE_ATOL:g}+{XENT_LSE_RTOL:g}|ref|, grads "
                  f"{XENT_GRAD_SCALE_ATOL:g}max|ref|+{XENT_GRAD_RTOL[tag]:g}"
                  f"|ref| in each out dtype; err/tol is the largest error "
                  f"over its element's tolerance); bitwise repeatable")
            del h, w, w_cols, labels, gl
    return errs


def xent_bound_ms(N, D, ncols, el_bytes, kernel):
    """Least time: max(bytes once / HBM rate, FLOPs / bf16 peak); the
    backward kernels recompute the logits, so they do twice the forward's
    products. -> (ms, "bytes" | "operations")."""
    flops = 2 * N * D * ncols * (1 if kernel == "xent_fwd" else 2)
    nbytes = el_bytes * (N * D + D * ncols) + 4 * N + 4 * 2 * N
    if kernel == "xent_bwd_dh":
        nbytes += el_bytes * N * D
    elif kernel == "xent_bwd_dw":
        nbytes += el_bytes * D * ncols
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def xent_timing(torch, gen, power, errs):
    """Phase 4, the xent kernels (bf16) at the loss shapes of llama-1b,
    llama-7b (D = 4096) and gemma-2b (V = 256000): kernel by CUDA events
    and by device time (torch.profiler, every kernel of the call), plain
    version, bound, and two library routes: torch.matmul +
    F.cross_entropy for the forward; for the backward, the autograd
    backward of that pair (dh and dw together, reusing the saved logits),
    and that forward and backward together, which recomputes the logits as
    the kernels by contract do. At llama-1b's and llama-7b's shapes also
    the FMA kernels (w read through its columns), which walk D in one and
    in two slabs of 2048. -> one row per
    kernel, llama-1b's numbers on top and every shape under "shapes"."""
    import torch.nn.functional as F
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    shapes = {"llama-1b": ((4096, 2048, 32000), "llama-1b N=4096"),
              "llama-7b": ((4096, 4096, 32000), "llama-7b N=4096 D=4096"),
              "gemma-2b": ((4096, 2048, 256000), "gemma-2b N=4096 V=256000")}
    note_bwd = ("autograd of matmul + cross_entropy (dh and dw together, "
                "from saved logits)")
    note_full = ("matmul + cross_entropy and its autograd backward (dh and "
                 "dw together, logits recomputed)")
    kernel_routes = {"xent_fwd": "wgmma", "xent_bwd_dh": "mma",
                     "xent_bwd_dw": "mma"}
    bf = torch.bfloat16
    rows = {name: [] for name in XENT_KERNELS}
    for model, ((N, D, V), err_case) in shapes.items():
        h, w, labels, _ = xent_inputs(torch, gen, N, D, V, 0.0, bf)
        lse, _ = X.xent_fwd(h, w, labels, vocab_size=V)
        gl = torch.full((N,), 1.0 / N, device="cuda")
        args = (h, w, labels, lse, gl)
        w_cols = w.T.contiguous().T if model != "gemma-2b" else None
        hl, wl = h.detach().requires_grad_(), w.detach().requires_grad_()
        lib_loss = F.cross_entropy((hl @ wl).float(), labels.long(),
                                   reduction="mean")

        def lib_bwd():
            return torch.autograd.grad(lib_loss, [hl, wl], retain_graph=True)

        def lib_fwd():
            return F.cross_entropy((h @ w).float(), labels.long(),
                                   reduction="none")

        def lib_full():
            hf, wf = h.detach().requires_grad_(), w.detach().requires_grad_()
            loss = F.cross_entropy((hf @ wf).float(), labels.long(),
                                   reduction="mean")
            return torch.autograd.grad(loss, [hf, wf])
        libs = {k: (time_ms(torch, f, 10), device_ms(torch, f, 3))
                for k, f in (("fwd", lib_fwd), ("bwd", lib_bwd),
                             ("full", lib_full))}
        del lib_loss
        fns = {"xent_fwd": (X.xent_fwd, XR.xent_fwd_ref, (h, w, labels), {},
                            "fwd", "torch.matmul + F.cross_entropy", None),
               "xent_bwd_dh": (X.xent_bwd_dh, XR.xent_bwd_dh_ref, args,
                               {"out_dtype": bf}, "bwd", note_bwd, "full"),
               "xent_bwd_dw": (X.xent_bwd_dw, XR.xent_bwd_dw_ref, args,
                               {"out_dtype": bf}, "bwd", note_bwd, "full")}
        for name, (fn, ref, a, kw, lib, lib_note, lib2) in fns.items():
            def kern():
                return fn(*a, vocab_size=V, **kw)
            ms = time_ms(torch, kern, 5)
            dev_ms = device_ms(torch, kern, 5)
            plain_ms = time_ms(torch, lambda: ref(*a, vocab_size=V, **kw), 3)
            bound, by = xent_bound_ms(N, D, V, 2, name)
            (lib_ms, lib_dev), (lib2_ms, lib2_dev) = libs[lib], libs.get(
                lib2, (None, None))
            # products executed: the backward's logits, then G's hi and lo
            # halves contracted
            tflop = 2 * N * D * V * (1 if name == "xent_fwd" else 3) / 1e12
            fma_ms = fma_dev_ms = None
            if w_cols is not None:  # the FMA kernel: one or two slabs of D
                a_cols = (h, w_cols, *a[2:])

                def fma():
                    return fn(*a_cols, vocab_size=V, **kw)
                fma_ms = time_ms(torch, fma, 2, warm=1)
                fma_dev_ms = device_ms(torch, fma, 1)
            print(f"  [{power}] {name} {model} N={N} D={D} V={V} bf16, "
                  f"{kernel_routes[name]}: {ms:.4f} ms (device time "
                  f"{fmt_ms(dev_ms)}; {tflop / ms * 1e3:.1f} TFLOP/s of the "
                  f"{tflop:.3f} TFLOP it executes; bound {bound:.4f} ms by "
                  f"{by}, {bound / ms:.4f} of it; plain {plain_ms:.4f} ms; "
                  f"{lib_note} {lib_ms:.4f} ms, device time {fmt_ms(lib_dev)}"
                  + ("" if lib2 is None else f"; {note_full} {lib2_ms:.4f} "
                     f"ms, device time {fmt_ms(lib2_dev)}")
                  + ("" if fma_ms is None else f"; the FMA kernel (w read "
                     f"through its columns, {-(-D // 2048)} slab(s) of D) "
                     f"{fma_ms:.4f} ms, device time {fmt_ms(fma_dev_ms)}")
                  + ")")
            rows[name].append({
                "name": name, "shape": f"{model}: N={N} D={D} V={V} bf16",
                "route": "cuda", "kernel_route": kernel_routes[name],
                "source": SRC_XENT,
                # the forward's mainloop is in the header xent.cu includes
                "sources": [SRC_XENT] + ([SRC_HOPPER]
                                         if name == "xent_fwd" else []),
                "replaces": TPU_KERNELS[name], "launches": None,
                "max_abs_err": errs[(name, err_case, "bfloat16")],
                "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
                "library_device_ms": lib_dev, "library_note": lib_note,
                "library_recompute_ms": lib2_ms,
                "library_recompute_device_ms": lib2_dev,
                "library_recompute_note": None if lib2 is None
                else note_full, "fma_ms": fma_ms,
                "fma_device_ms": fma_dev_ms})
        del h, w, w_cols, labels, lse, gl, args, hl, wl
    out = []
    for name in XENT_KERNELS:
        row = {k: v for k, v in rows[name][0].items() if k != "shape"}
        row["shapes"] = rows[name]
        out.append(row)
    return out


# Phase 4: variants of the xent sources that measure the tensor-core
# kernels' designs at the train shape, each text substitutions on xent.cu
# or hopper_gemm.cuh (wrong results where a step is taken out: a time
# only). Of the backward: "chained" takes out the fold (each K-tile's
# products chain in the accumulator, which truncates), "no copies" fills
# the ring once and leaves stale tiles after (the loop without its
# cp.async traffic). Of the forward: "fwd no epilogue" replaces the
# softmax fold of each tile by one add of one logit (the wgmma mainloop
# alone: with no read of the accumulator left, ptxas drops the wgmma),
# "fwd loads only" also drops the wgmma (the TMA ring alone: how fast L2
# and memory feed the tiles).
_FWD_FOLD = ("    if (n0 + hopper::kBN <= ncols)\n"
             "      fold<false>(r, acc, n0);\n"
             "    else\n"
             "      fold<true>(r, acc, n0);\n", "    r.s[0] += acc[0];\n")
_FWD_WGMMA = ("#pragma unroll\n"
              "        for (int kk = 0; kk < kBK / 16; ++kk)\n"
              "          wgmma_m64n256k16_bt(acc, "
              "sw128_desc(a + 32 * kk, 16, 1024),\n"
              "                              "
              "sw128_desc(b + 16 * 128 * kk, kBBoxBytes, 1024), "
              "kt > 0 || kk > 0);\n", "")
XENT_VARIANTS = {
    # name: (the kernels it times, ((source, old text, new text), ...))
    "chained": (("xent_bwd_dh", "xent_bwd_dw"), (
        (SRC_XENT,
         '      "mov.f32 t0, 0f00000000;\\nmov.f32 t1, 0f00000000;\\n"\n'
         '      "mov.f32 t2, 0f00000000;\\nmov.f32 t3, 0f00000000;\\n"\n',
         '      "mov.f32 t0, %0;\\nmov.f32 t1, %1;\\n"\n'
         '      "mov.f32 t2, %2;\\nmov.f32 t3, %3;\\n"\n'),
        (SRC_XENT,
         '      "add.rn.f32 %0, %0, t0;\\nadd.rn.f32 %1, %1, t1;\\n"\n'
         '      "add.rn.f32 %2, %2, t2;\\nadd.rn.f32 %3, %3, t3;\\n}\\n"\n',
         '      "mov.f32 %0, t0;\\nmov.f32 %1, t1;\\n"\n'
         '      "mov.f32 %2, t2;\\nmov.f32 %3, t3;\\n}\\n"\n'))),
    "no copies": (("xent_bwd_dh", "xent_bwd_dw"), (
        (SRC_XENT,
         "    if (kt + kGemmStages - 1 < nk) load(kt + kGemmStages - 1);\n",
         ""),)),
    "fwd no epilogue": (("xent_fwd",), ((SRC_XENT, *_FWD_FOLD),)),
    "fwd loads only": (("xent_fwd",), ((SRC_XENT, *_FWD_FOLD),
                                       (SRC_HOPPER, *_FWD_WGMMA))),
}


# Phase 4: a variant of colnorm.cu that measures update_apply's vec route.
# "update loads and stores only" writes back theta + 0 * g (ptxas drops a
# load whose value nothing reads, volatile or not), so it moves the
# kernel's bytes in its pattern with no other math and no ss reads: the
# card's ceiling for them.
COLNORM_VARIANTS = {
    "update loads and stores only": (("update_apply",), (
        (SRC_COLNORM,
         "update_value(th[u].get(k), gv[u].get(k), sv[u][k], lr, gs, eps)",
         "__fadd_rn(th[u].get(k), __fmul_rn(0.f, gv[u].get(k)))"),)),
}


def start_variants(variants, sources):
    """Start one nvcc per entry of ``variants`` beside the kernels' build:
    each into its own directory of ``build/repro_torch/variants/``, with its
    copies of ``sources`` (the first is the one compiled). -> {name:
    (process, library path)}."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR / "variants"
    texts = {rel: (ROOT / rel).read_text() for rel in sources}
    jobs = {}
    for name, (_, subs) in variants.items():
        var = dict(texts)
        for rel, old, new in subs:
            if var[rel].count(old) != 1:
                raise AssertionError(f"variant {name!r}: its text is not "
                                     f"in {rel} once")
            var[rel] = var[rel].replace(old, new)
        d = out / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for rel, text in var.items():
            (d / Path(rel).name).write_text(text)
        jobs[name] = d / Path(sources[0]).name
    procs = {}
    for name, cu in jobs.items():
        lib = out / name.replace(" ", "_") / f"lib{cu.stem}.so"
        lib.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    atexit.register(_stop, [proc for proc, _ in procs.values()])
    return procs


def _stop(procs):
    """Kill what is still running of ``procs`` (a failed run exits early)."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _variant_lib(procs, name):
    """The loaded library of variant ``name`` once its nvcc has ended."""
    import ctypes
    proc, lib = procs[name]
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"variant {name!r}: nvcc failed\n{log}")
    return ctypes.CDLL(str(lib))


def _fwd_wgmma_call(torch, lib, h, w, labels, ncols):
    """A call of a library's xent_fwd_wgmma C entry with this tree's plan,
    on buffers made once."""
    from repro_torch.kernels.xent import xent as X
    N, D = h.shape
    splits, per = X.split_plan(N, ncols)
    part = torch.empty((3, N, splits), device="cuda")
    lse, ll = (torch.empty(N, device="cuda") for _ in range(2))

    def call():
        err = lib.xent_fwd_wgmma(
            h.data_ptr(), h.stride(0), w.data_ptr(), w.stride(0),
            labels.data_ptr(), part.data_ptr(), lse.data_ptr(), ll.data_ptr(),
            N, D, ncols, splits, per, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"xent_fwd_wgmma: CUDA error {err}")
    return call


def xent_variant_timing(torch, gen, power, procs, rows):
    """Phase 4: the kernels each variant times, at the train shape (the
    backward with bf16 out), by CUDA events, beside the real kernels timed
    again in the same loop (the forward's in turns, there and back); for
    the backward also the f32-out error over tolerance against the plain
    version. Adds the results to the xent rows under "variants"."""
    import math
    from repro_torch.kernels import _build
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    N, D, V = 4096, 2048, 32000
    h, w, labels, gl = xent_inputs(torch, gen, N, D, V, 0.1, torch.bfloat16)
    lse, _ = XR.xent_fwd_ref(h, w, labels, vocab_size=V)
    rows_c, cols = X.chunk_plan(N, V)
    g = torch.empty((2, rows_c, cols), dtype=torch.bfloat16, device="cuda")
    acc = torch.empty((rows_c, D), dtype=torch.float32, device="cuda")
    libs = {"kernel": X._bind(_build.library("xent"))}
    for name in XENT_VARIANTS:
        libs[name] = X._bind(_variant_lib(procs, name))
    res = {}
    flops = 2 * N * D * V
    # the forward's, in turns there and back: the card's clock drifts as it
    # heats over back-to-back products. Its TMA loads ask L2 for one 48 KB
    # stage (128 rows of h, 256 columns of w, 64 deep) per row tile,
    # vocab tile and K-tile.
    tma_bytes = -(-N // 128) * -(-V // 256) * -(-D // 64) * 49152
    fwd = [v for v in libs
           if v == "kernel" or "xent_fwd" in XENT_VARIANTS[v][0]]
    calls = {v: _fwd_wgmma_call(torch, libs[v], h, w, labels, V) for v in fwd}
    times = {v: [] for v in fwd}
    for v in fwd + fwd[::-1]:
        times[v].append(time_ms(torch, calls[v], 10))
    for v, t in times.items():
        ms = sum(t) / len(t)
        res.setdefault("xent_fwd", {})[v] = {"ms": ms, "runs": t}
        print(f"  [{power}] xent_fwd {v}: {ms:.4f} ms (mean of "
              f"{' and '.join(f'{x:.4f}' for x in t)}; {flops / ms / 1e9:.1f} "
              f"TFLOP/s of logits; its {tma_bytes / 1e9:.2f} GB of TMA loads "
              f"at {tma_bytes / ms / 1e9:.2f} TB/s)")
    for name in ("xent_bwd_dh", "xent_bwd_dw"):
        dh = name == "xent_bwd_dh"
        want = (XR.xent_bwd_dh_ref if dh else XR.xent_bwd_dw_ref)(
            h, w, labels, lse, gl, vocab_size=V)
        for variant, lib in libs.items():
            if variant != "kernel" and name not in XENT_VARIANTS[variant][0]:
                continue

            def run(bf, lib=lib):
                out = torch.empty((N, D) if dh else (D, V), device="cuda",
                                  dtype=torch.bfloat16 if bf else torch.float32)
                err = lib.xent_bwd_chunks(
                    int(dh), h.data_ptr(), h.stride(0), w.data_ptr(),
                    w.stride(0), labels.data_ptr(), lse.data_ptr(),
                    gl.data_ptr(), g.data_ptr(), acc.data_ptr(),
                    out.data_ptr(), int(bf), N, D, V, V, rows_c, cols,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name} ({variant}): CUDA error {err}")
                return out
            ms = time_ms(torch, lambda: run(True), 5)
            got = run(False)
            d = (got - want).abs()
            tol = (XENT_GRAD_SCALE_ATOL * want.abs().max()
                   + XENT_GRAD_RTOL["float32"] * want.abs())
            ratio = (d / tol).max().item()
            ratio = ratio if math.isfinite(ratio) else None  # stale tiles
            res.setdefault(name, {})[variant] = {"ms": ms, "f32_err_over_tol":
                                                 ratio}
            print(f"  [{power}] {name} {variant}: {ms:.4f} ms, f32 out "
                  f"err/tol " + ("not finite (stale tiles)" if ratio is None
                                 else f"{ratio:.3f}"))
            del got, d, tol
        del want
    for row in rows:
        if row["name"] in res:
            row["variants"] = res[row["name"]]


def phase_loss(torch, seed, power):
    """Phase 7: the loss path of llama-1b at full width and depth."""
    import math
    from repro_torch.configs import get_arch
    from unittest import mock
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.models import forward, init_params, lm_loss
    from repro_torch.training import make_eval_step
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    batch = make_dataset(cfg, S, B, seed=seed,
                         device="cuda").global_batch_at(0)
    labels = batch["labels"]
    n_tok = int((labels >= 0).sum())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}), {n_tok} labelled tokens")
    eval_step = make_eval_step(cfg)
    eval_step(params, batch)  # warm-up, not counted
    torch.cuda.synchronize()

    # the main path: counts set to 0 just before it, read just after
    zero_xent_counts()
    zero_route_counts()
    out = eval_step(params, batch)
    torch.cuda.synchronize()
    c_eval = xent_counts()
    check_routes(route_counts(), {"mha_fwd": {"mma": cfg.n_layers},
                                  "xent_fwd": {"wgmma": 1}},
                 "make_eval_step")
    want = {"mha_fwd": cfg.n_layers, "xent_fwd": 1, "xent_bwd_dh": 0,
            "xent_bwd_dw": 0}
    print(f"  make_eval_step launches {c_eval} (expect {want})")
    if c_eval != want:
        raise AssertionError(f"eval step launched {c_eval}, not {want}")
    loss, ppl = out["loss"].item(), out["perplexity"].item()
    with torch.no_grad():
        hidden, _, _ = forward(params, cfg, batch["tokens"])
        w0 = params["lm_head"]["w"]
        plain = (XR.losses(hidden, w0, labels, cfg.vocab_size).sum()
                 / n_tok).item()
        sigma2 = (hidden.float().square().sum(-1).mean()
                  * w0.float().var()).item()
    expect = math.log(cfg.vocab_size) + sigma2 / 2
    print(f"  eval loss {loss:.6f} (perplexity {ppl:.2f}); plain full-logit "
          f"route on the same hidden {plain:.6f} (|diff| "
          f"{abs(loss - plain):.2e}, tol {LOSS_ATOL:g}); ln V + sigma^2/2 = "
          f"{expect:.4f} at this init (sigma^2 = {sigma2:.4f})")
    if not (math.isfinite(loss) and abs(loss - plain) <= LOSS_ATOL
            and abs(ppl - math.exp(loss)) <= 1e-4 * ppl):
        raise AssertionError("eval loss disagrees with the plain route")
    # the whole eval against a forward whose attention is the plain
    # mha_fwd_ref (dispatch's name swapped for this one call), with the
    # plain full-logit loss on its hidden
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref), \
            torch.no_grad():
        ref_hidden, _, _ = forward(params, cfg, batch["tokens"])
        ref_loss = (XR.losses(ref_hidden, w0, labels, cfg.vocab_size).sum()
                    / n_tok).item()
        h_err = ((hidden.float() - ref_hidden.float()).abs().max()
                 / ref_hidden.float().abs().max()).item()
    del ref_hidden
    print(f"  eval loss against a forward through mha_fwd_ref: "
          f"{ref_loss:.6f} (|diff| {abs(loss - ref_loss):.2e}, tol "
          f"{EVAL_REF_ATOL:g}); final hidden max |diff| / max |ref| "
          f"{h_err:.2e}")
    if not abs(loss - ref_loss) <= EVAL_REF_ATOL:
        raise AssertionError("eval loss disagrees with the forward through "
                             "the plain attention")

    # the loss and its gradient at the head
    w = params["lm_head"]["w"].requires_grad_(True)
    h = hidden.detach().requires_grad_()

    def kernel_route():
        return torch.autograd.grad(lm_loss(params, cfg, h, labels)[0], [h, w])

    def plain_route():
        ls = XR.losses(h, w, labels, cfg.vocab_size).sum() / n_tok
        return torch.autograd.grad(ls, [h, w])

    kernel_route()  # warm-up, not counted
    torch.cuda.synchronize()
    zero_xent_counts()
    zero_route_counts()
    gh, gw = kernel_route()
    torch.cuda.synchronize()
    c_grad = xent_counts()
    want = {"mha_fwd": 0, "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1}
    print(f"  loss-and-grad at the head launches {c_grad} (expect {want})")
    if c_grad != want:
        raise AssertionError(f"loss-and-grad launched {c_grad}, not {want}")
    check_routes(route_counts(), {"xent_fwd": {"wgmma": 1},
                                  "xent_bwd_dh": {"mma": 1},
                                  "xent_bwd_dw": {"mma": 1}},
                 "loss-and-grad at the head")
    launches = {k: c_eval[k] + c_grad[k] for k in c_eval}
    wh, ww = plain_route()
    e_h, r_h = _grad_check(torch, "dH", gh, wh, torch.bfloat16, "phase 7")
    e_w, r_w = _grad_check(torch, "dW", gw, ww, torch.bfloat16, "phase 7")
    print(f"  dH {tuple(gh.shape)} and dW {tuple(gw.shape)} against the "
          f"plain route's autograd: max err {e_h:.3e} and {e_w:.3e} (tol "
          f"{XENT_GRAD_SCALE_ATOL:g}max|ref| + "
          f"{XENT_GRAD_RTOL['bfloat16']:g}|ref|; err/tol at most {r_h:.3f} "
          f"and {r_w:.3f}); max |dW| {ww.float().abs().max().item():.3e}")
    del wh, ww, gh, gw

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kernel_route()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  loss-and-grad under set_sync_debug_mode('error'): no host "
          "synchronisation")

    t_eval = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_step(params, batch)
        torch.cuda.synchronize()
        t_eval.append(time.perf_counter() - t0)
    eval_s = min(t_eval)
    grad_ms = time_ms(torch, kernel_route, 3)
    plain_ms = time_ms(torch, plain_route, 3)
    print(f"  [{power}] eval step {eval_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / eval_s:.0f} tokens/s); loss-and-grad at the head "
          f"{grad_ms:.3f} ms, plain route {plain_ms:.3f} ms")
    profile_step(torch, power, lambda: eval_step(params, batch),
                 eval_s * 1e3, n=1, label="eval step")
    # two calls: the first launch of a traced window can go unrecorded
    profile_step(torch, power, kernel_route, grad_ms, n=2,
                 label="loss-and-grad at the head")

    for name, fn in (("kernel route", kernel_route),
                     ("plain route", plain_route)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = fn()
        torch.cuda.synchronize()
        added = torch.cuda.max_memory_allocated() - base
        del res
        print(f"  [{power}] peak memory the loss-and-grad call adds, {name}: "
              f"{added / 2**20:.1f} MiB (N*V*4 = "
              f"{B * S * cfg.vocab_size * 4 / 2**20:.1f} MiB)")
        if name == "kernel route" and added >= B * S * cfg.vocab_size * 4:
            raise AssertionError("the kernel route holds (N, V) logits")
    w.requires_grad_(False)
    return {"launches": launches, "eval_ms": eval_s * 1e3,
            "grad_ms": grad_ms}


# ------------------------------------------------------- the training step


def train_counts():
    from repro_torch.kernels.attention import attention as A
    return {**counts(), **xent_counts(),
            **{k: getattr(A, k).launches for k in BWD_KERNELS}}


def zero_train_counts():
    from repro_torch.kernels.attention import attention as A
    zero_counts()
    zero_xent_counts()
    for k in BWD_KERNELS:
        getattr(A, k).launches = 0


def phase_train(torch, seed, power):
    """Phase 8: the training step of llama-1b at full width and depth."""
    import dataclasses
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.launch import train as launcher
    from repro_torch.models import Params, init_params
    from repro_torch.models.model import flatten
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    cfg = get_arch("llama-1b")
    B, S = 16, 256
    L = cfg.n_layers
    print(f"  {cfg.name}: {L} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat!r}; batch "
          f"{B} x {S} from SyntheticLM (seed {seed}); scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")

    # the launcher, as a user runs it
    argv = ["--arch", "llama-1b", "--optimizer", "scale_fused", "--batch",
            str(B), "--seq", str(S), "--steps", "3", "--log-every", "1",
            "--seed", str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 3 steps in {time.perf_counter() - t0:.1f} s (build, "
          f"init and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError("the launcher's loss is not finite")

    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, device="cuda")
    ref_params = Params({k: p.detach().clone()
                         for k, p in flatten(params).items()})
    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(TRAIN_STEPS)]

    def builder():
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, TRAIN_STEPS))
        return tx, make_train_step(cfg, tx, clip_norm=1.0)

    # the main path: counts set to 0 just before it, read just after
    tx, step = builder()
    state = init_state(params, tx)
    torch.cuda.synchronize()
    zero_train_counts()
    zero_route_counts()
    per_step, per_step_routes, losses = [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r: n - before_r[k][r]
                                    for r, n in c.items()}
                                for k, c in route_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    launches = train_counts()
    routes = route_counts()
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"train step {i} launched {c}, not {want}")
    print(f"  make_train_step: every one of {TRAIN_STEPS} steps launched "
          f"{want}; over the run {launches}")
    # the forward, its recompute, the backward pair and the xent kernels
    # on the tensor cores, every step
    want_r = {"mha_fwd": {"mma": 2 * L},
              **{k: {"mma": L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1},
              "xent_bwd_dh": {"mma": 1}, "xent_bwd_dw": {"mma": 1},
              "update_apply": {"vec": 9}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"train step {i}", show=False)
    check_routes(routes, {k: {r: TRAIN_STEPS * n for r, n in c.items()}
                          for k, c in want_r.items()},
                 f"{TRAIN_STEPS} train steps (every step {want_r})")
    losses = [float(x) for x in losses]

    # the same steps with attention through plain mha_fwd_ref autograd
    tx_r, step_r = builder()
    state_r = init_state(ref_params, tx_r)
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
        ref_losses = []
        for b in batches:
            state_r, m = step_r(state_r, b)
            ref_losses.append(float(m["loss"]))
    del state_r, ref_params, tx_r, step_r
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  loss over {TRAIN_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  plain-attention route:   "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError("the training loss does not fall, or leaves the "
                             "plain-attention route's curve")

    # one step with any host synchronisation an error
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("  train step under set_sync_debug_mode('error'): no host "
          "synchronisation")

    # every leaf's gradient against the plain-attention route: bf16 at full
    # depth, then f32 at full width and 4 layers
    batch = batches[0]

    def grads_both(c, p):
        _, _, g = value_and_grad(p, c, batch)
        with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
            _, _, r = value_and_grad(p, c, batch)
        return g, r

    g, r = grads_both(cfg, state.params)
    worst_k, worst = "", 0.0
    for k, x in g.items():
        rel = ((x.float() - r[k].float()).norm()
               / r[k].float().norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst_k, worst = k, rel
    print(f"  bf16 gradients, {len(g)} leaves at full depth, against the "
          f"plain-attention route: worst relative error in norm {worst:.3e} "
          f"({worst_k}; tol {TRAIN_GRAD_BF16:g})")
    if not worst <= TRAIN_GRAD_BF16:
        raise AssertionError("bf16 gradients disagree with plain attention")
    del g, r
    cfg4 = dataclasses.replace(cfg, n_layers=4, dtype="float32")
    p4 = init_params(cfg4, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    g, r = grads_both(cfg4, p4)
    worst_k, worst = "", 0.0
    for k, x in g.items():
        e = ((x - r[k]).abs().max() / r[k].abs().max().clamp_min(1e-30)).item()
        if e > worst:
            worst_k, worst = k, e
    print(f"  f32 gradients, 4 layers at full width, against the "
          f"plain-attention route: worst max |diff| / max |ref| per leaf "
          f"{worst:.3e} ({worst_k}; tol {TRAIN_GRAD_F32:g})")
    if not worst <= TRAIN_GRAD_F32:
        raise AssertionError("f32 gradients disagree with plain attention")
    del g, r, p4

    # times: host clock best of 3, the profile of one step, peak memory
    def one():
        nonlocal state
        state, _ = step(state, batch)

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    print(f"  [{power}] train step {step_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / step_s:.0f} tokens/s)")
    profile_step(torch, power, one, step_s * 1e3, n=1, label="train step",
                 top=30)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"  [{power}] torch.cuda.max_memory_allocated over one train step "
          f"{peak / 2**20:.1f} MiB")
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_step_routes[0], "step_ms": step_s * 1e3,
            "peak": peak}


# ------------------------------------------- the paper's two largest models

PAPER_MODELS = ("llama-7b", "gemma-2b")
PAPER_STEPS = 4  # make_train_step steps of each model in phase 9
# a train step's device time by kernel family (phase 9): the first family
# whose substring is in a kernel's name takes it
KERNEL_FAMILIES = (
    ("mha_fwd", "attention forward (mha_fwd)"),
    ("mha_bwd_dq", "attention backward dQ (mha_bwd_dq)"),
    ("mha_bwd_dkv", "attention backward dK, dV (mha_bwd_dkv)"),
    ("gemm_rows_kernel", "xent_fwd (wgmma mainloop and softmax epilogue)"),
    ("xent_fwd", "xent_fwd (split combine)"),
    ("GEpilogue", "xent backward: G kernels"),
    ("StoreEpilogue", "xent backward: dH and dW products"),
    ("update_apply", "update_apply"),
    ("sumsq", "norm_sumsq and momentum_sumsq"),
    ("momentum", "norm_sumsq and momentum_sumsq"),
    ("finish_kernel", "norm_sumsq and momentum_sumsq"),
    ("gemm", "cuBLAS GEMMs (projections, MLP, head)"),
    ("nvjet", "cuBLAS GEMMs (projections, MLP, head)"),
    ("", "other (copies, element-wise, reductions)"),
)


def by_family(kernels):
    """{family: (device ms, launches)} of profile_step's kernel list."""
    out = {}
    for key, n, ms in kernels:
        fam = next(f for sub, f in KERNEL_FAMILIES if sub in key)
        t, c = out.get(fam, (0.0, 0))
        out[fam] = (t + ms, c + round(n))
    return out


def train_paper_model(torch, seed, power, arch):
    """One model of phase 9, at full width and depth: the launcher for two
    steps, then ``make_train_step`` for PAPER_STEPS steps (the main path:
    counts from 0 just before, read just after, every step's launches by
    route checked), its loss curve against the same steps with attention
    through plain ``mha_fwd_ref`` autograd from the same seeded weights
    (run after the kernel route's state is freed, so the two never share
    the card), step time, tokens/s, device busy time by kernel family, idle
    share and peak memory."""
    import math
    from unittest import mock
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.launch import train as launcher
    from repro_torch.models import init_params
    from repro_torch.models.model import count_params, param_shapes
    from repro_torch.training import init_state, make_train_step
    torch.cuda.empty_cache()  # the earlier phases' cached blocks
    cfg = get_arch(arch)
    B, S = 16, 256
    L = cfg.n_layers
    n_params = count_params(param_shapes(cfg))
    print(f"  {arch}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"over {cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} G params, "
          f"{cfg.dtype}, remat {cfg.remat!r}; batch {B} x {S} from "
          f"SyntheticLM (seed {seed}); scale_fused, clip 1.0, "
          f"linear_warmup_cosine(1e-3, steps)")
    argv = ["--arch", arch, "--optimizer", "scale_fused", "--batch", str(B),
            "--seq", str(S), "--steps", "2", "--log-every", "1", "--seed",
            str(seed)]
    print(f"  python -m repro_torch.launch.train {' '.join(argv)}:")
    t0 = time.perf_counter()
    final = launcher.main(argv)
    print(f"  launcher: 2 steps in {time.perf_counter() - t0:.1f} s (init "
          f"and first-call costs included), final loss {final:.4f}")
    if not math.isfinite(final):
        raise AssertionError(f"{arch}: the launcher's loss is not finite")
    torch.cuda.empty_cache()

    ds = make_dataset(cfg, S, B, seed=seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(PAPER_STEPS)]

    def start():
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tx = make_optimizer("scale_fused",
                            linear_warmup_cosine(1e-3, PAPER_STEPS))
        return (init_state(init_params(cfg, gen, device="cuda"), tx),
                make_train_step(cfg, tx, clip_norm=1.0))

    # the main path: counts set to 0 just before it, read just after
    state, step = start()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_train_counts()
    zero_route_counts()
    per_step, per_step_routes, losses = [], [], []
    for b in batches:
        before, before_r = train_counts(), route_counts()
        state, metrics = step(state, b)
        per_step.append({k: v - before[k] for k, v in train_counts().items()})
        per_step_routes.append({k: {r: n - before_r[k][r]
                                    for r, n in c.items()}
                                for k, c in route_counts().items()})
        losses.append(metrics["loss"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = train_counts()
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"{arch} train step {i} launched {c}, not "
                                 f"{want}")
    # hd 128 takes the tensor cores both ways, hd 256 the fma kernels
    attn = "mma" if cfg.head_dim in (64, 128) else "fma"
    want_r = {"mha_fwd": {attn: 2 * L}, **{k: {attn: L} for k in BWD_KERNELS},
              "xent_fwd": {"wgmma": 1}, "xent_bwd_dh": {"mma": 1},
              "xent_bwd_dw": {"mma": 1}, "update_apply": {"vec": 9}}
    for i, c in enumerate(per_step_routes):
        check_routes(c, want_r, f"{arch} train step {i}", show=False)
    print(f"  {arch} make_train_step: every one of {PAPER_STEPS} steps "
          f"launched {want}, by route {want_r}")
    losses = [float(x) for x in losses]

    # times: host clock best of 3, the profile of one step
    def one():
        nonlocal state
        state, _ = step(state, batches[0])

    t_step = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        t_step.append(time.perf_counter() - t0)
    step_s = min(t_step)
    print(f"  [{power}] {arch} train step {step_s * 1e3:.3f} ms (best of 3; "
          f"{B * S / step_s:.0f} tokens/s); torch.cuda.max_memory_allocated "
          f"over its {PAPER_STEPS} main-path steps {peak / 2**20:.1f} MiB")
    busy, kernels = profile_step(torch, power, one, step_s * 1e3, n=1,
                                 label=f"{arch} train step", top=12)
    fams = by_family(kernels)
    for fam, (ms, n) in sorted(fams.items(), key=lambda x: -x[1][0]):
        print(f"    {ms:9.3f} ms {100 * ms / busy:5.1f}% x{n:<5d} {fam}")
    del state, step
    torch.cuda.empty_cache()

    # the same steps with attention through plain mha_fwd_ref autograd,
    # from the same seeded weights
    state, step = start()
    with mock.patch.object(dispatch, "mha_fwd", mha_fwd_ref):
        ref_losses = []
        for b in batches:
            state, m = step(state, b)
            ref_losses.append(float(m["loss"]))
    del state, step
    torch.cuda.empty_cache()
    gap = max(abs(a - b) for a, b in zip(losses, ref_losses))
    print(f"  {arch} loss over {PAPER_STEPS} steps: "
          f"{' '.join(f'{x:.4f}' for x in losses)}")
    print(f"  {arch} plain-attention route (full depth): "
          f"{' '.join(f'{x:.4f}' for x in ref_losses)} (max |diff| "
          f"{gap:.2e}, tol {LOSS_CURVE_ATOL:g})")
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
            and gap <= LOSS_CURVE_ATOL):
        raise AssertionError(f"{arch}: the training loss does not fall, or "
                             "leaves the plain-attention route's curve")
    return {"launches": launches, "per_step": per_step[0],
            "routes": per_step_routes[0], "step_ms": step_s * 1e3,
            "tokens_per_s": B * S / step_s, "busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / (step_s * 1e3),
            "peak_mib": peak / 2**20, "losses": losses,
            "ref_losses": ref_losses, "loss_gap": gap,
            "device_ms_by_family": {f: ms for f, (ms, _) in fams.items()}}


def phase_paper_models(torch, seed, power):
    """Phase 9: llama-7b and gemma-2b train at full width and depth."""
    return {arch: train_paper_model(torch, seed, power, arch)
            for arch in PAPER_MODELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 2

    from repro_torch.kernels import _build
    power = card()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1: device {kind} (nvidia-smi: {power}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    variants = {**start_variants(XENT_VARIANTS, (SRC_XENT, SRC_HOPPER)),
                **start_variants(COLNORM_VARIANTS, (SRC_COLNORM,))}
    libs = _build.build_all()
    print(f"  built {len(libs)} kernel libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s: {sorted(libs)}")
    for name in sorted(libs):
        for line in ptxas_report(_build.build_log(name)):
            print(f"  ptxas {line}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    print("phase 2: kernels against their plain versions on the card")
    errs = phase_kernels(torch, gen)
    bwd_errs = phase_bwd_kernels(torch, gen)
    opt_errs = phase_optimizer_kernels(torch, gen)
    opt_errs.update(phase_update_routes(torch, gen))
    xent_errs = phase_xent_kernels(torch, gen)
    print("phase 3: greedy serving, llama-130m, full width and depth")
    serve = phase_serving(torch, args.seed, power)
    print("phase 4: kernel times (CUDA events; attention and xent also "
          "device time)")
    mha_rows = phase_timing(torch, gen, power, serve, errs)
    bwd_rows = bwd_timing(torch, gen, power, bwd_errs)
    opt_rows = optimizer_timing(torch, gen, power, opt_errs, variants)
    xent_rows = xent_timing(torch, gen, power, xent_errs)
    xent_variant_timing(torch, gen, power, variants, xent_rows)
    print("phase 5: where the serving time goes (torch.profiler)")
    phase_profile(torch, args.seed, power, serve)
    print("phase 6: SCALE optimizer steps, llama-1b, full width and depth")
    opt = phase_optimizer(torch, args.seed, power)
    print("phase 7: the loss path, llama-1b, full width and depth")
    loss = phase_loss(torch, args.seed, power)
    print("phase 8: the training step, llama-1b, full width and depth")
    train = phase_train(torch, args.seed, power)
    print("phase 9: the training step, llama-7b and gemma-2b, full width and "
          "depth")
    paper = phase_paper_models(torch, args.seed, power)
    # one row per kernel; launches summed over the main paths that run it,
    # each counted from 0 just before its path and read just after
    by_path = {"serving": {"mha_fwd": serve["launches"]},
               "optimizer": opt["launches"], "loss": loss["launches"],
               "train": train["launches"],
               **{f"train {a}": r["launches"] for a, r in paper.items()}}
    # mha_fwd's prefill numbers, with both serving shapes and the eval and
    # training steps' shape beside them
    mha = {k: v for k, v in mha_rows[0].items() if k != "shape"}
    mha_rows[2]["launches"] = loss["launches"]["mha_fwd"]
    for entry, arch in zip(mha_rows[3:], PAPER_MODELS):
        entry["launches"] = paper[arch]["launches"]["mha_fwd"]
    mha_rows.append({**mha_rows[2], "shape": "train",
                     "launches": train["launches"]["mha_fwd"]})
    mha["shapes"] = mha_rows
    for row in bwd_rows:
        row["shapes"][0]["launches"] = train["launches"][row["name"]]
        for entry, arch in zip(row["shapes"][2:], PAPER_MODELS):
            entry["launches"] = paper[arch]["launches"][row["name"]]
    for row in xent_rows:
        for entry, path in zip(row["shapes"], (train, *paper.values())):
            entry["launches"] = path["launches"][row["name"]]
    rows = [mha] + bwd_rows + opt_rows + xent_rows
    for row in rows:
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in by_path.items()
                                   if c.get(row["name"])}
        row["launches"] = sum(row["launches_by_path"].values())
        row["launches_per_train_step"] = train["per_step"].get(row["name"])
        if row["name"] in train["routes"]:
            row["launches_per_train_step_by_route"] = train["routes"][
                row["name"]]
        row["launches_per_train_step_by_model"] = {
            a: {"launches": r["per_step"].get(row["name"]),
                "by_route": r["routes"].get(row["name"])}
            for a, r in (("llama-1b", train), *paper.items())}
    for path, c in by_path.items():
        for name, n in c.items():
            # norm_apply serves only the update entry point (phase 6)
            if not n and not (path.startswith("train")
                              and name == "norm_apply"):
                raise AssertionError(f"{name} was not launched on the "
                                     f"{path} path")
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
