#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout. It builds the port's CUDA kernels with
nvcc, then runs five phases and fails (non-zero exit, no result line) if
any of them fails:

1. device: the card's name and power limit, the kernels' ptxas report;
2. every kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at the edge cases, with stated tolerances;
3. the port's main path: greedy serving of llama-130m at full width and
   depth (bf16, seeded random weights; batch 8, a 512-token prompt, 64
   new tokens), checked against a full-sequence forward, with the kernel
   launch counts of the run;
4. kernel times with CUDA events beside their bound, the plain version
   and one PyTorch library call computing the same function;
5. where the serving time goes: device busy time and the top kernels of
   one prefill and of decode steps, from torch.profiler.

The line before the last is a JSON ``{"kernels": [...]}`` summary, the
last line ``{"ok": true, "device": {...}}``. It needs a CUDA card and
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
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
# lse is f32 in both dtypes, from exact f32 products of the inputs.
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
# Last decode step's logits against the full-sequence forward (bf16,
# 12 layers): the two paths round each bf16 matmul output at different
# places (one row against 575), about 2^-8 relative each, compounding
# through 12 residual layers.
SERVE_ATOL, SERVE_RTOL = 5e-2, 5e-2

SRC_MHA = "src/repro_torch/kernels/attention/csrc/mha_fwd.cu"
TPU_MHA = "src/repro/kernels/attention/attention.py:223"


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
    }


def make_qkv(torch, gen, B, S, T, H, K, hd, dtype):
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hd)


def phase_kernels(torch, gen):
    """Phase 2: mha_fwd against mha_fwd_ref on the card. -> max errors."""
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    errs = {}
    for name, (B, S, T, H, K, hd, causal, kl) in attention_cases().items():
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, dtype)
            kv_len = None if kl is None else torch.tensor(
                kl, dtype=torch.int32, device="cuda")
            out, lse = mha_fwd(q, k, v, kv_len, scale=hd ** -0.5,
                               causal=causal)
            torch.cuda.synchronize()
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
            print(f"  {name:26s} {tag:9s} out err {e_out:.3e} "
                  f"(tol {atol:g} + {rtol:g}|ref|)  lse err {e_lse:.3e} "
                  f"(tol {LSE_ATOL:g} + {LSE_RTOL:g}|ref|)")
            if not (out_ok and lse_ok and finite and zero_ok):
                raise AssertionError(f"mha_fwd disagrees with the plain "
                                     f"version: {name} {tag}")
            errs[(name, tag)] = e_out
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
    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, N, max_seq)
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    launches = mha_fwd.launches
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (1 + (N - 1))
    print(f"  greedy_generate: mha_fwd launches {launches} (expect "
          f"{cfg.n_layers} x (1 + {N - 1}) = {want})")
    if launches != want:
        raise AssertionError(f"mha_fwd launched {launches} times, not {want}")
    if out.shape != (B, N) or not bool(((out >= 0)
                                        & (out < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {tuple(out.shape)}")

    # the same path step by step, timed, for the per-phase launch counts
    prefill = make_prefill_step(cfg, max_seq)
    decode = make_decode_step(cfg)
    mha_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logits = prefill(params, prompt)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    n_prefill = mha_fwd.launches
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


def time_ms(torch, fn, iters):
    for _ in range(5):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    """Phase 4: kernel, plain version and SDPA at the serving shapes."""
    import torch.nn.functional as F
    from repro_torch.kernels.attention.attention import mha_fwd
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    kl = serve["mean_kv_len"]
    shapes = {
        "prefill": ((8, 512, 512, 12, 12, 64, True, None),
                    serve["prefill_launches"], 50, "prefill llama-130m"),
        "decode": ((8, 1, 576, 12, 12, 64, False, kl),
                   serve["decode_launches"], 500, "decode kv_len=300"),
    }
    rows = []
    for phase, (shape, launches, iters, err_case) in shapes.items():
        B, S, T, H, K, hd, causal, kv_len = shape
        q, k, v = make_qkv(torch, gen, B, S, T, H, K, hd, torch.bfloat16)
        kl_t = None if kv_len is None else torch.tensor(
            kv_len, dtype=torch.int32, device="cuda")
        scale = hd ** -0.5
        ms = time_ms(torch, lambda: mha_fwd(q, k, v, kl_t, scale=scale,
                                            causal=causal), iters)
        plain_ms = time_ms(torch, lambda: mha_fwd_ref(
            q, k, v, kl_t, scale=scale, causal=causal), max(iters // 10, 5))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        mask = None
        if kv_len is not None:
            mask = (torch.arange(T, device="cuda") < kv_len)[None, None, None]
        lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal, scale=scale),
            iters)
        bound, by = attention_bound_ms(B, S, T, H, K, hd, causal, kv_len, 2)
        print(f"  [{power}] mha_fwd {phase} B={B} S={S} T={T} H={H} hd={hd}"
              f"{' kv_len=%d' % kv_len if kv_len is not None else ''}: "
              f"{ms:.4f} ms (bound {bound:.4f} ms by {by}; plain "
              f"{plain_ms:.4f} ms; SDPA {lib_ms:.4f} ms)")
        rows.append({"name": "mha_fwd", "shape": phase, "route": "cuda",
                     "source": SRC_MHA, "replaces": TPU_MHA,
                     "launches": launches,
                     "max_abs_err": errs[(err_case, "bfloat16")],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms})
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
    print("phase 3: greedy serving, llama-130m, full width and depth")
    serve = phase_serving(torch, args.seed, power)
    print("phase 4: kernel times (CUDA events)")
    rows = phase_timing(torch, gen, power, serve, errs)
    print("phase 5: where the serving time goes (torch.profiler)")
    phase_profile(torch, args.seed, power, serve)
    print(power)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
