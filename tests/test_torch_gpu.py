"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The kernel
cases are those of phase 2 of ``chip_smoke.py``; a test serves a small
model on the card through the attention kernel, others take SCALE
optimizer steps through the optimizer kernels, and one trains a small
llama through every kernel of the training step. Attention tolerances,
per element:
  * f32 out: 2e-5 absolute (unit-scale values summed in other orders);
  * bf16 out: 2e-2 + 2e-2*|ref| — the kernel rounds the running,
    unnormalized p to bf16, the plain version the normalized p, and the
    output itself has 8 bits of mantissa;
  * lse (f32 in both dtypes; bf16 scores are exact bf16 products summed
    in f32 on the tensor cores, f32 ones f32 FMAs): 1e-4 + 1e-5*|ref|, on
    rows with at least one valid key.
Every case also checks the forward's route count (``_fwd_route``: mma
for bf16 heads of 64 and 128 past S = 4, decode at S <= 4, fma else), and
a call at the training shape is bitwise equal on a second run.
Optimizer kernels (``norm_sumsq``, ``norm_apply``, ``update_apply``,
``momentum_sumsq``) against their plain versions:
  * sums of squares: 2e-5 relative — positive f32 terms summed in chains
    of a few hundred at most, in other orders ((n - 1) * 2**-24 bound);
  * element-wise outputs, given the same sums: 1 ulp of the output dtype
    at the scale of the formula's terms (the same IEEE operations, one
    rounding);
  * a second run is bitwise equal, and theta and m are written in place;
  * ``update_apply``'s ``vec`` route (16-byte vectors over the flat run,
    for contiguous operands at a common offset of 0-7 elements) is bitwise
    equal to its ``strided`` route on the same values laid out transposed
    (the two compute each element with the same operations), for bf16,
    bf16 theta with an f32 g, and f32, col and row, lr and gscale by value
    and by device pointer; each call is counted on its route.
Cross-entropy kernels (``xent_fwd``, ``xent_bwd_dh``, ``xent_bwd_dw``)
against their plain versions, with lse from the plain forward:
  * lse and ll: 1e-4 + 1e-5*|ref| — f32 sums of D exact products in other
    orders, and a log-sum-exp over V terms;
  * dh and dw in f32: 1e-5*max|ref| + 1e-4*|ref| — f32 sums over the vocab
    (dh) or the tokens (dw) in other orders, of recomputed logits;
  * dh and dw in bf16: the same plus one bf16 rounding on each side,
    8e-3*|ref|;
  * a second run is bitwise equal;
  * each function's two routes meet these bounds, counted in the
    wrappers' ``route_launches``: the tensor cores for aligned bf16
    (``wgmma`` for the forward, on wgmma and TMA; ``mma`` for the
    backward) and ``fma`` (float32, other bf16 layouts, here w read
    through its columns); the tensor-core backward is chunked over the
    vocab (and past 2**17 tokens over the tokens) and carries G as two
    bf16 halves, to about 2**-16 of itself; the forward's cases include
    one 128 x 256 tile and a single row with ragged K and vocab tiles;
    llama-7b's D = 4096 (the FMA kernels walk D in two slabs of 2048), a
    D of 4100 that ends a slab mid-way, and gemma-2b's V = 256000;
  * ``dispatch.xent_loss`` gradients against the plain losses' autograd:
    the same bounds in the inputs' dtype.
Attention backward (``mha_bwd_dq``, ``mha_bwd_dkv``) against the plain
versions, with lse and delta from the plain forward:
  * f32: 1e-5*max|ref| + 1e-5*|ref| (sums of up to a few thousand terms in
    other orders); bf16: 2e-3*max|ref| + 8e-3*|ref| (p and ds rounded to
    bf16 from f32 values that differ in their last bits, so a rare term
    lands one ulp apart, then one rounding of each output);
  * a second run is bitwise equal;
  * each case takes the route ``_bwd_route`` names: the tensor-core (mma)
    kernels for bf16 heads of 64 and 128, the f32-FMA (fma) ones for f32
    and other bf16 heads (32, and gemma-2b's 256 over one kv head);
  * ``dispatch.flash_attention`` gradients against plain autograd through
    ``mha_fwd_ref``: the forward's tolerances, scaled by max|ref| (2e-5 in
    f32, 1e-2 in bf16). A direct CUDA ``mha_fwd`` call under grad raises
    (its output has no autograd history).
The eval step's loss is held
to 1e-4 against the plain full-logit loss of the same hidden (f32 means
summed in other orders), and to 2e-3 against the loss of a forward whose
attention is ``mha_fwd_ref`` (the bf16 roundings of the attention outputs
differ, and move each per-token loss by about their relative size).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention.attention import (  # noqa: E402
    _fwd_route, mha_fwd)
from repro_torch.kernels.attention.ref import mha_fwd_ref  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dtype_name):
    return (2e-5, 0.0) if dtype_name == "f32" else (2e-2, 2e-2)


def _inputs(seed, B, S, T, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the mha_fwd kernel runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, S, T, H, K, hd, causal, kv_len): the chip_smoke.py phase-2 cases
GPU_CASES = {
    "prefill_llama130m": (8, 512, 512, 12, 12, 64, True, None),
    "decode_kl0": (8, 1, 576, 12, 12, 64, False, 0),
    "decode_kl1": (8, 1, 576, 12, 12, 64, False, 1),
    "decode_kl300": (8, 1, 576, 12, 12, 64, False, 300),
    "decode_kl576": (8, 1, 576, 12, 12, 64, False, 576),
    "rect_causal_64x576": (8, 64, 576, 12, 12, 64, True, None),
    "gqa_qwen2_500m": (8, 512, 512, 14, 2, 64, True, None),
    "ragged37": (8, 37, 37, 12, 12, 64, True, None),
    "hd128": (4, 512, 512, 8, 8, 128, True, None),
    "hd256": (2, 512, 512, 8, 1, 256, True, None),
    "eval_llama1b": (16, 256, 256, 32, 32, 64, True, None),
    # the edges of the tensor-core (mma) route
    "s5_past_decode": (8, 5, 5, 12, 12, 64, True, None),
    "ragged200": (8, 200, 200, 12, 12, 64, True, None),
    "rect_causal_64x576_hd128": (8, 64, 576, 12, 12, 128, True, None),
    "gqa14x2_ragged100_hd128": (4, 100, 100, 14, 2, 128, True, None),
    "kvlen300_s16": (8, 16, 576, 12, 12, 64, False, 300),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(GPU_CASES))
def test_kernel_matches_plain_on_card(cuda, case, dtype):
    B, S, T, H, K, hd, causal, kv_len = GPU_CASES[case]
    td = DTYPES[dtype]
    q, k, v = (torch.from_numpy(x).to(cuda, td)
               for x in _inputs(1, B, S, T, H, K, hd))
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                  device=cuda)
    route = _fwd_route(q, k, v)
    before = mha_fwd.launches, dict(mha_fwd.route_launches)
    out, lse = mha_fwd(q, k, v, kl, scale=hd ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before[0] + 1
    assert mha_fwd.route_launches == {**before[1], route: before[1][route] + 1}
    ref, ref_lse = mha_fwd_ref(q, k, v, kl, scale=hd ** -0.5, causal=causal)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    rows = ref_lse > -1e29
    torch.testing.assert_close(lse[rows], ref_lse[rows], atol=1e-4, rtol=1e-5)
    if kv_len == 0:
        assert (out == 0).all()


@pytest.mark.gpu
def test_train_shape_takes_the_mma_route_bitwise_repeatably(cuda):
    """A bf16 call at the training step's shape (llama-1b: B=16, S=T=256,
    32 heads of 64, causal) launches the tensor-core kernel exactly once,
    and a second run gives the same bits."""
    B, S, T, H, K, hd = 16, 256, 256, 32, 32, 64
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _inputs(2, B, S, T, H, K, hd))
    before = dict(mha_fwd.route_launches)
    out, lse = mha_fwd(q, k, v, scale=hd ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert mha_fwd.route_launches == {**before, "mma": before["mma"] + 1}
    out2, lse2 = mha_fwd(q, k, v, scale=hd ** -0.5, causal=True)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_on_card_goes_through_the_kernel(cuda, dtype):
    """Prefill + decode on the card match the full forward; every attention
    call launched the kernel (f32: 1e-4, whole layers summed in other
    orders; bf16: 2e-2 + 2e-2*|ref|)."""
    from repro_torch.models import (ModelConfig, forward, init_params,
                                    logits_from_hidden)
    from repro_torch.training import make_decode_step, make_prefill_step
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, d_ff=256, vocab_size=1000, dtype=dtype)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    B, S, P = 2, 40, 32
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to(cuda)
    before = mha_fwd.launches
    state, logits = make_prefill_step(cfg, max_seq=S)(params, toks[:, :P])
    decode = make_decode_step(cfg)
    for i in range(P, S):
        state, logits = decode(params, state, toks[:, i:i + 1])
    torch.cuda.synchronize()
    assert mha_fwd.launches - before == cfg.n_layers * (1 + S - P)
    with torch.no_grad():
        h, _, _ = forward(params, cfg, toks)
        ref = logits_from_hidden(params, cfg, h)[:, -1]
    atol, rtol = (1e-4, 0.0) if dtype == "float32" else (2e-2, 2e-2)
    torch.testing.assert_close(logits[:, -1].float()[:, :cfg.vocab_size],
                               ref.float()[:, :cfg.vocab_size], atol=atol,
                               rtol=rtol)


OPT_SHAPES = {"ragged_3x77x129": (3, 77, 129),
              "odd_rows_1x5461x2048": (1, 5461, 2048),
              "wide_1x2048x32000": (1, 2048, 32000),
              "w_gate_llama7b_32x4096x11008": (32, 4096, 11008)}
# past this many elements the operands are drawn on the card (numpy would
# take minutes) and the element-wise checks run one layer at a time (the
# full-size temporaries of a check would not fit beside the operands)
_BIG = 2**28


def _ulp(x, dtype):
    mant = 7 if dtype == torch.bfloat16 else 23
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - mant)


def _within_ulp(got, want, scale, dtype):
    err = (got.float() - want.float()).abs()
    assert bool((err <= _ulp(scale, dtype)).all()), err.max().item()


def _within_ulp_by_layer(got, want, scale, dtype):
    """``_within_ulp`` on each slice of dim 0; ``scale(l)`` is layer l's
    scale."""
    for l in range(got.shape[0]):
        _within_ulp(got[l], want[l], scale(l), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("gs", ["nogs", "gs0.37"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("axis", ["col", "row"])
@pytest.mark.parametrize("shape", list(OPT_SHAPES))
def test_optimizer_kernels_match_plain_on_card(cuda, shape, axis, dtype, gs):
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head import ref as HR
    from repro_torch.kernels.scale_head import scale_head as H
    td = DTYPES[dtype]
    shape_ = OPT_SHAPES[shape]
    if np.prod(shape_) > _BIG:
        gen = torch.Generator(device=cuda).manual_seed(3)
        g, th, m = (torch.randn(shape_, generator=gen, device=cuda)
                    for _ in range(3))
    else:
        rng = np.random.default_rng(3)
        g, th, m = (torch.from_numpy(rng.standard_normal(
            shape_, dtype=np.float32)).to(cuda) for _ in range(3))
    g, th = g.to(td), th.to(td)
    gscale = None if gs == "nogs" else torch.tensor(0.37, device=cuda)
    lr = torch.tensor(0.01, device=cuda)
    before = (C.norm_sumsq.launches, C.norm_apply.launches,
              C.update_apply.launches, H.momentum_sumsq.launches)

    ss = C.norm_sumsq(g, axis, gscale=gscale)
    ss_p = CR.norm_sumsq_ref(g, axis, gscale=gscale)
    torch.testing.assert_close(ss, ss_p, rtol=2e-5, atol=0)
    assert torch.equal(ss, C.norm_sumsq(g, axis, gscale=gscale))

    for out_dtype in (td, torch.float32):
        out = C.norm_apply(g, ss_p, axis, gscale=gscale, out_dtype=out_dtype)
        want = CR.norm_apply_ref(g, ss_p, axis, gscale=gscale,
                                 out_dtype=out_dtype)
        assert out.dtype == out_dtype
        _within_ulp_by_layer(out, want, lambda l: want[l], out_dtype)
        del out, want

    t1, t2 = th.clone(), th.clone()
    got = C.update_apply(t1, g, ss_p, lr, axis, gscale=gscale)
    assert got is t1
    want = CR.update_apply_ref(th.clone(), g, ss_p, lr, axis, gscale=gscale)
    _within_ulp_by_layer(got, want, lambda l: torch.maximum(
        th[l].float().abs(), want[l].float().abs()), td)
    C.update_apply(t2, g, ss_p, lr, axis, gscale=gscale)
    assert torch.equal(t1, t2)
    del t1, t2, got, want, th

    for mdt in (torch.float32, torch.bfloat16):
        m0 = (0.1 * m).to(mdt)
        m1, m2 = m0.clone(), m0.clone()
        got_m, got_ss = H.momentum_sumsq(m1, g, 0.9, axis, gscale=gscale)
        assert got_m is m1 and got_m.dtype == mdt
        want_m, want_ss = HR.momentum_sumsq_ref(m0.clone(), g, 0.9, axis,
                                                gscale=gscale)
        gsv = 1.0 if gscale is None else 0.37
        _within_ulp_by_layer(got_m, want_m, lambda l: 0.9 * m0[l].float()
                             .abs() + 0.1 * gsv * g[l].float().abs(), mdt)
        torch.testing.assert_close(got_ss, want_ss, rtol=2e-5, atol=0)
        _, ss2 = H.momentum_sumsq(m2, g, 0.9, axis, gscale=gscale)
        assert torch.equal(m1, m2) and torch.equal(got_ss, ss2)
        del m0, m1, m2, got_m, want_m
    torch.cuda.synchronize()
    after = (C.norm_sumsq.launches, C.norm_apply.launches,
             C.update_apply.launches, H.momentum_sumsq.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 4]


VEC_SHAPES = {"ragged_3x77x129": (3, 77, 129),
              "w_gate_24x2048x5461": (24, 2048, 5461),
              "head_1x2048x32000": (1, 2048, 32000),
              "w_gate_llama7b_32x4096x11008": (32, 4096, 11008)}
VEC_PAIRS = {"bf16-bf16": ("bfloat16", "bfloat16"),
             "bf16-f32": ("bfloat16", "float32"),
             "f32-f32": ("float32", "float32")}


@pytest.mark.gpu
@pytest.mark.parametrize("axis", ["col", "row"])
@pytest.mark.parametrize("pair", list(VEC_PAIRS))
@pytest.mark.parametrize("shape", list(VEC_SHAPES))
def test_update_apply_vec_route_matches_strided_on_card(cuda, shape, pair,
                                                        axis):
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.colnorm import ref as CR
    td, gd = (getattr(torch, d) for d in VEC_PAIRS[pair])
    L, m, n = VEC_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(5)
    th0 = torch.randn((L, m, n), generator=gen, device=cuda).to(td)
    g0 = torch.randn((L, m, n), generator=gen, device=cuda).to(gd)
    ss = CR.norm_sumsq_ref(g0, axis)

    def transposed(x):
        t = torch.empty((L, n, m), dtype=x.dtype, device=cuda)
        return t.transpose(1, 2).copy_(x)

    def at(x, off):
        buf = torch.empty(x.numel() + off, dtype=x.dtype, device=cuda)
        return buf[off:].view(x.shape).copy_(x)

    def one(route, th, g, lr, gscale):
        was = dict(C.update_apply.route_launches)
        assert C._route(th, g) == route
        got = C.update_apply(th, g, ss, lr, axis, gscale=gscale)
        assert got is th
        assert C.update_apply.route_launches == {**was, route: was[route] + 1}

    for lr, gscale in ((0.01, 0.37), (torch.tensor(0.01, device=cuda),
                                      torch.tensor(0.37, device=cuda))):
        strided = transposed(th0)
        one("strided", strided, transposed(g0), lr, gscale)
        want = CR.update_apply_ref(th0.clone(), g0, ss, lr, axis,
                                   gscale=gscale)
        _within_ulp_by_layer(strided, want, lambda l: torch.maximum(
            th0[l].float().abs(), want[l].float().abs()), td)
        del want
        for off in range(8):
            th, g = at(th0, off), at(g0, off)
            one("vec", th, g, lr, gscale)
            assert torch.equal(th, strided), off
        th = at(th0, 0)
        one("vec", th, g0, lr, gscale)
        assert torch.equal(th, strided)
    torch.cuda.synchronize()


def _scale_model(cuda):
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import flatten
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_ff=347, vocab_size=1000,
                      dtype="bfloat16")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = {k: p.detach() for k, p in
              flatten(init_params(cfg, gen, device=cuda)).items()}
    grads = {k: torch.randn(p.shape, generator=gen, device=cuda).to(p.dtype)
             for k, p in params.items()}
    return params, grads


@pytest.mark.gpu
def test_scale_fused_steps_on_card_go_through_the_kernels(cuda):
    """update_params through the kernels: 8 norm_sumsq, 9 update_apply and
    1 momentum_sumsq launches per step (8 stateless matrices and the head),
    within 1.5 bf16 ulps of each element's peak per step of impl="jnp";
    every update_apply on the vec route."""
    from repro_torch.core import (global_norm, linear_warmup_cosine,
                                  make_optimizer)
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    params, grads = _scale_model(cuda)
    gnorm = global_norm(grads)
    gscale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
    sched = linear_warmup_cosine(1e-2, 10)
    fused = make_optimizer("scale_fused", sched, lr_scaling=True)
    plain = make_optimizer("scale", sched, lr_scaling=True)
    pf = {k: p.clone() for k, p in params.items()}
    pr = {k: p.clone() for k, p in params.items()}
    sf, sr = fused.init(pf), plain.init(pr)
    peak = {k: p.float().abs() for k, p in pr.items()}
    for _ in range(3):
        before = (C.norm_sumsq.launches, C.update_apply.launches,
                  C.norm_apply.launches, H.momentum_sumsq.launches)
        routes = dict(C.update_apply.route_launches)
        pf, sf = fused.update_params(grads, sf, pf, grad_scale=gscale)
        after = (C.norm_sumsq.launches, C.update_apply.launches,
                 C.norm_apply.launches, H.momentum_sumsq.launches)
        assert [a - b for a, b in zip(after, before)] == [8, 9, 0, 1]
        assert C.update_apply.route_launches == {
            "vec": routes["vec"] + 9, "strided": routes["strided"]}
        old = {k: p.clone() for k, p in pr.items()}
        pr, sr = plain.update_params(grads, sr, pr, grad_scale=gscale)
        for k, p in pr.items():
            peak[k] = torch.maximum(peak[k], torch.maximum(
                p.float().abs(), (p.float() - old[k].float()).abs()))
    torch.cuda.synchronize()
    for k, p in pf.items():
        err = (p.float() - pr[k].float()).abs()
        assert bool((err <= 4.5 * _ulp(peak[k], p.dtype)).all()), k
    torch.testing.assert_close(sf.mu["lm_head/w"], sr.mu["lm_head/w"],
                               rtol=0, atol=4e-6 * sr.mu["lm_head/w"]
                               .abs().max().item())


@pytest.mark.gpu
def test_update_params_does_not_synchronise_with_the_host(cuda):
    from repro_torch.core import (global_norm, linear_warmup_cosine,
                                  make_optimizer)
    params, grads = _scale_model(cuda)
    gnorm = global_norm(grads)
    gscale = torch.minimum(torch.ones_like(gnorm), 1.0 / (gnorm + 1e-9))
    tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-3, 100),
                        lr_scaling=True)
    state = tx.init(params)
    tx.update_params(grads, state, params, grad_scale=gscale)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tx.update_params(grads, state, params, grad_scale=gscale)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# (N, D, V, vocab_size, share of -1 labels): the chip_smoke.py phase-2 cases
XENT_CASES = {
    "llama1b_4096": (4096, 2048, 32000, 32000, 0.0),
    "n1": (1, 2048, 32000, 32000, 0.0),
    "n4097_padvocab": (4097, 2048, 32000, 31990, 0.1),
    "all_masked": (300, 2048, 32000, 32000, 1.0),
    "small_d64": (300, 64, 1000, 1000, 0.2),
    "d80": (300, 80, 1000, 1000, 0.2),  # D not a multiple of the K-tile
    "n16384": (16384, 2048, 32000, 32000, 0.0),  # a narrower chunk_plan
    "n140000_d16": (140000, 16, 128, 128, 0.1),  # two token chunks
    # one tile of the wgmma forward (128 x 256; h and w exactly 64 x 64 and
    # 64 x 256), and one row with a ragged K-tile and a ragged vocab tile
    "single_tile": (64, 64, 256, 256, 0.0),
    "n1_ragged": (1, 96, 264, 260, 0.0),
    # llama-7b's loss (D = 4096: two slabs of D on the FMA kernels), a D
    # that ends a slab mid-way (not a multiple of 16, so bf16 takes the FMA
    # kernels too), and gemma-2b's loss (V = 256000)
    "llama7b_d4096": (4096, 4096, 32000, 32000, 0.0),
    "d4100_ragged_slab": (300, 4100, 1000, 1000, 0.2),
    "gemma2b_v256000": (4096, 2048, 256000, 256000, 0.05),
}


def _bwd_routes(X):
    return [dict(f.route_launches) for f in (X.xent_bwd_dh, X.xent_bwd_dw)]


def _route_delta(now, was):
    return {r: now[r] - was[r] for r in was}


def _xent_inputs(cuda, case, td, seed=5):
    N, D, V, vs, masked = XENT_CASES[case]
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((D, V), dtype=np.float32)
                         / np.sqrt(D))
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < masked] = -1
    gl = torch.from_numpy(rng.random(N).astype(np.float32))
    return (h.to(cuda, td), w.to(cuda, td), torch.from_numpy(labels).to(cuda),
            gl.to(cuda), vs)


def _xent_close(got, want, out_dtype):
    scale = want.float().abs().max().item()
    rtol = 1e-4 if out_dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-5 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(XENT_CASES))
def test_xent_kernels_match_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    td = DTYPES[dtype]
    h, w, labels, gl, vs = _xent_inputs(cuda, case, td)
    # aligned bf16 takes the tensor cores; f32 and a D that is not a
    # multiple of 16 the FMA kernels
    tc = td == torch.bfloat16 and h.shape[1] % 16 == 0
    before = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
              X.xent_bwd_dw.launches)
    routes = _bwd_routes(X)
    fwd_routes = dict(X.xent_fwd.route_launches)
    lse, ll = X.xent_fwd(h, w, labels, vocab_size=vs)
    want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, vocab_size=vs)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ll, want_ll, atol=1e-4, rtol=1e-5)
    assert (ll[(labels < 0) | (labels >= vs)] == 0).all()
    lse2, ll2 = X.xent_fwd(h, w, labels, vocab_size=vs)
    assert torch.equal(lse, lse2) and torch.equal(ll, ll2)
    assert X.mma_layout(h, w) == tc
    n_fwd = 2
    w_cols = w.T.contiguous().T if tc else None
    if tc:  # the FMA forward, which other layouts take
        assert not X.mma_layout(h, w_cols)
        lse3, ll3 = X.xent_fwd(h, w_cols, labels, vocab_size=vs)
        torch.testing.assert_close(lse3, want_lse, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(ll3, want_ll, atol=1e-4, rtol=1e-5)
        n_fwd = 3
    n_bwd = 0
    for out_dtype in {td, torch.float32}:
        for fn, ref in ((X.xent_bwd_dh, XR.xent_bwd_dh_ref),
                        (X.xent_bwd_dw, XR.xent_bwd_dw_ref)):
            got = fn(h, w, labels, want_lse, gl, vocab_size=vs,
                     out_dtype=out_dtype)
            want = ref(h, w, labels, want_lse, gl, vocab_size=vs,
                       out_dtype=out_dtype)
            assert got.dtype == out_dtype and got.shape == want.shape
            _xent_close(got, want, out_dtype)
            assert torch.equal(got, fn(h, w, labels, want_lse, gl,
                                       vocab_size=vs, out_dtype=out_dtype))
            if fn is X.xent_bwd_dw:
                assert (got[:, vs:] == 0).all()
            if tc:  # the FMA kernel of other layouts
                _xent_close(fn(h, w_cols, labels, want_lse, gl,
                               vocab_size=vs, out_dtype=out_dtype),
                            want, out_dtype)
            n_bwd += 1
    torch.cuda.synchronize()
    per = 3 if tc else 2
    after = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
             X.xent_bwd_dw.launches)
    assert [a - b for a, b in zip(after, before)] == [n_fwd, per * n_bwd // 2,
                                                      per * n_bwd // 2]
    # aligned bf16 on the tensor cores (twice per out dtype: the bitwise
    # rerun), w read through its columns on the FMA kernels; f32 and a
    # ragged D on the FMA kernels (twice: the bitwise rerun)
    n_out = n_bwd // 2
    want = ({"mma": 2 * n_out, "fma": n_out} if tc
            else {"mma": 0, "fma": 2 * n_out})
    for now, was in zip(_bwd_routes(X), routes):
        assert _route_delta(now, was) == want
    # the forward: aligned bf16 on wgmma (the call and its bitwise rerun),
    # w read through its columns on the FMA kernel; else twice on the FMA
    assert _route_delta(X.xent_fwd.route_launches, fwd_routes) == (
        {"wgmma": 2, "fma": 1} if tc else {"wgmma": 0, "fma": 2})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xent_loss_grads_on_card_match_plain_autograd(cuda, dtype):
    """The autograd Function launches one kernel each way, and its value
    and (dh, dw) match the plain losses' autograd on the card."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    td = DTYPES[dtype]
    h, w, labels, _, vs = _xent_inputs(cuda, "n4097_padvocab", td, seed=6)
    h3 = h[:4096].reshape(16, 256, -1).detach().requires_grad_()
    w = w.detach().requires_grad_()
    lab = labels[:4096].reshape(16, 256)
    weights = torch.rand(lab.shape, device=cuda)
    before = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
              X.xent_bwd_dw.launches)
    routes = _bwd_routes(X)
    fwd_routes = dict(X.xent_fwd.route_launches)
    got = dispatch.xent_loss(h3, w, lab, vocab_size=vs, weights=weights)
    gh, gw = torch.autograd.grad(got.sum(), [h3, w])
    torch.cuda.synchronize()
    after = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
             X.xent_bwd_dw.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    route = "mma" if td == torch.bfloat16 else "fma"
    for now, was in zip(_bwd_routes(X), routes):
        assert _route_delta(now, was) == {r: int(r == route) for r in was}
    fwd_route = "wgmma" if td == torch.bfloat16 else "fma"
    assert _route_delta(X.xent_fwd.route_launches, fwd_routes) == {
        r: int(r == fwd_route) for r in fwd_routes}
    want = XR.losses(h3, w, torch.where(weights > 0, lab, -1), vs) * weights
    wh, ww = torch.autograd.grad(want.sum(), [h3, w])
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)
    assert gh.dtype == td and gw.dtype == td
    _xent_close(gh, wh, td)
    _xent_close(gw, ww, td)


# (B, S, T, H, K, hd, causal, kv_len): the chip_smoke.py phase-2 cases of
# the backward kernels
BWD_CASES = {
    "train_llama1b": (16, 256, 256, 32, 32, 64, True, None),
    "gqa_qwen2_500m": (8, 512, 512, 14, 2, 64, True, None),
    "hd128": (4, 512, 512, 8, 8, 128, True, None),
    "ragged200": (8, 200, 200, 12, 12, 64, True, None),
    "rect_causal_64x576": (8, 64, 576, 12, 12, 64, True, None),
    "kvlen300": (8, 16, 576, 12, 4, 64, False, 300),
    "kvlen0": (8, 16, 576, 12, 12, 64, False, 0),
    # the edges of the tensor-core (mma) route: dK, dV chained over 4 x 1024
    # query rows, and the hd 128 layout on a ragged tile
    "long_gqa_1024": (1, 1024, 1024, 8, 2, 64, True, None),
    "hd128_ragged": (2, 200, 200, 4, 4, 128, True, None),
    # a bf16 head the mma route does not take: the fma kernels in bf16
    "hd32_gqa_ragged": (4, 200, 200, 8, 4, 32, True, None),
    # gemma-2b's head (hd 256, 8 query heads over 1 kv head) on the fma
    # kernels: causal, the kv_len bound, and causal with S != T
    "hd256": (2, 512, 512, 8, 1, 256, True, None),
    "hd256_kvlen300": (2, 16, 576, 8, 1, 256, False, 300),
    "hd256_rect_causal_64x576": (2, 64, 576, 8, 1, 256, True, None),
}


def _bwd_close(got, want, dtype):
    """Backward kernels against their plain versions, per element:
    f32 1e-5*max|ref| + 1e-5*|ref| (f32 sums of up to a few thousand terms
    in other orders); bf16 2e-3*max|ref| + 8e-3*|ref| (p and ds are rounded
    to bf16 at the same places on both sides, but from f32 values that
    differ in their last bits, so a rare term rounds one ulp apart; then one
    rounding of each output)."""
    scale = want.float().abs().max().item()
    atol, rtol = (1e-5, 1e-5) if dtype == "f32" else (2e-3, 8e-3)
    d = (got.float() - want.float()).abs()
    tol = atol * scale + rtol * want.float().abs()
    assert bool(torch.isfinite(got.float()).all())
    assert bool((d <= tol).all()), d.max().item()


def _bwd_inputs(cuda, case, td, seed=8):
    """(q, k, v, dout, lse, delta, kv_len) with lse and delta from the plain
    forward, fed to both sides."""
    B, S, T, H, K, hd, causal, kv_len = BWD_CASES[case]
    q, k, v = (torch.from_numpy(x).to(cuda, td)
               for x in _inputs(seed, B, S, T, H, K, hd))
    rng = np.random.default_rng(seed + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape, dtype=np.float32)
                          ).to(cuda, td)
    kl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32,
                                                  device=cuda)
    out, lse = mha_fwd_ref(q, k, v, kl, scale=hd ** -0.5, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, kl


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernels_match_plain_on_card(cuda, case, dtype):
    """mha_bwd_dq and mha_bwd_dkv against their plain versions, each on its
    route (mma for bf16 heads of 64 and 128, fma for f32 and the bf16 head
    of 32); each runs twice and is bitwise repeatable (no atomics)."""
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    B, S, T, H, K, hd, causal, kv_len = BWD_CASES[case]
    args = _bwd_inputs(cuda, case, DTYPES[dtype])
    kw = dict(scale=hd ** -0.5, causal=causal)
    route = "mma" if dtype == "bf16" and hd in (64, 128) else "fma"
    assert _bwd_route(*args[:3]) == route
    before = (mha_bwd_dq.launches, mha_bwd_dkv.launches,
              dict(mha_bwd_dq.route_launches),
              dict(mha_bwd_dkv.route_launches))
    dq = mha_bwd_dq(*args, **kw)
    dk, dv = mha_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    assert (mha_bwd_dq.launches - before[0],
            mha_bwd_dkv.launches - before[1]) == (1, 1)
    for fn, was in ((mha_bwd_dq, before[2]), (mha_bwd_dkv, before[3])):
        assert fn.route_launches == {**was, route: was[route] + 1}
    assert dq.shape == args[0].shape and dk.shape == args[1].shape \
        and dv.shape == args[2].shape
    _bwd_close(dq, mha_bwd_dq_ref(*args, **kw), dtype)
    want_dk, want_dv = mha_bwd_dkv_ref(*args, **kw)
    _bwd_close(dk, want_dk, dtype)
    _bwd_close(dv, want_dv, dtype)
    assert torch.equal(dq, mha_bwd_dq(*args, **kw))
    dk2, dv2 = mha_bwd_dkv(*args, **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    if kv_len == 0:
        assert all(bool((g == 0).all()) for g in (dq, dk, dv))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_grads_on_card_launch_the_backward_kernels(
        cuda, dtype, monkeypatch):
    """dispatch.flash_attention is differentiable on the card: one backward
    launches one mha_bwd_dq and one mha_bwd_dkv, and the gradients match
    plain autograd through mha_fwd_ref (the forward swapped into dispatch);
    the bf16 tolerance is the forward's, whose roundings differ. A direct
    mha_fwd call under grad still raises rather than drop the gradient."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention.attention import (mha_bwd_dkv,
                                                         mha_bwd_dq)
    td = DTYPES[dtype]
    x = _inputs(7, 2, 128, 128, 8, 2, 64)
    q, k, v = (torch.from_numpy(a).to(cuda, td).requires_grad_() for a in x)
    do = torch.randn(q.shape, generator=torch.Generator(device=cuda)
                     .manual_seed(0), device=cuda).to(td)
    before = (mha_fwd.launches, mha_bwd_dq.launches, mha_bwd_dkv.launches)
    out = dispatch.flash_attention(q, k, v, scale=0.125, causal=True)
    got = torch.autograd.grad(out, [q, k, v], do)
    torch.cuda.synchronize()
    after = (mha_fwd.launches, mha_bwd_dq.launches, mha_bwd_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    monkeypatch.setattr(dispatch, "mha_fwd", mha_fwd_ref)
    ref = dispatch.flash_attention(q, k, v, scale=0.125, causal=True)
    want = torch.autograd.grad(ref, [q, k, v], do)
    assert mha_bwd_dq.launches == after[1]  # the plain route: no kernel
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    for g, w in zip(got, want):
        assert g.dtype == td
        scale = w.float().abs().max().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol,
                                   atol=(2e-5 if dtype == "f32" else 1e-2)
                                   * scale)
    with pytest.raises(RuntimeError, match="flash_attention"):
        mha_fwd(q, k, v, scale=0.125, causal=True)


def _train_counts():
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as SH
    from repro_torch.kernels.xent import xent as X
    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv, X.xent_fwd,
           X.xent_bwd_dh, X.xent_bwd_dw, C.norm_sumsq, C.update_apply,
           SH.momentum_sumsq, C.norm_apply)
    return {f.__name__: f.launches for f in fns}


@pytest.mark.gpu
def test_train_step_on_card_goes_through_the_kernels(cuda, monkeypatch):
    """make_train_step of scale_fused (clip 1.0, remat full) on a small
    llama: per step 2L mha_fwd (forward and recompute), L of each backward
    kernel (all on the tensor-core mma route), one of each xent kernel (the
    forward on wgmma), 8 norm_sumsq, 9 update_apply (all on the vec route),
    one momentum_sumsq and no norm_apply; the
    loss falls over four steps, and
    one loss-and-grad matches plain attention's autograd (bf16 at 2 layers:
    per leaf, 3e-2 of its largest |gradient|, the roundings of the
    attention outputs differing)."""
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    ds = make_dataset(cfg, 128, 4, seed=1, device=cuda)
    batch = ds.global_batch_at(0)
    _, _, grads = value_and_grad(params, cfg, batch)
    with monkeypatch.context() as m:
        m.setattr(dispatch, "mha_fwd", mha_fwd_ref)
        _, _, ref = value_and_grad(params, cfg, batch)
    for k, g in grads.items():
        scale = ref[k].float().abs().max().item()
        d = (g.float() - ref[k].float()).abs().max().item()
        assert d <= 3e-2 * scale, (k, d, scale)
    tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-2, 8))
    step = make_train_step(cfg, tx, clip_norm=1.0)
    state = init_state(params, tx)
    want = {"mha_fwd": 2 * cfg.n_layers, "mha_bwd_dq": cfg.n_layers,
            "mha_bwd_dkv": cfg.n_layers, "xent_fwd": 1, "xent_bwd_dh": 1,
            "xent_bwd_dw": 1, "norm_sumsq": 8, "update_apply": 9,
            "momentum_sumsq": 1, "norm_apply": 0}
    losses = []
    for i in range(4):
        before = _train_counts()
        routes = [dict(f.route_launches) for f in (A.mha_bwd_dq,
                                                   A.mha_bwd_dkv)]
        fwd_routes = dict(X.xent_fwd.route_launches)
        update_routes = dict(C.update_apply.route_launches)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        after = _train_counts()
        assert {k: after[k] - before[k] for k in want} == want, i
        for f, was in zip((A.mha_bwd_dq, A.mha_bwd_dkv), routes):
            assert {r: f.route_launches[r] - was[r] for r in was} == \
                {"mma": cfg.n_layers, "fma": 0}, (f.__name__, i)
        assert _route_delta(X.xent_fwd.route_launches, fwd_routes) == {
            "wgmma": 1, "fma": 0}, i
        assert _route_delta(C.update_apply.route_launches,
                            update_routes) == {"vec": 9, "strided": 0}, i
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert int(state.step) == 4


@pytest.mark.gpu
def test_eval_step_and_head_grad_on_card(cuda, monkeypatch):
    """make_eval_step launches n_layers mha_fwd and one xent_fwd, and its
    loss matches the plain full-logit loss of the same hidden (1e-4) and
    that of a forward whose attention is mha_fwd_ref (2e-3); the head's
    loss and gradient launch one kernel of each xent kind."""
    from repro_torch.kernels import dispatch
    from repro_torch.data import make_dataset
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import ModelConfig, forward, init_params, lm_loss
    from repro_torch.training import make_eval_step
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    batch = make_dataset(cfg, 128, 4, seed=1, device=cuda).global_batch_at(0)
    before = (mha_fwd.launches, X.xent_fwd.launches)
    fwd_routes = dict(X.xent_fwd.route_launches)
    out = make_eval_step(cfg)(params, batch)
    torch.cuda.synchronize()
    assert (mha_fwd.launches - before[0], X.xent_fwd.launches - before[1]) \
        == (cfg.n_layers, 1)
    assert _route_delta(X.xent_fwd.route_launches, fwd_routes) == {
        "wgmma": 1, "fma": 0}
    with torch.no_grad():
        hidden, _, _ = forward(params, cfg, batch["tokens"])
    lab = batch["labels"]
    want = XR.losses(hidden, params["lm_head"]["w"], lab, cfg.vocab_size)
    want = want.sum() / (lab >= 0).sum()
    torch.testing.assert_close(out["loss"], want, atol=1e-4, rtol=0)
    torch.testing.assert_close(out["perplexity"], torch.exp(want), atol=0,
                               rtol=1e-4)
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(dispatch, "mha_fwd", mha_fwd_ref)
        ref_hidden, _, _ = forward(params, cfg, batch["tokens"])
    ref = XR.losses(ref_hidden, params["lm_head"]["w"], lab, cfg.vocab_size)
    torch.testing.assert_close(out["loss"], ref.sum() / (lab >= 0).sum(),
                               atol=2e-3, rtol=0)
    w = params["lm_head"]["w"].requires_grad_(True)
    h = hidden.detach().requires_grad_()
    before = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
              X.xent_bwd_dw.launches)
    gh, gw = torch.autograd.grad(lm_loss(params, cfg, h, lab)[0], [h, w])
    after = (X.xent_fwd.launches, X.xent_bwd_dh.launches,
             X.xent_bwd_dw.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    plain = XR.losses(h, w, lab, cfg.vocab_size).sum() / (lab >= 0).sum()
    wh, ww = torch.autograd.grad(plain, [h, w])
    _xent_close(gh, wh, torch.bfloat16)
    _xent_close(gw, ww, torch.bfloat16)
    w.requires_grad_(False)
