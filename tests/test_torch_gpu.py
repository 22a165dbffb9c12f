"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The kernel
cases are those of phase 2 of ``chip_smoke.py``; a test serves a small
model on the card through the attention kernel, and the last ones take
SCALE optimizer steps through the optimizer kernels. Attention tolerances,
per element:
  * f32 out: 2e-5 absolute (unit-scale values summed in other orders);
  * bf16 out: 2e-2 + 2e-2*|ref| — the kernel rounds the running,
    unnormalized p to bf16, the plain version the normalized p, and the
    output itself has 8 bits of mantissa;
  * lse (f32 from exact products in both dtypes): 1e-4 + 1e-5*|ref|, on
    rows with at least one valid key.
Optimizer kernels (``norm_sumsq``, ``norm_apply``, ``update_apply``,
``momentum_sumsq``) against their plain versions:
  * sums of squares: 2e-5 relative — positive f32 terms summed in chains
    of a few hundred at most, in other orders ((n - 1) * 2**-24 bound);
  * element-wise outputs, given the same sums: 1 ulp of the output dtype
    at the scale of the formula's terms (the same IEEE operations, one
    rounding);
  * a second run is bitwise equal, and theta and m are written in place.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.attention.attention import mha_fwd  # noqa: E402
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
    before = mha_fwd.launches
    out, lse = mha_fwd(q, k, v, kl, scale=hd ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert mha_fwd.launches == before + 1
    ref, ref_lse = mha_fwd_ref(q, k, v, kl, scale=hd ** -0.5, causal=causal)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    rows = ref_lse > -1e29
    torch.testing.assert_close(lse[rows], ref_lse[rows], atol=1e-4, rtol=1e-5)
    if kv_len == 0:
        assert (out == 0).all()


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
              "wide_1x2048x32000": (1, 2048, 32000)}


def _ulp(x, dtype):
    mant = 7 if dtype == torch.bfloat16 else 23
    x = x.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(x)) - mant)


def _within_ulp(got, want, scale, dtype):
    err = (got.float() - want.float()).abs()
    assert bool((err <= _ulp(scale, dtype)).all()), err.max().item()


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
    rng = np.random.default_rng(3)
    g, th, m = (torch.from_numpy(rng.standard_normal(
        OPT_SHAPES[shape], dtype=np.float32)).to(cuda) for _ in range(3))
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
        _within_ulp(out, want, want, out_dtype)

    t1, t2 = th.clone(), th.clone()
    got = C.update_apply(t1, g, ss_p, lr, axis, gscale=gscale)
    assert got is t1
    want = CR.update_apply_ref(th.clone(), g, ss_p, lr, axis, gscale=gscale)
    _within_ulp(got, want, torch.maximum(th.float().abs(), want.float().abs()),
                td)
    C.update_apply(t2, g, ss_p, lr, axis, gscale=gscale)
    assert torch.equal(t1, t2)

    for mdt in (torch.float32, torch.bfloat16):
        m0 = (0.1 * m).to(mdt)
        m1, m2 = m0.clone(), m0.clone()
        got_m, got_ss = H.momentum_sumsq(m1, g, 0.9, axis, gscale=gscale)
        assert got_m is m1 and got_m.dtype == mdt
        want_m, want_ss = HR.momentum_sumsq_ref(m0.clone(), g, 0.9, axis,
                                                gscale=gscale)
        gsv = 1.0 if gscale is None else 0.37
        _within_ulp(got_m, want_m, 0.9 * m0.float().abs()
                    + 0.1 * gsv * g.float().abs(), mdt)
        torch.testing.assert_close(got_ss, want_ss, rtol=2e-5, atol=0)
        _, ss2 = H.momentum_sumsq(m2, g, 0.9, axis, gscale=gscale)
        assert torch.equal(m1, m2) and torch.equal(got_ss, ss2)
    torch.cuda.synchronize()
    after = (C.norm_sumsq.launches, C.norm_apply.launches,
             C.update_apply.launches, H.momentum_sumsq.launches)
    assert [a - b for a, b in zip(after, before)] == [2, 2, 2, 4]


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
    within 1.5 bf16 ulps of each element's peak per step of impl="jnp"."""
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
        pf, sf = fused.update_params(grads, sf, pf, grad_scale=gscale)
        after = (C.norm_sumsq.launches, C.update_apply.launches,
                 C.norm_apply.launches, H.momentum_sumsq.launches)
        assert [a - b for a, b in zip(after, before)] == [8, 9, 0, 1]
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
