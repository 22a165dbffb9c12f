"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The kernel
cases are those of phase 2 of ``chip_smoke.py``; a test serves a small
model on the card through the attention kernel, others take SCALE
optimizer steps through the optimizer kernels, one trains a small
llama through every kernel of the training step, one trains it with the
LM head tied to the embedding through the tied head's routes, one trains
mamba2-370m's and jamba-1.5-large-398b's SMOKE twins two steps against
the same steps plain (and serves the latter through its mixed cache), and
one skips a step with an injected NaN under the anomaly guard (bitwise a
dropped batch, sync-free) and checkpoints the guarded state. Attention tolerances,
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
    the same bounds in the inputs' dtype;
  * the ``col_offset`` clause, at vocabulary shards of llama-1b's head
    (untied column slices and tied row slices, 2 and 4 shards, bf16 and
    f32), of a musicgen-medium codebook head in the two shards of a (1,
    2) mesh, and a padded vocabulary's shard past vocab_size on the
    wrappers' ``empty`` route): each shard against the plain version with
    its col_offset, with the bounds above, bitwise on rerun, counted by
    route and in ``offset_launches``; the shards combined against the
    whole head's kernels (f32 bounds); the sharded ``xent_loss`` on a
    (1, 1) mesh bitwise the unsharded call, and a layout the plans send
    to "ref" raising on the card.
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
The sequence-split decode of serving on a mesh (each T-shard of the cache
on the decode kernel at its local fill, the partials combined by
``dispatch.lse_combine``), at llama-130m's and the VLM's decode shapes in
two and four shards, is held against the unsharded kernel call and the
plain version at the attention tolerances above.
MLA's attention (queries and keys 192 wide, values 128, H == K, causal)
holds the three kernels on the fma route at the tolerances above, and
deepseek-v3's SMOKE twin takes a train step through every kernel of its
path against the same step with every kernel through its plain version.
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
    "kvlen0_s16": (8, 16, 576, 12, 12, 64, False, 0),
    "noncausal_100x300": (8, 100, 300, 12, 12, 64, False, None),
    # the GQA layouts of dbrx-132b (48 heads over 8) and mistral-large-123b
    # (96 over 8) at hd 128, their training shape (phase 16)
    "train_dbrx_gqa48x8_hd128": (16, 256, 256, 48, 8, 128, True, None),
    "train_mistral_gqa96x8_hd128": (16, 256, 256, 96, 8, 128, True, None),
    # and of qwen2-7b (28 over 4) and deepseek-67b (64 over 8)
    "train_qwen2_gqa28x4_hd128": (16, 256, 256, 28, 4, 128, True, None),
    "train_deepseek67b_gqa64x8_hd128": (16, 256, 256, 64, 8, 128, True,
                                        None),
    # phase 16's decode steps (batch 4, a cache of 256 + 32): the first and
    # the last step's kv_len, at 48 and 96 heads over 8 of 128
    "decode_dbrx_gqa48x8_kl256": (4, 1, 288, 48, 8, 128, False, 256),
    "decode_dbrx_gqa48x8_kl287": (4, 1, 288, 48, 8, 128, False, 287),
    "decode_gqa96x8_hd128_kl256": (4, 1, 288, 96, 8, 128, False, 256),
    "decode_gqa96x8_hd128_kl287": (4, 1, 288, 96, 8, 128, False, 287),
    # jamba-1.5-large-398b's attention (64 heads over 8 of 128, phase 19):
    # its train batch of 4 x 1024, its serving prefill of 4 x 512, and the
    # first and the last decode step's kv_len (a cache of 512 + 32)
    "train_jamba_gqa64x8_hd128": (4, 1024, 1024, 64, 8, 128, True, None),
    "prefill_jamba_gqa64x8_hd128": (4, 512, 512, 64, 8, 128, True, None),
    "decode_jamba_gqa64x8_kl512": (4, 1, 544, 64, 8, 128, False, 512),
    "decode_jamba_gqa64x8_kl543": (4, 1, 544, 64, 8, 128, False, 543),
    # llama-3.2-vision-11b's cross-attention (phase 20): 4 x 1024 text
    # queries over 4096 image keys, non-causal, 32 heads over 8 of 128; a
    # decode step's one query over them with no kv_len; and its causal
    # self-attention at the train batch
    "cross_vlm_gqa32x8_1024x4096": (4, 1024, 4096, 32, 8, 128, False, None),
    "cross_decode_vlm_t4096": (4, 1, 4096, 32, 8, 128, False, None),
    "train_vlm_gqa32x8_hd128": (4, 1024, 1024, 32, 8, 128, True, None),
    # its serving: the prefill's cross- and self-attention at 4 x 512 and
    # the self-attention's first and last decode step (a cache of 512 + 32)
    "prefill_cross_vlm_512x4096": (4, 512, 4096, 32, 8, 128, False, None),
    "prefill_vlm_gqa32x8_hd128": (4, 512, 512, 32, 8, 128, True, None),
    "decode_vlm_gqa32x8_kl512": (4, 1, 544, 32, 8, 128, False, 512),
    "decode_vlm_gqa32x8_kl543": (4, 1, 544, 32, 8, 128, False, 543),
    # one rank's share of the cross-attention on a (1, 2) mesh (phase 24):
    # its 16 of 32 query heads over 4 of 8 kv heads
    "cross_vlm_rank_gqa16x4_1024x4096": (4, 1024, 4096, 16, 4, 128, False,
                                         None),
    # musicgen-medium's (phase 21): 24 heads of 64, causal, at its train
    # batch, its serving prefill and first and last decode step
    "train_musicgen_h24_hd64": (4, 1024, 1024, 24, 24, 64, True, None),
    "prefill_musicgen_h24_hd64": (4, 512, 512, 24, 24, 64, True, None),
    "decode_musicgen_h24_kl512": (4, 1, 544, 24, 24, 64, False, 512),
    "decode_musicgen_h24_kl543": (4, 1, 544, 24, 24, 64, False, 543),
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
              "w_gate_llama7b_32x4096x11008": (32, 4096, 11008),
              # the tied heads of llama-1b and gemma-2b, stored (V, D): the
              # momentum and update of the row kind (the (D, V) use
              # layout's col norm)
              "tied_head_1x32000x2048": (1, 32000, 2048),
              "tied_head_gemma2b_1x256000x2048": (1, 256000, 2048),
              # jamba-1.5-large-398b's training cut (phase 19): Mamba2's
              # in_proj and out_proj, the MoE router of 4 experts, the head
              "jamba_in_proj_1x8192x33280": (1, 8192, 33280),
              "jamba_out_proj_1x16384x8192": (1, 16384, 8192),
              "jamba_router_1x8192x4": (1, 8192, 4),
              "jamba_head_1x8192x65536": (1, 8192, 65536),
              # llama-3.2-vision-11b's (phase 20): the head, the
              # embedding, and the leaves stacked over its 8 super-blocks
              # (the MLPs', the self- and cross-attention's wq/wo, wk/wv)
              "vlm_head_1x4096x128256": (1, 4096, 128256),
              "vlm_embed_1x128256x4096": (1, 128256, 4096),
              "vlm_w_gate_8x4096x14336": (8, 4096, 14336),
              "vlm_w_down_8x14336x4096": (8, 14336, 4096),
              "vlm_wq_8x4096x4096": (8, 4096, 4096),
              "vlm_wk_8x4096x1024": (8, 4096, 1024),
              # musicgen-medium's 4 codebook heads (one 3-D leaf in
              # SCALE's momentum group) and 4 codebook embeddings
              "musicgen_head_4x1536x2048": (4, 1536, 2048),
              "musicgen_embed_4x2048x1536": (4, 2048, 1536)}
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



def _zoo_cases():
    from repro_torch.core import OPTIMIZER_NAMES
    cases = {n: (n, {"rank": 8} if n in ("galore", "fira", "apollo") else {})
             for n in OPTIMIZER_NAMES}
    cases.update({"sgd_colnorm_fused": ("sgd_colnorm", {"impl": "fused"}),
                  "sgd_rownorm_fused": ("sgd_rownorm", {"impl": "fused"})})
    return cases


def _to(state, device):
    """A pipeline optimizer's state, its tensors copied to ``device``."""
    def mv(t):
        return ({k: mv(v) for k, v in t.items()} if isinstance(t, dict)
                else t.to(device, copy=True))
    return state._replace(count=mv(state.count), mu=mv(state.mu),
                          nu=mv(state.nu),
                          extra=None if state.extra is None
                          else mv(state.extra))


def _opt_launches():
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.kernels.scale_head import scale_head as H
    return {"norm_sumsq": C.norm_sumsq.launches,
            "update_apply": C.update_apply.launches,
            "norm_apply": C.norm_apply.launches,
            "momentum_sumsq": H.momentum_sumsq.launches}


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["update", "update_params"])
@pytest.mark.parametrize("case", list(_zoo_cases()))
def test_zoo_step_on_card_matches_cpu(cuda, case, entry):
    """One step of every registry name on the card against the same step on
    the CPU (f32, a two-layer llama of d_model 128, grad_scale 0.37), from
    a state that took one CPU step first (so APOLLO's projector, drawn per
    device, is carried). Per element: 8 f32 ulps of the element's peak
    plus 1e-4 of the leaf's largest step change (f32 sums and products in
    other orders, Newton-Schulz and SVD among them; TF32 is off). The
    never-fused names launch no optimizer kernel; the fused ablations
    launch ``norm_sumsq`` and ``update_apply`` (``update_params``) or
    ``norm_apply`` (``update``) once per matrix leaf. Every name but
    ``sgd_svdnorm`` (``torch.linalg.svd`` checks its status on the host)
    takes its step under ``set_sync_debug_mode("error")``."""
    from repro_torch.core import apply_updates, make_optimizer
    from repro_torch.core.pipeline import HostCount, jax_mul
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import flatten
    name, kw = _zoo_cases()[case]
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=4, d_ff=347, vocab_size=1000,
                      dtype="float32")
    gen = torch.Generator().manual_seed(0)
    cpu = {k: p.detach() for k, p in
           flatten(init_params(cfg, gen, device="cpu")).items()}
    g0, g1 = ({k: torch.randn(p.shape, generator=gen) for k, p in
               cpu.items()} for _ in range(2))
    tx = make_optimizer(name, 1e-2, **kw)
    sc = tx.init(cpu)
    cpu, sc = tx.update_params(g0, sc, cpu)
    card = {k: p.to(cuda, copy=True) for k, p in cpu.items()}
    sg = _to(sc, cuda)._replace(host_count=HostCount(sc.host_count.n))
    gs_c = torch.tensor(0.37)
    gs_g = gs_c.to(cuda)
    g1g = {k: g.to(cuda) for k, g in g1.items()}
    old = {k: p.clone() for k, p in cpu.items()}
    if entry == "update":
        cu, sc = tx.update({k: jax_mul(g, gs_c) for k, g in g1.items()},
                           sc, cpu)
        cpu = apply_updates(cpu, cu)
        scaled = {k: jax_mul(g, gs_g) for k, g in g1g.items()}
    before = _opt_launches()
    torch.cuda.synchronize()
    if name != "sgd_svdnorm":
        torch.cuda.set_sync_debug_mode("error")
    try:
        if entry == "update":
            gu, sg = tx.update(scaled, sg, card)
            card = apply_updates(card, gu)
        else:
            card, sg = tx.update_params(g1g, sg, card, grad_scale=gs_g)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in _opt_launches().items()}
    if entry == "update_params":
        cpu, sc = tx.update_params(g1, sc, cpu, grad_scale=gs_c)
    n_mat = sum(p.ndim >= 2 and "norm" not in k for k, p in card.items())
    if kw.get("impl") == "fused":
        want = ({"norm_sumsq": n_mat, "update_apply": n_mat, "norm_apply": 0,
                 "momentum_sumsq": 0} if entry == "update_params" else
                {"norm_sumsq": n_mat, "update_apply": 0,
                 "norm_apply": n_mat, "momentum_sumsq": 0})
    elif name in ("scale", "scale_fused", "adapm"):
        want = got  # SCALE's own counts are checked above
    else:
        want = dict.fromkeys(got, 0)
    assert got == want, got
    assert int(sg.count) == sg.host_count.n == 2
    for k, p in card.items():
        ref = cpu[k]
        step = (ref - old[k]).abs().max()
        peak = torch.maximum(ref.abs(), old[k].abs())
        tol = 8 * _ulp(peak, torch.float32) + 1e-4 * step
        err = (p.cpu() - ref).abs()
        assert bool((err <= tol).all()), (k, float(err.max()))
    for part in ("mu", "nu"):
        for k, x in getattr(sc, part).items():
            if x.numel():
                torch.testing.assert_close(
                    getattr(sg, part)[k].cpu(), x, rtol=1e-4,
                    atol=1e-4 * float(x.abs().max()))


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
    # dbrx-132b's head (D 6144, V 100352) and granite-3-8b's padded
    # vocabulary (49155 of 49280 columns), at phase 16's 16 x 256 tokens
    "dbrx_head": (4096, 6144, 100352, 100352, 0.0),
    "granite_padvocab": (4096, 4096, 49280, 49155, 0.05),
    # and the heads of qwen2-7b, deepseek-67b and mistral-large-123b
    "qwen2_head": (4096, 3584, 152064, 152064, 0.0),
    "deepseek67b_head": (4096, 8192, 102400, 102400, 0.0),
    "mistral_large_head": (4096, 12288, 32768, 32768, 0.0),
    # deepseek-v3-671b's head (D 7168, V 129280), phase 17
    "deepseek_v3_head": (4096, 7168, 129280, 129280, 0.0),
    # jamba-1.5-large-398b's head (D 8192, V 65536), phase 19
    "jamba_head": (4096, 8192, 65536, 65536, 0.0),
    # llama-3.2-vision-11b's head (D 4096, V 128256), phase 20, and one of
    # musicgen-medium's 4 codebook heads (D 1536, V 2048), phase 21
    "vlm_head": (4096, 4096, 128256, 128256, 0.0),
    "musicgen_head": (4096, 1536, 2048, 2048, 0.0),
}


def _bwd_routes(X):
    return [dict(f.route_launches) for f in (X.xent_bwd_dh, X.xent_bwd_dw)]


def _route_delta(now, was):
    return {r: now[r] - was[r] for r in was}


def _routes_are(now, was, want):
    """The launches by route since ``was`` are ``want``, 0 on the routes
    it leaves out (the tied head's ``*_t`` routes among them)."""
    return _route_delta(now, was) == {r: want.get(r, 0) for r in was}


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
        assert _routes_are(now, was, want)
    # the forward: aligned bf16 on wgmma (the call and its bitwise rerun),
    # w read through its columns on the FMA kernel; else twice on the FMA
    assert _routes_are(X.xent_fwd.route_launches, fwd_routes,
                       {"wgmma": 2, "fma": 1} if tc else {"fma": 2})


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


# The tied head, w stored (V, D) and read in place (``transposed=True``):
# (N, D, V, vocab_size, share of -1 labels, dtype, h's layout), the
# chip_smoke.py phase-2 cases. Aligned bf16 takes the tensor cores
# (``wgmma_t``, ``mma_t``), f32, a non-contiguous h and a D that is not a
# multiple of 16 the FMA kernels (``fma_t``).
TIED_XENT_CASES = {
    "llama1b_tied": (4096, 2048, 32000, 32000, 0.0, "bf16", "rows"),
    "gemma2b_tied": (4096, 2048, 256000, 256000, 0.05, "bf16", "rows"),
    # V not a multiple of 8, and padded rows of dW
    "v32003_padded": (4096, 2048, 32003, 32000, 0.1, "bf16", "rows"),
    "f32": (1024, 2048, 32000, 31990, 0.1, "f32", "rows"),
    "noncontig_h": (1024, 2048, 32000, 32000, 0.1, "bf16", "h_strided"),
    # two token chunks: the bf16 dW summed across them in (cols, D) f32
    "n140000_d16": (140000, 16, 128, 128, 0.1, "bf16", "rows"),
    "n1_ragged": (1, 96, 264, 260, 0.0, "bf16", "rows"),
    "d80": (300, 80, 1000, 1000, 0.2, "bf16", "rows"),
}


def _tied_inputs(cuda, case, seed=9):
    N, D, V, vs, masked, dt, layout = TIED_XENT_CASES[case]
    td = DTYPES[dt]
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    if layout == "h_strided":  # every other column of a (N, 2D) buffer
        h = torch.stack([h, torch.zeros_like(h)], -1).reshape(N, 2 * D)
        h = h.to(cuda, td)[:, ::2]
    else:
        h = h.to(cuda, td)
    w = torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32)
                         / np.sqrt(D)).to(cuda, td)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < masked] = -1
    gl = torch.from_numpy(rng.random(N).astype(np.float32)).to(cuda)
    return h, w, torch.from_numpy(labels).to(cuda), gl, vs, td


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TIED_XENT_CASES))
def test_tied_xent_kernels_match_plain_on_card(cuda, case):
    """The three kernels with ``transposed=True`` against their plain
    versions (the tolerances of the untied cases), each run twice and
    bitwise equal, dW (V, D) with zero padded rows, every launch on the
    tied head's own routes."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    h, w, labels, gl, vs, td = _tied_inputs(cuda, case)
    tc = X.mma_layout(h, w, transposed=True)
    assert tc == (td == torch.bfloat16 and h.stride(1) == 1
                  and h.shape[1] % 16 == 0)
    fwd_routes = dict(X.xent_fwd.route_launches)
    routes = _bwd_routes(X)
    lse, ll = X.xent_fwd(h, w, labels, vocab_size=vs, transposed=True)
    want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, vocab_size=vs,
                                        transposed=True)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ll, want_ll, atol=1e-4, rtol=1e-5)
    assert (ll[(labels < 0) | (labels >= vs)] == 0).all()
    lse2, ll2 = X.xent_fwd(h, w, labels, vocab_size=vs, transposed=True)
    assert torch.equal(lse, lse2) and torch.equal(ll, ll2)
    n_out = 0
    for out_dtype in {td, torch.float32}:
        for fn, ref in ((X.xent_bwd_dh, XR.xent_bwd_dh_ref),
                        (X.xent_bwd_dw, XR.xent_bwd_dw_ref)):
            kw = {"vocab_size": vs, "out_dtype": out_dtype,
                  "transposed": True}
            got = fn(h, w, labels, want_lse, gl, **kw)
            want = ref(h, w, labels, want_lse, gl, **kw)
            assert got.dtype == out_dtype and got.shape == want.shape
            _xent_close(got, want, out_dtype)
            assert torch.equal(got, fn(h, w, labels, want_lse, gl, **kw))
            if fn is X.xent_bwd_dw:
                assert tuple(got.shape) == tuple(w.shape)
                assert (got[vs:] == 0).all()
        n_out += 1
    torch.cuda.synchronize()
    fwd, bwd = ("wgmma_t", "mma_t") if tc else ("fma_t", "fma_t")
    assert _routes_are(X.xent_fwd.route_launches, fwd_routes, {fwd: 2})
    for now, was in zip(_bwd_routes(X), routes):
        assert _routes_are(now, was, {bwd: 2 * n_out})


@pytest.mark.gpu
def test_tied_xent_makes_no_copy_of_the_embedding(cuda):
    """At llama-1b's tied shape (N 4096, D 2048, V 32000, bf16) no
    transposed call copies w (a copy adds V * D * 2 bytes): the forward's
    rise of ``max_memory_allocated`` stays under half of that; dH's rise,
    less its output and the workspaces the wrapper documents (G's two bf16
    halves of a chunk, dH's f32 sum across chunks), does too; and each
    transposed call rises less than half of it above the untied call on a
    (D, V) copy made beforehand (the two allocate the same buffers, up to
    the allocator's rounding)."""
    from repro_torch.kernels.xent import xent as X
    N, D, V = 4096, 2048, 32000
    rng = np.random.default_rng(10)
    h = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32)
                         ).to(cuda, torch.bfloat16)
    w = (torch.from_numpy(rng.standard_normal((V, D), dtype=np.float32))
         / np.sqrt(D)).to(cuda, torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)
                              ).to(cuda)
    gl = torch.full((N,), 1.0 / N, device=cuda)
    w_dv = w.T.contiguous()
    half = V * D * 2 // 2

    def rise(call):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = call()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base, out

    r_fwd, (lse, _) = rise(lambda: X.xent_fwd(h, w, labels, vocab_size=V,
                                              transposed=True))
    r_fwd_u, _ = rise(lambda: X.xent_fwd(h, w_dv, labels, vocab_size=V))
    assert r_fwd < half and r_fwd - r_fwd_u < half, (r_fwd, r_fwd_u)
    rows, cols = X.chunk_plan(N, V)
    work = 2 * min(N, rows) * cols * 2 + min(N, rows) * D * 4
    for fn in (X.xent_bwd_dh, X.xent_bwd_dw):
        r, out = rise(lambda: fn(h, w, labels, lse, gl, vocab_size=V,
                                 out_dtype=torch.bfloat16, transposed=True))
        r_u, _ = rise(lambda: fn(h, w_dv, labels, lse, gl, vocab_size=V,
                                 out_dtype=torch.bfloat16))
        assert r - r_u < half, (fn.__name__, r, r_u)
        if fn is X.xent_bwd_dh:
            assert r - out.numel() * 2 - work < half, (r, work)
        del out


@pytest.mark.gpu
def test_tied_train_step_on_card_goes_through_the_transposed_kernels(cuda):
    """make_train_step of scale_fused under LabelRules.tied() on a small
    tied llama: per step one of each xent kernel on the tied head's routes
    (``wgmma_t``, ``mma_t``; none on the untied ones), 7 norm_sumsq, 8
    update_apply (the tied embedding takes the momentum branch), one
    momentum_sumsq; the loss falls over four steps and the tied
    embedding's momentum is non-zero."""
    from repro_torch.core import LabelRules, linear_warmup_cosine
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.training import init_state, make_train_step
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16", tie_embeddings=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    assert "lm_head" not in params
    tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-2, 8),
                        rules=LabelRules.tied())
    step = make_train_step(cfg, tx, clip_norm=1.0)
    state = init_state(params, tx)
    batch = make_dataset(cfg, 128, 4, seed=1, device=cuda).global_batch_at(0)
    want = {"xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 7, "update_apply": 8, "momentum_sumsq": 1,
            "norm_apply": 0}
    losses = []
    for i in range(4):
        before = _train_counts()
        fwd_routes = dict(X.xent_fwd.route_launches)
        routes = _bwd_routes(X)
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        after = _train_counts()
        assert {k: after[k] - before[k] for k in want} == want, i
        assert _routes_are(X.xent_fwd.route_launches, fwd_routes,
                           {"wgmma_t": 1}), i
        for now, was in zip(_bwd_routes(X), routes):
            assert _routes_are(now, was, {"mma_t": 1}), i
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert float(state.opt_state.mu["tok_embed/w"].float().abs().sum()) > 0


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
    # dbrx-132b's, mistral-large-123b's, qwen2-7b's and deepseek-67b's GQA
    # at hd 128 (phase 16)
    "train_dbrx_gqa48x8_hd128": (16, 256, 256, 48, 8, 128, True, None),
    "train_mistral_gqa96x8_hd128": (16, 256, 256, 96, 8, 128, True, None),
    "train_qwen2_gqa28x4_hd128": (16, 256, 256, 28, 4, 128, True, None),
    "train_deepseek67b_gqa64x8_hd128": (16, 256, 256, 64, 8, 128, True,
                                        None),
    # jamba-1.5-large-398b's at its train batch of 4 x 1024 (phase 19)
    "train_jamba_gqa64x8_hd128": (4, 1024, 1024, 64, 8, 128, True, None),
    # llama-3.2-vision-11b's cross-attention (non-causal, 1024 queries over
    # 4096 image keys) and self-attention, musicgen-medium's (phases 20-21)
    "cross_vlm_gqa32x8_1024x4096": (4, 1024, 4096, 32, 8, 128, False, None),
    "train_vlm_gqa32x8_hd128": (4, 1024, 1024, 32, 8, 128, True, None),
    "train_musicgen_h24_hd64": (4, 1024, 1024, 24, 24, 64, True, None),
    # one rank's share of the cross-attention on a (1, 2) mesh (phase 24)
    "cross_vlm_rank_gqa16x4_1024x4096": (4, 1024, 4096, 16, 4, 128, False,
                                         None),
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
        assert _routes_are(X.xent_fwd.route_launches, fwd_routes,
                           {"wgmma": 1}), i
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
    assert _routes_are(X.xent_fwd.route_launches, fwd_routes, {"wgmma": 1})
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


@pytest.mark.gpu
def test_guarded_skip_on_card_is_bitwise_and_does_not_synchronise(cuda):
    """The anomaly guard around the in-place kernels: scale_fused (clip
    1.0) with nan_grad@1 over 3 steps on a small bf16 llama equals, bitwise
    (params, optimizer state, the guard's EMA), the clean run over the
    batches of steps 0 and 2; every step launches the training step's
    kernels (update_apply and momentum_sumsq write theta and the head's
    momentum in place before the verdict is applied); one guarded step
    runs under set_sync_debug_mode("error"); and a checkpoint of the
    guarded state restores onto the card bitwise."""
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch.checkpoint.checkpointer import named_leaves
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.training import (GuardPolicy, init_state,
                                      make_train_step, parse_faults)
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16")
    ds = make_dataset(cfg, 128, 4, seed=1, device=cuda)
    batches = [ds.global_batch_at(i) for i in range(3)]

    def run(ids, plan=None):
        tx = make_optimizer("scale_fused", 1e-2)
        params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
        state = init_state(params, tx, guard=True)
        step = make_train_step(cfg, tx, clip_norm=1.0, guard=GuardPolicy(),
                               faults=plan)
        m = None
        for i in ids:
            before = _train_counts()
            state, m = step(state, batches[i])
            after = _train_counts()
            assert after["update_apply"] - before["update_apply"] == 9
            assert after["momentum_sumsq"] - before["momentum_sumsq"] == 1
        return state, m, step

    faulted, m, step = run(range(3), parse_faults("nan_grad@1"))
    clean, _, _ = run([0, 2])
    assert int(m["skipped"]) == 1
    a = dict(named_leaves(faulted._replace(step=None, guard=faulted.guard._replace(
        skipped=None))))
    b = dict(named_leaves(clean._replace(step=None, guard=clean.guard._replace(
        skipped=None))))
    assert list(a) == list(b)
    for k, x in a.items():
        assert torch.equal(x, b[k]), k
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        faulted, m = step(faulted, batches[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(m["bad_step"]) == 0
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 4, faulted)
        back, n = ckpt.restore_latest(d, faulted)
        assert n == 4
        for (k, x), (_, y) in zip(named_leaves(faulted), named_leaves(back)):
            assert y.device == x.device and torch.equal(x, y), k


# ------------------------------------------------------ the segment clause

# (B, S, T, H, K, hd, hdv, causal, ids): chip_smoke.py phase 2's segment
# cases. "packed": a packed SyntheticLM batch's segment_ids for q and kv;
# "separate": sorted q and kv ids of their own, q rows 10-12 (the last row
# below 13) given an id no key has; "random": unsorted ids in [0, 3]
SEG_CASES = {
    "packed_train_llama1b": (16, 256, 256, 32, 32, 64, 64, True, "packed"),
    "packed_hd128": (4, 256, 256, 8, 8, 128, 128, True, "packed"),
    "packed_gqa_ragged250": (4, 250, 250, 14, 2, 64, 64, True, "packed"),
    "packed_hd256_k1": (4, 256, 256, 8, 1, 256, 256, True, "packed"),
    "packed_hd64_hdv128": (4, 200, 200, 8, 4, 64, 128, True, "packed"),
    "separate_noncausal_100x300": (4, 100, 300, 8, 8, 64, 64, False,
                                   "separate"),
    "separate_decode_3x300": (8, 3, 300, 12, 12, 64, 64, False, "separate"),
    "unsorted": (4, 256, 256, 8, 8, 64, 64, True, "random"),
    "unsorted_hd128_ragged": (2, 200, 200, 4, 4, 128, 128, True, "random"),
}


def _orphans(S):
    return slice(10, 13) if S > 12 else slice(S - 1, S)


def _seg_ids(cuda, kind, B, S, T, seed=3):
    """The (q_seg, kv_seg) int32 pair of a SEG_CASES kind, on the card."""
    rng = np.random.default_rng(seed)
    if kind == "packed":
        from repro_torch.data import make_dataset
        from repro_torch.models import ModelConfig
        cfg = ModelConfig(name="gpu", n_layers=1, d_model=64, n_heads=4,
                          n_kv_heads=4, d_ff=128, vocab_size=1000)
        ids = make_dataset(cfg, S, B, seed=seed, pack_documents=True,
                           device=cuda).global_batch_at(0)["segment_ids"]
        return ids, ids
    if kind == "random":
        ids = torch.from_numpy(rng.integers(0, 4, (B, S), dtype=np.int32))
        return ids.to(cuda), ids.to(cuda)
    q = np.sort(rng.integers(1, 5, (B, S), dtype=np.int32), 1)
    kv = np.sort(rng.integers(1, 5, (B, T), dtype=np.int32), 1)
    q[:, _orphans(S)] = 7
    return torch.from_numpy(q).to(cuda), torch.from_numpy(kv).to(cuda)


def _seg_inputs(cuda, B, S, T, H, K, hd, hdv, causal, segs, td, seed=4):
    """(q, k, v, dout, lse, delta, None), lse and delta from the plain
    forward under the segment clause."""
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(cuda, td)
    q, k, v, do = rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hdv), \
        rnd(B, S, H, hdv)
    out, lse = mha_fwd_ref(q, k, v, scale=hd ** -0.5, causal=causal,
                           segments=segs)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta, None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_clause_matches_plain_on_card(cuda, case, dtype):
    """The three kernels with segment ids against their plain versions
    under the dense mask (the attention tolerances above), each on the
    route its wrapper picks (mma for bf16 heads of 64 and 128 past S = 4,
    decode at S <= 4, fma else), counted by route and in
    ``segment_launches``, bitwise repeatable; a query whose id no key has
    gives 0, an lse below -1e29 and a dQ of 0, and its dO moves no dK or
    dV."""
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    B, S, T, H, K, hd, hdv, causal, kind = SEG_CASES[case]
    td = DTYPES[dtype]
    segs = _seg_ids(cuda, kind, B, S, T)
    args = _seg_inputs(cuda, B, S, T, H, K, hd, hdv, causal, segs, td)
    q, k, v = args[:3]
    kw = dict(scale=hd ** -0.5, causal=causal, segments=segs)
    froute, broute = A._fwd_route(q, k, v), A._bwd_route(q, k, v)
    assert froute == ("decode" if S <= 4 else "mma" if dtype == "bf16"
                      and hd == hdv and hd in (64, 128) else "fma")
    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv)
    before = [(f.segment_launches, dict(f.route_launches)) for f in fns]
    out, lse = A.mha_fwd(q, k, v, **kw)
    dq = A.mha_bwd_dq(*args, **kw)
    dk, dv = A.mha_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    for f, (n, routes), r in zip(fns, before, (froute, broute, broute)):
        assert f.segment_launches == n + 1
        assert f.route_launches == {**routes, r: routes[r] + 1}
    ref, ref_lse = mha_fwd_ref(q, k, v, **kw)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    rows = ref_lse > -1e29
    torch.testing.assert_close(lse[rows], ref_lse[rows], atol=1e-4, rtol=1e-5)
    assert bool((lse[~rows] <= -1e29).all())
    _bwd_close(dq, mha_bwd_dq_ref(*args, **kw), dtype)
    want_dk, want_dv = mha_bwd_dkv_ref(*args, **kw)
    _bwd_close(dk, want_dk, dtype)
    _bwd_close(dv, want_dv, dtype)
    again = (*A.mha_fwd(q, k, v, **kw), A.mha_bwd_dq(*args, **kw),
             *A.mha_bwd_dkv(*args, **kw))
    for a, b in zip((out, lse, dq, dk, dv), again):
        assert torch.equal(a, b)
    if kind == "separate":
        o = _orphans(S)
        assert bool((out[:, o] == 0).all()) and bool((dq[:, o] == 0).all())
        assert bool((lse[..., o] <= -1e29).all())
        do2 = args[3].clone()
        do2[:, o] = 3 * do2[:, o] + 1
        dk2, dv2 = A.mha_bwd_dkv(*args[:3], do2, *args[4:], **kw)
        assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


# (B, S, T, H, K, hd, causal, dtype): one case a route
SEG_EQUAL_CASES = {
    "mma_hd64": (16, 256, 256, 32, 32, 64, True, "bf16"),
    "mma_hd128_ragged": (4, 200, 200, 8, 8, 128, True, "bf16"),
    "fma_f32": (4, 256, 256, 8, 4, 64, True, "f32"),
    "fma_hd256_k1": (4, 256, 256, 8, 1, 256, True, "bf16"),
    "decode_2x300": (8, 2, 300, 12, 12, 64, False, "bf16"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SEG_EQUAL_CASES))
def test_all_equal_segment_ids_are_bitwise_no_segments(cuda, case):
    """Ids that are one value everywhere give bitwise the kernels'
    result without segments, forward and backward, on every route."""
    from repro_torch.kernels.attention import attention as A
    B, S, T, H, K, hd, causal, dtype = SEG_EQUAL_CASES[case]
    args = _seg_inputs(cuda, B, S, T, H, K, hd, hd, causal, None,
                       DTYPES[dtype])
    q, k, v = args[:3]
    ones = (torch.full((B, S), 5, dtype=torch.int32, device=cuda),
            torch.full((B, T), 5, dtype=torch.int32, device=cuda))
    got = []
    for segs in (None, ones):
        kw = dict(scale=hd ** -0.5, causal=causal, segments=segs)
        got.append((*A.mha_fwd(q, k, v, **kw), A.mha_bwd_dq(*args, **kw),
                    *A.mha_bwd_dkv(*args, **kw)))
    torch.cuda.synchronize()
    for a, b in zip(*got):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_segment_operands_the_kernels_do_not_take_raise_on_card(cuda):
    """On CUDA tensors: int64 ids, ids with kv_len and non-contiguous ids
    raise before any launch; nothing goes to the plain version."""
    from repro_torch.kernels.attention import attention as A
    B, S, H, hd = 2, 64, 4, 64
    q = torch.zeros(B, S, H, hd, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(B, H, S, device=cuda)
    ids = torch.ones(B, S, dtype=torch.int32, device=cuda)
    wide = torch.ones(B, 2 * S, dtype=torch.int32, device=cuda)[:, ::2]
    before = [(f.launches, f.segment_launches)
              for f in (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv)]
    for match, kw in (("int32", dict(segments=(ids.long(), ids))),
                      ("mutually exclusive", dict(segments=(ids, ids),
                                                  kv_len=S, causal=False)),
                      ("contiguous", dict(segments=(wide, ids)))):
        kw = {"scale": 0.125, "causal": True, **kw}
        with pytest.raises(ValueError, match=match):
            A.mha_fwd(q, q, q, **kw)
        with pytest.raises(ValueError, match=match):
            A.mha_bwd_dq(q, q, q, q, lse, lse, **kw)
        with pytest.raises(ValueError, match=match):
            A.mha_bwd_dkv(q, q, q, q, lse, lse, **kw)
    assert before == [(f.launches, f.segment_launches)
                      for f in (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv)]


@pytest.mark.gpu
def test_packed_llama130m_train_step_on_card(cuda, monkeypatch):
    """make_train_step of scale_fused (clip 1.0, remat full) on llama-130m
    at full width and depth with packed batches (4 x 128): per step 2L
    mha_fwd, L of each backward kernel, all on mma and all with segments,
    one of each xent kernel and 8/9/1 optimizer kernels; the loss falls
    over three steps; one loss-and-grad against plain attention's
    autograd, per leaf within 5e-2 relative in norm (chip_smoke.py's bf16
    gradient tolerance: roundings of the attention outputs differ and
    compound through the layers)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import linear_warmup_cosine, make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import attention as A
    from repro_torch.models import init_params
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    cfg = get_arch("llama-130m")
    L = cfg.n_layers
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    ds = make_dataset(cfg, 128, 4, seed=1, pack_documents=True, device=cuda)
    batch = ds.global_batch_at(0)
    assert int(batch["segment_ids"].max()) >= 2
    _, _, grads = value_and_grad(params, cfg, batch)
    with monkeypatch.context() as m:
        m.setattr(dispatch, "mha_fwd", mha_fwd_ref)
        _, _, ref = value_and_grad(params, cfg, batch)
    for k, g in grads.items():
        rel = ((g.float() - ref[k].float()).norm()
               / ref[k].float().norm().clamp_min(1e-30)).item()
        assert rel <= 5e-2, (k, rel)
    tx = make_optimizer("scale_fused", linear_warmup_cosine(1e-2, 8))
    step = make_train_step(cfg, tx, clip_norm=1.0)
    state = init_state(params, tx)
    want = {"mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L,
            "xent_fwd": 1, "xent_bwd_dh": 1, "xent_bwd_dw": 1,
            "norm_sumsq": 8, "update_apply": 9, "momentum_sumsq": 1,
            "norm_apply": 0}
    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv)
    losses = []
    for i in range(3):
        before = _train_counts()
        segs = [f.segment_launches for f in fns]
        routes = [dict(f.route_launches) for f in fns]
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        after = _train_counts()
        assert {k: after[k] - before[k] for k in want} == want, i
        assert [f.segment_launches - n for f, n in zip(fns, segs)] == [
            2 * L, L, L], i
        for f, was, n in zip(fns, routes, (2 * L, L, L)):
            assert _routes_are(f.route_launches, was, {"mma": n}), i
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


# ------------------------------------------------------ the telemetry plane

def _stats_inputs(device, seed=0):
    """A small bf16 llama's params, a step's worth of gradients of unit
    scale (heavy-tailed across columns) and new params, on ``device``."""
    from repro_torch.core import make_optimizer
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.models.model import flatten
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16")
    params = flatten(init_params(cfg, torch.Generator().manual_seed(seed),
                                 device="cpu"))
    rng = np.random.default_rng(seed)
    grads = {k: torch.from_numpy(
        rng.standard_normal(p.shape).astype(np.float32)
        * np.exp(rng.standard_normal(p.shape[-1:])).astype(np.float32)
    ).to(p.dtype) for k, p in params.items()}
    new = {k: p + 1e-2 * torch.randn(p.shape, generator=torch.Generator(
        ).manual_seed(1)).to(p.dtype) for k, p in params.items()}
    tx = make_optimizer("scale_fused", 1e-2)
    state = tx.init(params)
    state = state._replace(mu={k: m.normal_(generator=torch.Generator(
        ).manual_seed(2)) for k, m in state.mu.items()})

    def to(tree):
        return {k: v.to(device) for k, v in tree.items()}
    return (to(grads), to(params), to(new),
            state._replace(count=state.count.to(device), mu=to(state.mu),
                           nu=to(state.nu)))


@pytest.mark.gpu
def test_stats_on_card_equal_the_plain_version(cuda):
    """The statistics collector on the card (the column sums through the
    norm_sumsq kernel, one launch a leaf of two or more dimensions) equals
    the same collector on the CPU (norm_sumsq's plain version): 2e-5
    relative, the sums of squares' tolerance."""
    from repro_torch.kernels.colnorm import colnorm as C
    from repro_torch.obs import StatsPolicy, make_stats_fn
    fn = make_stats_fn(StatsPolicy(every_k=1))
    cpu = fn(1, *_stats_inputs("cpu"))
    args = _stats_inputs(cuda)
    n0 = C.norm_sumsq.launches
    got = fn(1, *args)
    torch.cuda.synchronize()
    assert C.norm_sumsq.launches - n0 == sum(
        1 for g in args[0].values() if g.ndim >= 2)
    assert set(got) == set(cpu)
    for k, v in cpu.items():
        assert got[k].device.type == "cuda", k
        np.testing.assert_allclose(float(got[k]), float(v), rtol=2e-5,
                                   err_msg=k)
    assert float(got["stats/lm_head/colnorm_disp"]) > 1.0


@pytest.mark.gpu
def test_device_memory_reads_the_card(cuda):
    from repro_torch.obs import device_memory
    x = torch.empty(1 << 20, device=cuda)
    m = device_memory("cuda")
    i = torch.cuda.current_device()
    assert set(m) == {f"mem/dev{i}/bytes_in_use", f"mem/dev{i}/peak_bytes",
                      "mem/total_bytes_in_use", "mem/total_peak_bytes"}
    assert m[f"mem/dev{i}/peak_bytes"] >= m[f"mem/dev{i}/bytes_in_use"] \
        >= x.numel() * 4
    assert device_memory(cuda) == device_memory("cuda")
    del x


@pytest.mark.gpu
def test_stats_step_on_card_does_not_synchronise(cuda):
    """A guarded train step with the collector on its cadence runs under
    set_sync_debug_mode("error"), its stats finite; the run stays bitwise
    the run without stats."""
    from repro_torch.checkpoint.checkpointer import named_leaves
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.obs import StatsPolicy
    from repro_torch.training import GuardPolicy, init_state, make_train_step
    cfg = ModelConfig(name="gpu", n_layers=2, d_model=256, n_heads=4,
                      n_kv_heads=2, d_ff=512, vocab_size=1000,
                      dtype="bfloat16")
    ds = make_dataset(cfg, 128, 4, seed=1, device=cuda)
    batches = [ds.global_batch_at(i) for i in range(2)]
    runs = []
    for stats in (None, StatsPolicy(every_k=2)):
        tx = make_optimizer("scale_fused", 1e-2)
        state = init_state(init_params(
            cfg, torch.Generator(device=cuda).manual_seed(0), device=cuda),
            tx, guard=True)
        step = make_train_step(cfg, tx, clip_norm=1.0, guard=GuardPolicy(),
                               stats=stats)
        state, m = step(state, batches[0])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, m = step(state, batches[1])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        runs.append((dict(named_leaves(state)), m))
    (a, _), (b, m) = runs
    assert float(m["stats/valid"]) == 1.0
    assert all(bool(torch.isfinite(v)) for k, v in m.items())
    for k, x in a.items():
        assert torch.equal(x, b[k]), k


# Vocabulary shards (``col_offset``) of llama-1b's head (N 4096, D 2048, V
# 32000, bf16), untied (w's column slices: views with row stride V) and
# tied (row slices), cut into 2 and 4 shards; f32 on the FMA kernels; a
# padded vocabulary (vocab_size 24000) whose last of 4 shards holds no
# valid column (the wrappers' ``empty`` route). Labels are global ids, a
# tenth -1. (N, D, V, vocab_size, shards, tied, dtype)
SHARD_CASES = {
    "llama1b_2": (4096, 2048, 32000, 32000, 2, False, "bf16"),
    "llama1b_4": (4096, 2048, 32000, 32000, 4, False, "bf16"),
    "llama1b_tied_2": (4096, 2048, 32000, 32000, 2, True, "bf16"),
    "llama1b_tied_4": (4096, 2048, 32000, 32000, 4, True, "bf16"),
    "f32_4": (300, 2048, 32000, 32000, 4, False, "f32"),
    "f32_tied_4": (300, 2048, 32000, 32000, 4, True, "f32"),
    "padded_empty_4": (1000, 2048, 32000, 24000, 4, False, "bf16"),
    # a musicgen-medium codebook head (N 4 x 1024, D 1536, V 2048) in the
    # two shards of a (1, 2) mesh, at col_offset 0 and 1024 (phase 24)
    "musicgen_head_2": (4096, 1536, 2048, 2048, 2, False, "bf16"),
    "musicgen_head_f32_2": (4096, 1536, 2048, 2048, 2, False, "f32"),
}


def _shards(cuda, case, seed=9):
    N, D, V, vs, k, tied, dt = SHARD_CASES[case]
    td = DTYPES[dt]
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((N, D), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((D, V), dtype=np.float32)
                         / np.sqrt(D))
    w = w.T.contiguous() if tied else w
    labels = rng.integers(0, vs, N).astype(np.int32)
    labels[rng.random(N) < 0.1] = -1
    gl = torch.from_numpy(rng.random(N).astype(np.float32))
    h, w = h.to(cuda, td), w.to(cuda, td)
    v = V // k
    cut = [w[i * v:(i + 1) * v] if tied else w[:, i * v:(i + 1) * v]
           for i in range(k)]
    return (h, w, torch.from_numpy(labels).to(cuda), gl.to(cuda), vs, tied,
            [(i * v, s) for i, s in enumerate(cut)])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SHARD_CASES))
def test_xent_col_offset_kernels_match_plain_on_card(cuda, case):
    """Each shard's three kernels with its col_offset against the plain
    versions (phase 2's tolerances), each twice and bitwise equal, on the
    route ``mma_layout`` picks (a shard of the padded vocabulary past
    vocab_size on ``empty``: lse -inf, ll 0, zero dH and dW, no kernel),
    every launch counted in ``offset_launches`` but shard 0's."""
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    h, _, labels, gl, vs, tied, shards = _shards(cuda, case)
    fns = (X.xent_fwd, X.xent_bwd_dh, X.xent_bwd_dw)
    offs = [f.offset_launches for f in fns]
    fwd_routes, routes = dict(X.xent_fwd.route_launches), _bwd_routes(X)
    n_launch, n_empty = 0, 0
    for off, w in shards:
        kw = {"vocab_size": vs, "col_offset": off, "transposed": tied}
        lse, ll = X.xent_fwd(h, w, labels, **kw)
        want_lse, want_ll = XR.xent_fwd_ref(h, w, labels, **kw)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        torch.testing.assert_close(ll, want_ll, atol=1e-4, rtol=1e-5)
        v = w.shape[0 if tied else 1]
        mine = (labels >= off) & (labels < min(off + v, vs))
        assert (ll[~mine] == 0).all()
        lse2, ll2 = X.xent_fwd(h, w, labels, **kw)
        assert torch.equal(lse, lse2) and torch.equal(ll, ll2)
        empty = off >= vs
        if empty:
            assert torch.isneginf(lse).all() and (ll == 0).all()
        for out_dtype in {h.dtype, torch.float32}:
            for fn, ref in ((X.xent_bwd_dh, XR.xent_bwd_dh_ref),
                            (X.xent_bwd_dw, XR.xent_bwd_dw_ref)):
                got = fn(h, w, labels, want_lse, gl, out_dtype=out_dtype,
                         **kw)
                want = ref(h, w, labels, want_lse, gl, out_dtype=out_dtype,
                           **kw)
                assert got.dtype == out_dtype and got.shape == want.shape
                _xent_close(got, want, out_dtype)
                assert torch.equal(got, fn(h, w, labels, want_lse, gl,
                                           out_dtype=out_dtype, **kw))
                if empty:
                    assert (got == 0).all()
        n_outs = len({h.dtype, torch.float32})
        n_empty += empty
        n_launch += 0 if empty else 1
    torch.cuda.synchronize()
    tc = X.mma_layout(h, shards[0][1], tied)
    assert tc == (h.dtype == torch.bfloat16)
    fwd = ("wgmma" if tc else "fma") + "_t" * tied
    bwd = ("mma" if tc else "fma") + "_t" * tied
    assert _routes_are(X.xent_fwd.route_launches, fwd_routes,
                       {fwd: 2 * n_launch, "empty": 2 * n_empty})
    for now, was in zip(_bwd_routes(X), routes):
        assert _routes_are(now, was, {bwd: 2 * n_outs * n_launch,
                                      "empty": 2 * n_outs * n_empty})
    # shard 0 (col_offset 0) and the empty shard count no offset launch
    n_off = n_launch - 1
    assert [f.offset_launches - o for f, o in zip(fns, offs)] == [
        2 * n_off, 2 * n_outs * n_off, 2 * n_outs * n_off]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["llama1b_4", "llama1b_tied_2",
                                  "padded_empty_4"])
def test_xent_col_offset_shards_combine_to_the_whole_head_on_card(cuda,
                                                                   case):
    """The shards' (lse, ll) combined (max, then the log of the summed
    exps; ll summed), their f32 dH summed and their dW put together equal
    the unsharded kernels on the whole head (f32 sums in another order:
    phase 2's f32 tolerances)."""
    from repro_torch.kernels.xent import xent as X
    h, w, labels, gl, vs, tied, shards = _shards(cuda, case, seed=10)
    parts = [X.xent_fwd(h, s, labels, vocab_size=vs, col_offset=off,
                        transposed=tied) for off, s in shards]
    lse_k = torch.stack([p[0] for p in parts])
    m = lse_k.max(0).values
    lse = m + torch.log(torch.exp(lse_k - m).sum(0))
    ll = torch.stack([p[1] for p in parts]).sum(0)
    want_lse, want_ll = X.xent_fwd(h, w, labels, vocab_size=vs,
                                   transposed=tied)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(ll, want_ll, atol=1e-4, rtol=1e-5)
    kw = dict(vocab_size=vs, transposed=tied, out_dtype=torch.float32)
    dh = sum(X.xent_bwd_dh(h, s, labels, want_lse, gl, col_offset=off, **kw)
             for off, s in shards)
    dw = torch.cat([X.xent_bwd_dw(h, s, labels, want_lse, gl,
                                  col_offset=off, **kw)
                    for off, s in shards], 0 if tied else 1)
    _xent_close(dh, X.xent_bwd_dh(h, w, labels, want_lse, gl, **kw),
                torch.float32)
    _xent_close(dw, X.xent_bwd_dw(h, w, labels, want_lse, gl, **kw),
                torch.float32)


@pytest.fixture
def world1(cuda):
    """A process group of one rank (gloo) and a (1, 1) mesh on the card."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1, 1, device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_xent_loss_on_card(cuda, world1):
    """On a (1, 1) mesh the sharded ``xent_loss`` (tokens over data, the
    vocabulary over model, as the rules lay llama's head out) runs the
    same kernels as the unsharded call, bitwise; a layout the plans send
    to "ref" (tokens and vocabulary on one axis) raises on the card and
    names it, running no plain version."""
    from repro_torch.kernels import dispatch
    from repro_torch.models.sharding import P, Rules, full_value, place
    h, w, labels, _, vs, _, _ = _shards(cuda, "llama1b_2", seed=11)
    h = h.reshape(16, 256, -1)
    labels = labels.reshape(16, 256)
    rules = Rules()
    h_sh = rules.sharding(("act_batch", "act_seq", "act_embed"), world1,
                          h.shape)
    w_sh = rules.sharding(("embed", "vocab"), world1, w.shape)
    assert dispatch.xent_route(h.shape, w.shape, h_sh, w_sh)[1] == \
        dispatch.XentPlan(world1, ("data",), ("model",))
    hd = place(h, h_sh).detach().requires_grad_()
    wd = place(w, w_sh).detach().requires_grad_()
    got = dispatch.xent_loss(hd, wd, labels, vocab_size=vs)
    gh, gw = torch.autograd.grad(got.sum(), [hd, wd])
    h0, w0 = (x.detach().requires_grad_() for x in (h, w))
    want = dispatch.xent_loss(h0, w0, labels, vocab_size=vs)
    wh, ww = torch.autograd.grad(want.sum(), [h0, w0])
    assert torch.equal(full_value(got), want)
    assert torch.equal(full_value(gh), wh) and torch.equal(full_value(gw),
                                                           ww)
    with pytest.raises(NotImplementedError, match="no kernel plan"):
        dispatch.xent_loss(hd, wd, labels, vocab_size=vs,
                           h_sharding=h_sh._replace(spec=P("model")))


# apply_moe on the card, f32, against the same call on CPU tensors: the
# router's inputs are dyadic (small integers over powers of two), so its
# logits are exact on both devices and both route every (token, choice)
# alike; the rest are f32 products summed in other orders (cuBLAS against
# the CPU's BLAS, TF32 off): 1e-5 absolute + 1e-5 relative on unit-scale
# outputs, and 1e-5 of each gradient's largest |value|.
MOE_CASES = {
    # (B, S, D, E, k, F, capacity_factor, moe_group_size, n_shared)
    "dbrx_like_two_groups": (4, 64, 64, 16, 4, 96, 1.25, 128, 0),
    "drop_cf1_shared": (2, 48, 32, 4, 2, 48, 1.0, 2048, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_on_card_matches_cpu(cuda, case):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import apply_moe, moe_spec
    B, S, D, E, k, Fd, cf, gs, ns = MOE_CASES[case]
    cfg = ModelConfig(family="moe", d_model=D, n_experts=E, top_k=k,
                      moe_d_ff=Fd, capacity_factor=cf, moe_group_size=gs,
                      n_shared_experts=ns, dtype="float32")
    rng = np.random.default_rng(12)
    p = {}
    for name, spec in moe_spec(cfg).items():
        if name == "router":
            p[name] = np.round(rng.standard_normal(spec.shape) * 8) / 64
        else:
            p[name] = rng.standard_normal(spec.shape) / np.sqrt(
                spec.shape[-2])
    x = np.round(rng.standard_normal((B, S, D)) * 4) / 4
    r = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", cuda)):
        leaves = {n: torch.tensor(v, dtype=torch.float32, device=dev)
                  .requires_grad_() for n, v in p.items()}
        xt = torch.tensor(x, dtype=torch.float32, device=dev).requires_grad_()
        y, aux = apply_moe(leaves, cfg, xt)
        g = torch.autograd.grad((y * r.to(dev)).sum() + aux,
                                [xt, *leaves.values()])
        out[key] = [t.detach().cpu() for t in (y, aux, *g)]
    (y, aux, *g), (wy, waux, *wg) = out["card"], out["cpu"]
    torch.testing.assert_close(y, wy, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(aux, waux, atol=0, rtol=1e-5)
    for got, want in zip(g, wg):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


# moe_local, the expert-parallel route's local computation, on the card in
# two "virtual ranks" of one process: each runs half the experts on the
# same groups with the plain reducer (``MOE_LOCAL``), the partial outputs
# are summed here, and autograd sums the partial gradients of the shared
# groups and router where the ranks' eager all-reduce would. The aux is
# taken from one rank (every rank routes alike and forms the same one),
# weighted 1.0 so its gradient shows in the router's. Against
# ``apply_moe`` on the same card tensors: the routing and the aux are the
# same operations (bitwise); y and the gradients are sums of the same
# products split in two, so f32 agrees to 1e-5 of each tensor's largest
# |value| and bf16 to 2e-2 of it + 2e-2 relative (the partials round to
# bf16 before their sum: ``tests/test_torch_moe.py``'s bf16 bounds).
MOE_LOCAL_CASE = (4, 64, 64, 8, 2, 96, 1.25, 128)  # B S D E k F cf group


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_local_virtual_ranks_match_apply_moe_on_card(cuda, dtype):
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.layers import (apply_moe, moe_groups, moe_local,
                                           moe_spec)
    B, S, D, E, k, Fd, cf, gs = MOE_LOCAL_CASE
    td = DTYPES[dtype]
    cfg = ModelConfig(family="moe", d_model=D, n_experts=E, top_k=k,
                      moe_d_ff=Fd, capacity_factor=cf, moe_group_size=gs,
                      dtype={torch.float32: "float32",
                             torch.bfloat16: "bfloat16"}[td])
    G, Tg, _ = moe_groups(cfg, B * S)
    assert G == 2
    rng = np.random.default_rng(13)
    p = {n: torch.tensor(np.round(rng.standard_normal(s.shape) * 8) / 64
                         if n == "router" else
                         rng.standard_normal(s.shape) / np.sqrt(s.shape[-2]),
                         dtype=torch.float32).to(cuda, td)
         for n, s in moe_spec(cfg).items()}
    x = torch.tensor(np.round(rng.standard_normal((B, S, D)) * 4) / 4,
                     dtype=torch.float32).to(cuda, td)
    r = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.float32,
                     device=cuda)

    def run(split):
        leaves = {n: v.clone().requires_grad_() for n, v in p.items()}
        xt = x.clone().requires_grad_()
        if split:
            half, ys, auxs = E // 2, [], []
            for rank in range(2):
                sl = slice(rank * half, (rank + 1) * half)
                pl = {"router": leaves["router"],
                      **{n: leaves[n][sl] for n in
                         ("w_gate", "w_up", "w_down")}}
                y, aux = moe_local(pl, cfg, xt.reshape(G, Tg, D),
                                   (sl.start, sl.stop))
                ys.append(y)
                auxs.append(aux)
            assert torch.equal(auxs[0], auxs[1])
            y, aux = (ys[0] + ys[1]).reshape(B, S, D), auxs[0]
        else:
            y, aux = apply_moe(leaves, cfg, xt)
        g = torch.autograd.grad((y.float() * r).sum() + aux,
                                [xt, *leaves.values()])
        return [t.detach().float().cpu() for t in (y, aux, *g)]

    (y, aux, *g), (wy, waux, *wg) = run(True), run(False)
    assert torch.equal(aux, waux)
    f32 = td == torch.float32
    for got, want in zip((y, *g), (wy, *wg)):
        scale = want.abs().max().item()
        torch.testing.assert_close(
            got, want, atol=(1e-5 if f32 else 2e-2) * scale,
            rtol=0 if f32 else 2e-2)


# MLA (deepseek-v3): queries and keys 128 + 64 wide, values 128, as many kv
# heads as query heads: (B, S, T, H, K, hd, hdv), causal, every kernel on
# the fma route. The forward at the tolerances above; the backward pair
# with lse and delta from the plain forward at _bwd_close's.
MLA_CASES = {
    "mla_b2_h128": (2, 256, 256, 128, 128, 192, 128),
    "mla_ragged200_h16": (2, 200, 200, 16, 16, 192, 128),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MLA_CASES))
def test_mla_attention_kernels_match_plain_on_card(cuda, case, dtype):
    from repro_torch.kernels.attention.attention import (_bwd_route,
                                                         mha_bwd_dkv,
                                                         mha_bwd_dq)
    from repro_torch.kernels.attention.ref import (mha_bwd_dkv_ref,
                                                   mha_bwd_dq_ref)
    B, S, T, H, K, hd, hdv = MLA_CASES[case]
    td = DTYPES[dtype]
    rng = np.random.default_rng(11)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                    ).to(cuda, td)
                   for shape in ((B, S, H, hd), (B, T, K, hd), (B, T, K, hdv),
                                 (B, S, H, hdv)))
    kw = dict(scale=hd ** -0.5, causal=True)
    assert (_fwd_route(q, k, v), _bwd_route(q, k, v)) == ("fma", "fma")
    fns = (mha_fwd, mha_bwd_dq, mha_bwd_dkv)
    before = [dict(f.route_launches) for f in fns]
    out, lse = mha_fwd(q, k, v, None, **kw)
    ref, ref_lse = mha_fwd_ref(q, k, v, None, **kw)
    assert out.shape == (B, S, H, hdv)
    atol, rtol = _tol(dtype)
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    delta = (do.float() * ref.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, ref_lse, delta, None)
    dq = mha_bwd_dq(*args, **kw)
    dk, dv = mha_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    for f, was in zip(fns, before):
        assert f.route_launches == {**was, "fma": was["fma"] + 1}, f.__name__
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    _bwd_close(dq, mha_bwd_dq_ref(*args, **kw), dtype)
    want_dk, want_dv = mha_bwd_dkv_ref(*args, **kw)
    _bwd_close(dk, want_dk, dtype)
    _bwd_close(dv, want_dv, dtype)
    assert torch.equal(dq, mha_bwd_dq(*args, **kw))


@pytest.mark.gpu
def test_v3_smoke_train_step_on_card_matches_plain_route(cuda, monkeypatch):
    """deepseek-v3's SMOKE twin (f32: MLA with hd 48 != hdv 32 on fma, a
    dense then two MoE layers): one loss-and-grad against the same call
    with attention and xent through their plain versions (per leaf, 1e-4
    of its largest |gradient|: f32 sums in other orders), then one
    ``scale_fused`` step from the same params on each route, the plain one
    with the optimizer's kernels through their plain versions too: per step 2L
    mha_fwd, L of each backward kernel (all fma), one of each xent kernel
    (fma), 18 norm_sumsq, 19 update_apply, one momentum_sumsq (the 4-D
    expert leaves take the plain stage route); the metrics within 1e-4
    relative and every leaf within 1e-3 of its largest step."""
    from repro_torch.configs import get_arch
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head.ref import momentum_sumsq_ref
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.models import init_params
    from repro_torch.models.model import flatten
    from repro_torch.training import (init_state, make_train_step,
                                      value_and_grad)
    cfg = get_arch("deepseek-v3-671b", smoke=True)
    L = cfg.n_layers
    batch = make_dataset(cfg, 64, 4, seed=1, device=cuda).global_batch_at(0)

    def fresh():
        return init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                           device=cuda)

    def plain(m):
        m.setattr(dispatch, "mha_fwd", mha_fwd_ref)
        m.setattr(dispatch, "xent_fwd", XR.xent_fwd_ref)
        m.setattr(dispatch, "xent_bwd_dh", XR.xent_bwd_dh_ref)
        m.setattr(dispatch, "xent_bwd_dw", XR.xent_bwd_dw_ref)

    def plain_optimizer(m):
        m.setattr(dispatch, "norm_sumsq", CR.norm_sumsq_ref)
        m.setattr(dispatch, "norm_apply", CR.norm_apply_ref)
        m.setattr(dispatch, "update_apply", CR.update_apply_ref)
        m.setattr(dispatch, "momentum_sumsq", momentum_sumsq_ref)
        m.setattr(dispatch, "head_update_apply",
                  lambda theta, m_new, ss, lr, axis="col", eps=CR.EPS:
                  CR.update_apply_ref(theta, m_new, ss, lr, axis, eps=eps))

    _, _, grads = value_and_grad(fresh(), cfg, batch)
    with monkeypatch.context() as m:
        plain(m)
        _, _, ref = value_and_grad(fresh(), cfg, batch)
    for k, g in grads.items():
        scale = ref[k].abs().max().item()
        assert (g - ref[k]).abs().max().item() <= 1e-4 * scale, k

    def one_step():
        tx = make_optimizer("scale_fused", 1e-2)
        params = fresh()
        old = {k: p.clone() for k, p in flatten(params).items()}
        state, metrics = make_train_step(cfg, tx, clip_norm=1.0)(
            init_state(params, tx), batch)
        return old, state, metrics

    before = _train_counts()
    routes = [dict(f.route_launches) for f in (A.mha_fwd, A.mha_bwd_dq,
                                               A.mha_bwd_dkv)]
    old, state, metrics = one_step()
    torch.cuda.synchronize()
    after = _train_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "mha_fwd": 2 * L, "mha_bwd_dq": L, "mha_bwd_dkv": L, "xent_fwd": 1,
        "xent_bwd_dh": 1, "xent_bwd_dw": 1, "norm_sumsq": 18,
        "update_apply": 19, "momentum_sumsq": 1, "norm_apply": 0}
    for f, was, n in zip((A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv), routes,
                         (2 * L, L, L)):
        assert f.route_launches == {**was, "fma": was["fma"] + n}
    with monkeypatch.context() as m:
        plain(m)
        plain_optimizer(m)
        before = _train_counts()
        _, ref_state, ref_metrics = one_step()
        assert _train_counts() == before  # no kernel on the plain route
    for k in ("loss", "aux", "grad_norm", "update_norm"):
        torch.testing.assert_close(metrics[k], ref_metrics[k], rtol=1e-4,
                                   atol=0)
    got, want = flatten(state.params), flatten(ref_state.params)
    for k, w in want.items():
        step = (w - old[k]).abs().max().item()
        assert (got[k] - w).abs().max().item() <= 1e-3 * step + 1e-7, k


@pytest.mark.gpu
def test_mamba2_smoke_train_steps_on_card_match_plain_route(cuda,
                                                            monkeypatch):
    """mamba2-370m's SMOKE twin (f32, 2 Mamba2 layers, 2 chunks of 16 a
    row): two ``scale_fused`` steps through the kernels against the same
    steps with the xent and optimizer kernels through their plain
    versions, from the same params. Per step no attention kernel, one of
    each xent kernel (fma: f32), 3 norm_sumsq (in_proj, out_proj,
    tok_embed), 4 update_apply (those and the head), one momentum_sumsq;
    the plain route launches none. Each step's metrics within 1e-4
    relative (f32 sums in other orders), every leaf within 1e-3 of its
    largest change plus 1e-7, and the first step's loss within 1e-5
    relative of the same step on the CPU (the SSD's torch products on the
    card against the CPU's)."""
    from repro_torch.configs import get_arch
    from repro_torch.core import make_optimizer
    from repro_torch.data import make_dataset
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head.ref import momentum_sumsq_ref
    from repro_torch.kernels.xent import ref as XR
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import init_params
    from repro_torch.models.model import Params, flatten
    from repro_torch.training import init_state, make_train_step
    cfg = get_arch("mamba2-370m", smoke=True)
    ds = make_dataset(cfg, 32, 4, seed=1, device=cuda)
    batches = [ds.global_batch_at(i) for i in range(2)]
    p0 = flatten(init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda))

    def run(device=cuda):
        tx = make_optimizer("scale_fused", 1e-2)
        state = init_state(Params({k: p.to(device, copy=True)
                                   for k, p in p0.items()}), tx)
        step = make_train_step(cfg, tx, clip_norm=1.0)
        mets = []
        for b in batches:
            state, m = step(state, {k: v.to(device) for k, v in b.items()})
            mets.append(m)
        return state, mets

    def plain(m):
        m.setattr(dispatch, "xent_fwd", XR.xent_fwd_ref)
        m.setattr(dispatch, "xent_bwd_dh", XR.xent_bwd_dh_ref)
        m.setattr(dispatch, "xent_bwd_dw", XR.xent_bwd_dw_ref)
        m.setattr(dispatch, "norm_sumsq", CR.norm_sumsq_ref)
        m.setattr(dispatch, "norm_apply", CR.norm_apply_ref)
        m.setattr(dispatch, "update_apply", CR.update_apply_ref)
        m.setattr(dispatch, "momentum_sumsq", momentum_sumsq_ref)
        m.setattr(dispatch, "head_update_apply",
                  lambda theta, m_new, ss, lr, axis="col", eps=CR.EPS:
                  CR.update_apply_ref(theta, m_new, ss, lr, axis, eps=eps))

    before = _train_counts()
    xroutes = [dict(f.route_launches) for f in (X.xent_fwd, X.xent_bwd_dh,
                                                X.xent_bwd_dw)]
    state, mets = run()
    torch.cuda.synchronize()
    after = _train_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "mha_fwd": 0, "mha_bwd_dq": 0, "mha_bwd_dkv": 0, "xent_fwd": 2,
        "xent_bwd_dh": 2, "xent_bwd_dw": 2, "norm_sumsq": 6,
        "update_apply": 8, "momentum_sumsq": 2, "norm_apply": 0}
    for f, was in zip((X.xent_fwd, X.xent_bwd_dh, X.xent_bwd_dw), xroutes):
        assert f.route_launches == {**was, "fma": was.get("fma", 0) + 2}
    with monkeypatch.context() as m:
        plain(m)
        before = _train_counts()
        ref_state, ref_mets = run()
        assert _train_counts() == before  # no kernel on the plain route
        _, cpu_mets = run("cpu")
    for got, want in zip(mets, ref_mets):
        for k in ("loss", "grad_norm", "update_norm"):
            assert torch.isfinite(got[k])
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=0)
    torch.testing.assert_close(mets[0]["loss"].cpu(), cpu_mets[0]["loss"],
                               rtol=1e-5, atol=0)
    got, want = flatten(state.params), flatten(ref_state.params)
    for k, w in want.items():
        step = (w - p0[k]).abs().max().item()
        assert (got[k] - w).abs().max().item() <= 1e-3 * step + 1e-7, k


def _jamba_plain(m):
    """Every kernel of the jamba twin's train step through its plain
    version."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.colnorm import ref as CR
    from repro_torch.kernels.scale_head.ref import momentum_sumsq_ref
    from repro_torch.kernels.xent import ref as XR
    m.setattr(dispatch, "mha_fwd", mha_fwd_ref)
    m.setattr(dispatch, "xent_fwd", XR.xent_fwd_ref)
    m.setattr(dispatch, "xent_bwd_dh", XR.xent_bwd_dh_ref)
    m.setattr(dispatch, "xent_bwd_dw", XR.xent_bwd_dw_ref)
    m.setattr(dispatch, "norm_sumsq", CR.norm_sumsq_ref)
    m.setattr(dispatch, "norm_apply", CR.norm_apply_ref)
    m.setattr(dispatch, "update_apply", CR.update_apply_ref)
    m.setattr(dispatch, "momentum_sumsq", momentum_sumsq_ref)
    m.setattr(dispatch, "head_update_apply",
              lambda theta, m_new, ss, lr, axis="col", eps=CR.EPS:
              CR.update_apply_ref(theta, m_new, ss, lr, axis, eps=eps))


@pytest.mark.gpu
def test_jamba_smoke_train_steps_on_card_match_plain_route(cuda,
                                                           monkeypatch):
    """jamba-1.5-large-398b's SMOKE twin (f32; two hybrid super-blocks of
    period 4: attention + MLP, then Mamba2 with MoE and MLP in turn; 2
    chunks of 16 a row): two ``scale_fused`` steps through the kernels
    against the same steps with every kernel through its plain version,
    from the same params. Per step 4 mha_fwd and 2 of each backward kernel
    (fma: f32; full remat runs the forward twice), one of each xent kernel
    (fma), 19 norm_sumsq (tok_embed and the 18 stacked matrices of 3 dims),
    20 update_apply (those and the head), one momentum_sumsq; the 4-D
    expert leaves take the plain stage route; the plain route launches
    none. Each step's metrics within 1e-4 relative (f32 sums in other
    orders) and finite; every leaf within 1e-3 of its largest change plus
    1e-7, but the leaves SCALE gives to Adam (norms, conv, A_log, D,
    dt_bias) within 1e-2: Adam's step g / (|g| + eps) carries a larger
    share of the two routes' rounding of g where |g| is a few eps
    (``tests/test_torch_jamba_smoke.py``); the first step's loss within
    1e-5 relative of the same step on the CPU."""
    from repro_torch.configs import get_arch
    from repro_torch.core import make_optimizer
    from repro_torch.core.labels import LabelRules
    from repro_torch.data import make_dataset
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import init_params
    from repro_torch.models.model import Params, flatten
    from repro_torch.training import init_state, make_train_step
    cfg = get_arch("jamba-1.5-large-398b", smoke=True)
    assert cfg.segments == (("hybrid", 2),) and cfg.remat == "full"
    ds = make_dataset(cfg, 32, 4, seed=1, device=cuda)
    batches = [ds.global_batch_at(i) for i in range(2)]
    p0 = flatten(init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda))

    def run(device=cuda):
        tx = make_optimizer("scale_fused", 1e-2)
        state = init_state(Params({k: p.to(device, copy=True)
                                   for k, p in p0.items()}), tx)
        step = make_train_step(cfg, tx, clip_norm=1.0)
        mets = []
        for b in batches:
            state, m = step(state, {k: v.to(device) for k, v in b.items()})
            mets.append(m)
        return state, mets

    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv, X.xent_fwd, X.xent_bwd_dh,
           X.xent_bwd_dw)
    before = _train_counts()
    routes = [dict(f.route_launches) for f in fns]
    state, mets = run()
    torch.cuda.synchronize()
    after = _train_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "mha_fwd": 8, "mha_bwd_dq": 4, "mha_bwd_dkv": 4, "xent_fwd": 2,
        "xent_bwd_dh": 2, "xent_bwd_dw": 2, "norm_sumsq": 38,
        "update_apply": 40, "momentum_sumsq": 2, "norm_apply": 0}
    for f, was, n in zip(fns, routes, (8, 4, 4, 2, 2, 2)):
        assert f.route_launches == {**was, "fma": was.get("fma", 0) + n}
    with monkeypatch.context() as m:
        _jamba_plain(m)
        before = _train_counts()
        ref_state, ref_mets = run()
        assert _train_counts() == before  # no kernel on the plain route
        _, cpu_mets = run("cpu")
    for got, want in zip(mets, ref_mets):
        for k in ("loss", "aux", "grad_norm", "update_norm"):
            assert torch.isfinite(got[k])
            torch.testing.assert_close(got[k], want[k], rtol=1e-4, atol=0)
    torch.testing.assert_close(mets[0]["loss"].cpu(), cpu_mets[0]["loss"],
                               rtol=1e-5, atol=0)
    got, want = flatten(state.params), flatten(ref_state.params)
    for k, w in want.items():
        step = (w - p0[k]).abs().max().item()
        adam = LabelRules().classify(k, w.ndim) == "vector"
        assert (got[k] - w).abs().max().item() <= (
            (1e-2 if adam else 1e-3) * step + 1e-7), k


@pytest.mark.gpu
def test_jamba_smoke_serving_on_card_matches_full_forward(cuda):
    """The jamba twin (f32, cf 2.0 = E/k: nothing dropped) served on the
    card: prefill 24 tokens, then 8 decode steps through the stacked mixed
    cache (the attention's k/v written by ``index_copy_``, each Mamba2
    sub-layer's conv and ssm by ``copy_``, in place: the cache tensors are
    those prefill built); the last logits against a full forward within
    2e-4 (f32 layers summed in other orders); each step's attention on the
    kernel (2 layers: fma for the f32 prefill, decode for each step)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_params, logits_from_hidden
    from repro_torch.models.model import flatten
    from repro_torch.training import make_decode_step, make_prefill_step
    cfg = get_arch("jamba-1.5-large-398b", smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    B, S, P = 2, 32, 24
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)).to(cuda)
    was = dict(mha_fwd.route_launches)
    state, logits = make_prefill_step(cfg, max_seq=S)(params, toks[:, :P])
    held = flatten(state.cache)
    assert state.cache["seg0_hybrid"]["mamba2"]["ssm"].dtype == torch.float32
    decode = make_decode_step(cfg)
    for i in range(P, S):
        state, logits = decode(params, state, toks[:, i:i + 1])
    torch.cuda.synchronize()
    assert all(v is held[k] for k, v in flatten(state.cache).items())
    assert mha_fwd.route_launches == {
        **was, "fma": was["fma"] + 2, "decode": was["decode"] + 2 * (S - P)}
    with torch.no_grad():
        h, _, _ = forward(params, cfg, toks)
        ref = logits_from_hidden(params, cfg, h)[:, -1]
    torch.testing.assert_close(logits[:, -1], ref, atol=2e-4, rtol=0)


@pytest.mark.gpu
def test_cross_attention_layer_on_card_routes_by_image_dtype(cuda):
    """The VLM's cross sub-layer (bf16 weights, 2 heads over 1 of 128) on
    the card against the same layer on the CPU: with f32 images its keys
    and values are f32 and its q is promoted (ROADMAP.md caveat 13), so
    the attention's forward and both backward kernels take the f32 fma
    route; with bf16 images all three take mma. Output and gradients
    within 2e-2 of their largest |ref| plus 2e-2 relative (bf16 products
    and sums rounded at other places on each side)."""
    from repro_torch.kernels.attention import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(family="vlm", n_layers=1, d_model=256, n_heads=2,
                      n_kv_heads=1, head_dim=128, cross_attn_every=1,
                      n_image_tokens=64)
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(0.05 * rng.standard_normal(s.shape,
                                                        dtype=np.float32))
         .to(torch.bfloat16) for k, s in L.attn_spec(cfg, cross=True).items()}
    x = torch.from_numpy(rng.standard_normal((2, 32, 256), dtype=np.float32)
                         ).to(torch.bfloat16)
    img = torch.from_numpy(0.5 * rng.standard_normal((2, 64, 256),
                                                     dtype=np.float32))
    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv)

    def run(device, images):
        leaves = {k: v.to(device).requires_grad_() for k, v in p.items()}
        xx = x.to(device).requires_grad_()
        y, _ = L.apply_attention(leaves, cfg, xx,
                                 torch.arange(32, device=device), "train",
                                 kv_source=images.to(device))
        grads = torch.autograd.grad(y.float().square().sum(),
                                    [xx, *leaves.values()])
        return y, grads

    for images, route in ((img, "fma"), (img.to(torch.bfloat16), "mma")):
        was = [dict(f.route_launches) for f in fns]
        y, grads = run(cuda, images)
        torch.cuda.synchronize()
        for f, w in zip(fns, was):
            assert f.route_launches == {**w, route: w[route] + 1}, f
        y_cpu, grads_cpu = run("cpu", images)
        assert y.dtype == torch.bfloat16
        for got, want in zip((y, *grads), (y_cpu, *grads_cpu)):
            assert got.dtype == want.dtype
            got, want = got.float().cpu(), want.float()
            tol = 2e-2 * want.abs().max() + 2e-2 * want.abs()
            assert bool(((got - want).abs() <= tol).all())


def _smoke_steps_on_card(cfg, monkeypatch, cuda, want):
    """Two ``scale_fused`` steps (clip 1.0) of ``cfg`` through the kernels
    (their launches ``want``, all on fma: the twins are f32) against the
    same steps with every kernel through its plain version, from the same
    params: each step's metrics within 1e-4 relative and finite, every
    leaf within 1e-3 of its largest change plus 1e-7 (the Adam leaves
    1e-2, ``test_jamba_smoke_train_steps_on_card_match_plain_route``'s
    reason); the first step's loss within 1e-5 relative of the same step
    on the CPU."""
    from repro_torch.core import make_optimizer
    from repro_torch.core.labels import LabelRules
    from repro_torch.data import make_dataset
    from repro_torch.kernels.attention import attention as A
    from repro_torch.kernels.xent import xent as X
    from repro_torch.models import init_params
    from repro_torch.models.model import Params, flatten
    from repro_torch.training import init_state, make_train_step
    ds = make_dataset(cfg, 32, 4, seed=1, device=cuda)
    batches = [ds.global_batch_at(i) for i in range(2)]
    p0 = flatten(init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda))

    def run(device=cuda):
        tx = make_optimizer("scale_fused", 1e-2)
        state = init_state(Params({k: p.to(device, copy=True)
                                   for k, p in p0.items()}), tx)
        step = make_train_step(cfg, tx, clip_norm=1.0)
        mets = []
        for b in batches:
            state, m = step(state, {k: v.to(device) for k, v in b.items()})
            mets.append(m)
        return state, mets

    fns = (A.mha_fwd, A.mha_bwd_dq, A.mha_bwd_dkv, X.xent_fwd, X.xent_bwd_dh,
           X.xent_bwd_dw)
    before = _train_counts()
    routes = [dict(f.route_launches) for f in fns]
    state, mets = run()
    torch.cuda.synchronize()
    after = _train_counts()
    assert {k: after[k] - before[k] for k in after} == want
    for f, was in zip(fns, routes):
        n = want[f.__name__]
        assert f.route_launches == {**was, "fma": was.get("fma", 0) + n}
    with monkeypatch.context() as m:
        _jamba_plain(m)
        before = _train_counts()
        ref_state, ref_mets = run()
        assert _train_counts() == before  # no kernel on the plain route
        _, cpu_mets = run("cpu")
    for got, want_m in zip(mets, ref_mets):
        for k in ("loss", "grad_norm", "update_norm"):
            assert torch.isfinite(got[k])
            torch.testing.assert_close(got[k], want_m[k], rtol=1e-4, atol=0)
    torch.testing.assert_close(mets[0]["loss"].cpu(), cpu_mets[0]["loss"],
                               rtol=1e-5, atol=0)
    got, ref = flatten(state.params), flatten(ref_state.params)
    for k, w in ref.items():
        step = (w - p0[k]).abs().max().item()
        adam = LabelRules().classify(k, w.ndim) == "vector"
        assert (got[k] - w).abs().max().item() <= (
            (1e-2 if adam else 1e-3) * step + 1e-7), k


@pytest.mark.gpu
def test_vlm_smoke_train_steps_on_card_match_plain_route(cuda, monkeypatch):
    """llama-3.2-vision-11b's SMOKE twin (f32, two vlm super-blocks:
    cross-attention over the data pipeline's 16 f32 image tokens + MLP,
    then self-attention + MLP) through ``_smoke_steps_on_card``: per step
    8 mha_fwd and 4 of each backward kernel (4 attention sub-layers, full
    remat), one of each xent kernel, 15 norm_sumsq (tok_embed and the 14
    stacked matrices), 16 update_apply, one momentum_sumsq."""
    from repro_torch.configs import get_arch
    cfg = get_arch("llama-3.2-vision-11b", smoke=True)
    assert cfg.segments == (("vlm", 2),) and cfg.remat == "full"
    _smoke_steps_on_card(cfg, monkeypatch, cuda, {
        "mha_fwd": 16, "mha_bwd_dq": 8, "mha_bwd_dkv": 8, "xent_fwd": 2,
        "xent_bwd_dh": 2, "xent_bwd_dw": 2, "norm_sumsq": 30,
        "update_apply": 32, "momentum_sumsq": 2, "norm_apply": 0})


@pytest.mark.gpu
def test_musicgen_smoke_train_steps_on_card_match_plain_route(cuda,
                                                              monkeypatch):
    """musicgen-medium's SMOKE twin (f32, 2 layers, 4 codebooks) through
    ``_smoke_steps_on_card``: per step 4 mha_fwd and 2 of each backward
    kernel, each xent kernel 4 times (once a codebook head), 8 norm_sumsq
    (the (4, 128, 128) embedding and the 7 stacked matrices), 9
    update_apply, one momentum_sumsq on the (4, 128, 128) heads."""
    from repro_torch.configs import get_arch
    cfg = get_arch("musicgen-medium", smoke=True)
    _smoke_steps_on_card(cfg, monkeypatch, cuda, {
        "mha_fwd": 8, "mha_bwd_dq": 4, "mha_bwd_dkv": 4, "xent_fwd": 8,
        "xent_bwd_dh": 8, "xent_bwd_dw": 8, "norm_sumsq": 16,
        "update_apply": 18, "momentum_sumsq": 2, "norm_apply": 0})


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "musicgen-medium"])
def test_vlm_and_audio_smoke_serving_on_card_matches_full_forward(cuda,
                                                                  arch):
    """The VLM twin with 16 f32 image tokens a row, and the audio twin with
    (B, 4, S) prompts and (B, 4, 1) decode tokens, served on the card:
    prefill 24 positions, then 8 decode steps; the last logits against a
    full forward within 2e-4 (f32 layers summed in other orders); every
    attention call on a kernel (the prefill's on fma: f32; each decode
    step's on decode, the VLM's cross-attention over the image keys with
    no kv_len among them)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import forward, init_params, logits_from_hidden
    from repro_torch.models.transformer import superblock_layout
    from repro_torch.training import make_decode_step, make_prefill_step
    cfg = get_arch(arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                         device=cuda)
    B, S, P = 2, 32, 24
    C = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, *C, S),
                                         dtype=np.int32)).to(cuda)
    images = None
    if cfg.family == "vlm":
        images = torch.from_numpy(0.02 * rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model), dtype=np.float32)).to(cuda)
    n_attn = sum(n * sum(sub in ("attn", "cross") for _, sub in
                         superblock_layout(cfg, kind))
                 for kind, n in cfg.segments)
    was = dict(mha_fwd.route_launches)
    state, logits = make_prefill_step(cfg, max_seq=S)(params, toks[..., :P],
                                                      images)
    decode = make_decode_step(cfg)
    for i in range(P, S):
        state, logits = decode(params, state, toks[..., i:i + 1], images)
    torch.cuda.synchronize()
    assert mha_fwd.route_launches == {
        **was, "fma": was["fma"] + n_attn,
        "decode": was["decode"] + n_attn * (S - P)}
    with torch.no_grad():
        h, _, _ = forward(params, cfg, toks, image_embeds=images)
        ref = logits_from_hidden(params, cfg, h)[..., -1, :]
    torch.testing.assert_close(logits[..., -1, :], ref, atol=2e-4, rtol=0)


# The sequence-split decode (``dispatch.SeqSplitPlan``, serving on a mesh
# whose cache's T lies over "model"), in one process: the cache cut into
# T-shards, ``mha_fwd``'s decode route on each at its local fill
# clamp(kv_len - r T_l, 0, T_l), the partials combined by
# ``dispatch.lse_combine``. (B, T, H, K, hd): llama-130m's serving decode
# (phase 3) and the VLM's self-attention decode (phase 20).
SEQ_SPLIT_CASES = {"llama130m_decode": (8, 576, 12, 12, 64),
                   "vlm_decode_gqa32x8_hd128": (4, 544, 32, 8, 128)}


@pytest.mark.gpu
@pytest.mark.parametrize("fill", ["inside", "on", "past"])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SEQ_SPLIT_CASES))
def test_seq_split_decode_matches_the_unsharded_kernel_on_card(
        cuda, case, dtype, splits, fill):
    """Each T-shard on the decode kernel (one launch a shard, on route
    ``decode``), combined, against the unsharded kernel call and against
    the plain version, at a fill inside the first shard (the others have
    no valid key), on a shard boundary and past one: the attention
    tolerances above (f32 2e-5; bf16 2e-2 + 2e-2*|ref|: each shard's
    output is rounded to bf16 before the f32 combine)."""
    from repro_torch.kernels.dispatch import lse_combine
    B, T, H, K, hd = SEQ_SPLIT_CASES[case]
    td = DTYPES[dtype]
    q, k, v = (torch.from_numpy(x).to(cuda, td)
               for x in _inputs(3, B, 1, T, H, K, hd))
    T_l = T // splits
    kv_len = {"inside": T_l // 2, "on": T_l, "past": T_l + 37}[fill]
    kl = torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    was = dict(mha_fwd.route_launches)
    parts = [mha_fwd(q, kr.contiguous(), vr.contiguous(),
                     (kl - r * T_l).clamp(0, T_l).to(torch.int32),
                     scale=hd ** -0.5, causal=False)
             for r, (kr, vr) in enumerate(zip(k.split(T_l, 1),
                                              v.split(T_l, 1)))]
    got = lse_combine(torch.stack([o for o, _ in parts]),
                      torch.stack([s for _, s in parts])).to(td)
    torch.cuda.synchronize()
    assert mha_fwd.route_launches == {**was,
                                      "decode": was["decode"] + splits}
    whole = mha_fwd(q, k, v, kl, scale=hd ** -0.5, causal=False)[0]
    ref = mha_fwd_ref(q, k, v, kl, scale=hd ** -0.5, causal=False)[0]
    atol, rtol = _tol(dtype)
    for want in (whole, ref):
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    if fill == "inside":  # every shard past the first has no valid key
        assert all((o == 0).all() and (s < -1e29).all()
                   for o, s in parts[1:])
