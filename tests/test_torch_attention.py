"""Port attention against the JAX package: mask densification, and the
plain PyTorch ``mha_fwd`` against the Pallas ``mha_fwd`` in interpret mode.

The CUDA kernel is held against the plain version on the card by the
``gpu``-marked tests of ``tests/test_torch_gpu.py``.

Tolerances, per element:
  * f32 out: 2e-5 absolute, as ``tests/test_attention.py`` holds the
    Pallas kernel (unit-scale values; the two sides sum in other orders);
  * bf16 out: 2e-2 + 2e-2*|ref| — the Pallas kernel rounds the running,
    unnormalized p to bf16, the plain version the normalized p, and the
    output itself is rounded to bf16 (8 bits of mantissa);
  * lse (f32 in both dtypes; the scores are f32 sums of exact products
    on both sides): 1e-4 + 1e-5*|ref|, on rows with at least one valid key.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.attention import attention as jattn  # noqa: E402
from repro.kernels.attention import mask as jmask  # noqa: E402
from repro_torch.kernels.attention import mask as tmask  # noqa: E402
from repro_torch.kernels.attention.attention import (  # noqa: E402
    _fwd_route, mha_fwd)
from repro_torch.kernels.attention.ref import mha_fwd_ref  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    return (2e-5, 0.0) if dtype_name == "f32" else (2e-2, 2e-2)


def _inputs(seed, B, S, T, H, K, hd, hdv=None):
    rng = np.random.default_rng(seed)
    hdv = hdv or hd
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hdv), dtype=np.float32))


# ------------------------------------------------------------------ (a) mask

MASK_CASES = [
    dict(S=7, T=7, causal=True),
    dict(S=5, T=12, causal=True),
    dict(S=1, T=9, causal=False, kv_len=4),
    dict(S=3, T=9, causal=False, kv_len=0),
    dict(S=6, T=6, causal=False),
    dict(S=6, T=6, causal=True, segments=True),
]


@pytest.mark.parametrize("case", MASK_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_mask_array_matches_jax(case):
    S, T, causal = case["S"], case["T"], case["causal"]
    kv_len = case.get("kv_len")
    seg_j = seg_t = None
    if case.get("segments"):
        ids = np.array([[1, 1, 2, 2, 2, 0], [1, 2, 3, 3, 0, 0]], np.int32)
        seg_j = (jnp.asarray(ids), jnp.asarray(ids))
        seg_t = (torch.from_numpy(ids), torch.from_numpy(ids))
    spec_j = jmask.mask_spec(S, T, causal=causal, kv_len=kv_len,
                             segments=seg_j)
    spec_t = tmask.mask_spec(S, T, causal=causal, kv_len=kv_len,
                             segments=seg_t)
    assert tuple(spec_t) == tuple(spec_j)
    want = np.asarray(jmask.mask_array(spec_j, S, T, kv_len=kv_len,
                                       segments=seg_j))
    got = tmask.mask_array(spec_t, S, T, kv_len=kv_len, segments=seg_t)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_spec_rejects_what_jax_rejects():
    with pytest.raises(ValueError):
        tmask.mask_spec(8, 4, causal=True)
    with pytest.raises(ValueError):
        tmask.mask_spec(4, 4, causal=False, kv_len=2,
                        segments=(torch.zeros(1, 4), torch.zeros(1, 4)))


# ------------------------------------------------- (b) plain mha_fwd vs JAX

# (S, T, causal, kv_len)
FWD_CASES = {
    "causal37": (37, 37, True, None),
    "rect8x40": (8, 40, True, None),
    "decode_kl0": (1, 64, False, 0),
    "decode_kl1": (1, 64, False, 1),
    "decode_kl33": (1, 64, False, 33),
    "decode_kl64": (1, 64, False, 64),
}


# Every case runs twice, and every (H/K group, hd) pair in {1, 2, 4} x
# {16, 64} twice, in both dtypes: each interpret-mode Pallas call costs
# about 0.6 s here, so the full product would take the file past a minute.
_PAIRS = [(g, hd) for g in (1, 2, 4) for hd in (16, 64)]
FWD_GRID = [(case, *_PAIRS[(i + j) % 6]) for i, case in enumerate(FWD_CASES)
            for j in (0, 3)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case,group,hd", FWD_GRID)
def test_plain_mha_fwd_matches_pallas_interpret(case, group, hd, dtype):
    S, T, causal, kv_len = FWD_CASES[case]
    B, H = 2, 4
    K = H // group
    q, k, v = _inputs(hd + 7 * group, B, S, T, H, K, hd)
    jd, td = DTYPES[dtype]
    scale = hd ** -0.5

    kl_j = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    out_j, lse_j = jax.jit(
        lambda q, k, v, kl: jattn.mha_fwd(q, k, v, kl, scale=scale,
                                          causal=causal, interpret=True))(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)), kl_j)
    kl_t = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out_t, lse_t = mha_fwd(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                           kl_t, scale=scale, causal=causal)

    assert out_t.dtype == td and lse_t.dtype == torch.float32
    assert tuple(out_t.shape) == out_j.shape and tuple(lse_t.shape) == lse_j.shape
    atol, rtol = _tol(dtype)
    ref = np.asarray(out_j.astype(jnp.float32))
    np.testing.assert_allclose(out_t.float().numpy(), ref, atol=atol, rtol=rtol)
    lse_ref = np.asarray(lse_j)
    rows = lse_ref > -1e29
    np.testing.assert_allclose(lse_t.numpy()[rows], lse_ref[rows], atol=1e-4,
                               rtol=1e-5)
    if kv_len == 0:  # fully masked rows give exactly 0, not NaN
        assert not rows.any() and (out_t == 0).all()


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="kv_len requires causal=False"):
        dispatch.flash_attention(q, k, k, scale=1.0, causal=True, kv_len=2)
    with pytest.raises(ValueError, match="H % K"):
        mha_fwd(q, torch.zeros(1, 4, 3, 16), torch.zeros(1, 4, 3, 16),
                scale=1.0)
    with pytest.raises(ValueError, match="multiple of 8"):
        mha_fwd(q[..., :12], k[..., :12], k[..., :12], scale=1.0)
    with pytest.raises(ValueError, match="dtypes"):
        mha_fwd(q.half(), k.half(), k.half(), scale=1.0)
    with pytest.raises(ValueError, match="T >= S"):
        mha_fwd(q, k[:, :2], k[:, :2], scale=1.0)


def test_dispatch_routes_cpu_tensors_to_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _inputs(0, 2, 9, 9, 4, 2, 16))
    before = mha_fwd.launches, dict(mha_fwd.route_launches)
    out = dispatch.flash_attention(q, k, v, scale=0.25, causal=True)
    torch.testing.assert_close(out, mha_fwd_ref(q, k, v, scale=0.25,
                                                causal=True)[0], rtol=0, atol=0)
    # the CPU path launches no kernel, on any route
    assert (mha_fwd.launches, mha_fwd.route_launches) == before


# (B, S, T, H, K, hd, hdv, dtype) -> the CUDA forward kernel it takes
ROUTE_CASES = {
    "train_llama1b": ((16, 256, 256, 32, 32, 64, 64, "bf16"), "mma"),
    "rect_s256_t300": ((16, 256, 300, 32, 32, 64, 64, "bf16"), "mma"),
    "prefill_llama130m": ((8, 512, 512, 12, 12, 64, 64, "bf16"), "mma"),
    "hd128": ((4, 512, 512, 8, 8, 128, 128, "bf16"), "mma"),
    "gqa_s5": ((8, 5, 5, 14, 2, 64, 64, "bf16"), "mma"),
    "decode_s1": ((8, 1, 576, 12, 12, 64, 64, "bf16"), "decode"),
    "decode_s4": ((8, 4, 576, 12, 12, 128, 128, "bf16"), "decode"),
    "decode_s1_f32": ((8, 1, 576, 12, 12, 64, 64, "f32"), "decode"),
    "train_f32": ((16, 256, 256, 32, 32, 64, 64, "f32"), "fma"),
    "hd256": ((2, 512, 512, 8, 1, 256, 256, "bf16"), "fma"),
    "hd64_hdv128": ((2, 64, 64, 8, 8, 64, 128, "bf16"), "fma"),
    "hd32": ((2, 64, 64, 8, 8, 32, 32, "bf16"), "fma"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_fwd_route_choice(case):
    """The forward kernel is chosen by dtype and shape alone: tensor cores
    (mma) for bf16 heads of 64 and 128 past S = 4 (the training, eval and
    prefill shapes), decode at S <= 4, f32 FMAs (fma) otherwise."""
    (B, S, T, H, K, hd, hdv, dtype), want = ROUTE_CASES[case]
    td = DTYPES[dtype][1]
    q = torch.empty(B, S, H, hd, dtype=td, device="meta")
    k = torch.empty(B, T, K, hd, dtype=td, device="meta")
    v = torch.empty(B, T, K, hdv, dtype=td, device="meta")
    assert _fwd_route(q, k, v) == want
