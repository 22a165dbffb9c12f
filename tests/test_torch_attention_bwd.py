"""Port attention backward against the JAX package: the plain PyTorch
``mha_bwd_dq`` and ``mha_bwd_dkv`` against the Pallas kernels in interpret
mode, and the gradients of ``dispatch.flash_attention`` (the autograd
``FlashAttention`` over the plain versions on CPU tensors) against
``jax.vjp`` of the JAX ``dispatch.flash_attention`` under
``REPRO_FUSED=interpret``.

The CUDA kernels are held against the plain versions on the card by the
``gpu``-marked tests of ``tests/test_torch_gpu.py``.

The same (q, k, v, dO), made with numpy from a seed, go to both sides; lse
and delta = rowsum(f32(dO) * f32(out)) come from the JAX forward and feed
both. Tolerances, per element, with ``max|ref|`` the largest element of
the gradient compared (its entries cancel toward zero, so no relative
tolerance alone can hold them):
  * f32: 2e-6 * max|ref| — f32 sums of a few hundred unit-scale products
    in other orders (observed at most 2e-7);
  * bf16: 1e-5 * max|ref| + 8e-3 * |ref| — the same sums, with p and ds
    rounded to bf16 at the same places on both sides, then one rounding of
    each gradient to bf16 on each side, which can land one ulp (at most
    2**-7 relative) apart;
  * bf16 through the whole Function (forward, delta, backward): 1e-2 *
    max|ref| + 2e-2 * |ref| — the forwards differ by a bf16 ulp here and
    there (the Pallas kernel rounds the running, unnormalized p, the plain
    version the normalized p; see ``tests/test_torch_attention.py``), and
    that difference moves delta and so ds (observed at most 9e-3 of
    max|ref|, and 4e-3 of it above 2e-2 * |ref|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import repro_fused  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro.kernels.attention import attention as jattn  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.attention.attention import (  # noqa: E402
    mha_bwd_dkv, mha_bwd_dq, mha_fwd)
from repro_torch.kernels.attention.ref import (  # noqa: E402
    mha_bwd_dkv_ref, mha_bwd_dq_ref, mha_fwd_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# name -> (B, S, T, H, K, hd, causal, kv_len): groups 1, 2 and 4 (K = 1
# among them), hd 32 and 64, causal square, causal with T > S, ragged S,
# and causal=False with kv_len (0 included) and without
CASES = {
    "causal_g1_hd32": (2, 24, 24, 4, 4, 32, True, None),
    "causal_g4_k1_hd64": (2, 24, 24, 4, 1, 64, True, None),
    "rect8x40_g2_hd64": (2, 8, 40, 4, 2, 64, True, None),
    "ragged37_g4_k1_hd32": (2, 37, 37, 4, 1, 32, True, None),
    "kvlen33_g2_hd64": (2, 5, 64, 4, 2, 64, False, 33),
    "kvlen0_g1_hd32": (2, 5, 64, 4, 4, 32, False, 0),
    "cross16_g2_hd64": (2, 16, 16, 4, 2, 64, False, None),
}


def _inputs(seed, B, S, T, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, S, H, hd), dtype=np.float32))


def _close(got, want, dtype, whole=False):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "f32":
        tol = 2e-6 * scale
    elif whole:
        tol = 1e-2 * scale + 2e-2 * np.abs(want)
    else:
        tol = 1e-5 * scale + 8e-3 * np.abs(want)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= tol).all(), float(err.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_interpret(case, dtype):
    B, S, T, H, K, hd, causal, kv_len = CASES[case]
    jd, td = DTYPES[dtype]
    scale = hd ** -0.5
    x = _inputs(hd + 3 * K, B, S, T, H, K, hd)
    kl_j = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)

    @jax.jit
    def pallas(q, k, v, do, kl):
        kw = dict(scale=scale, causal=causal, interpret=True)
        out, lse = jattn.mha_fwd(q, k, v, kl, **kw)
        delta = jnp.swapaxes(jnp.sum(do.astype(jnp.float32)
                                     * out.astype(jnp.float32), -1), 1, 2)
        dq = jattn.mha_bwd_dq(q, k, v, do, lse, delta, kl, **kw)
        dk, dv = jattn.mha_bwd_dkv(q, k, v, do, lse, delta, kl, **kw)
        return lse, delta, dq, dk, dv

    lse, delta, dq, dk, dv = pallas(*(jnp.asarray(a).astype(jd) for a in x),
                                    kl_j)
    q, k, v, do = (torch.from_numpy(a).to(td) for a in x)
    lse_t = torch.from_numpy(np.array(lse))
    delta_t = torch.from_numpy(np.array(delta))
    kl_t = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    args = (q, k, v, do, lse_t, delta_t, kl_t)
    got_dq = mha_bwd_dq_ref(*args, scale=scale, causal=causal)
    got_dk, got_dv = mha_bwd_dkv_ref(*args, scale=scale, causal=causal)
    assert (got_dq.dtype, got_dk.dtype, got_dv.dtype) == (td,) * 3
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        _close(got, want, dtype)
    if kv_len == 0:  # fully masked rows: exactly 0, not NaN
        assert all(bool((g == 0).all()) for g in (got_dq, got_dk, got_dv))
    # the wrappers take the plain versions on CPU tensors, launching nothing
    before = (mha_bwd_dq.launches, mha_bwd_dkv.launches)
    assert torch.equal(mha_bwd_dq(*args, scale=scale, causal=causal), got_dq)
    w_dk, w_dv = mha_bwd_dkv(*args, scale=scale, causal=causal)
    assert torch.equal(w_dk, got_dk) and torch.equal(w_dv, got_dv)
    assert (mha_bwd_dq.launches, mha_bwd_dkv.launches) == before


# (B, S, T, H, K, hd, causal, kv_len) for the Function against jax.vjp
VJP_CASES = {
    "causal_gqa": (2, 24, 24, 4, 2, 32, True, None),
    "rect_mqa": (1, 8, 40, 4, 1, 64, True, None),
    "kvlen": (2, 3, 48, 4, 2, 32, False, 20),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(VJP_CASES))
def test_flash_attention_grads_match_jax_vjp(case, dtype):
    B, S, T, H, K, hd, causal, kv_len = VJP_CASES[case]
    jd, td = DTYPES[dtype]
    scale = hd ** -0.5
    x = _inputs(11, B, S, T, H, K, hd)
    kl_j = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    with repro_fused("interpret"):
        out_j, vjp = jax.vjp(lambda q, k, v: JD.flash_attention(
            q, k, v, scale=scale, causal=causal, kv_len=kl_j),
            *(jnp.asarray(a).astype(jd) for a in x[:3]))
        want = vjp(jnp.asarray(x[3]).astype(jd))
    q, k, v = (torch.from_numpy(a).to(td).requires_grad_() for a in x[:3])
    kl_t = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    out = dispatch.flash_attention(q, k, v, scale=scale, causal=causal,
                                   kv_len=kl_t)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, [q, k, v],
                              torch.from_numpy(x[3]).to(td))
    _close(out, out_j, dtype, whole=True)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == td and g.shape == t.shape
        _close(g, w, dtype, whole=True)


def test_swapped_forward_is_differentiated_by_plain_autograd(monkeypatch):
    """With mha_fwd_ref put in dispatch's mha_fwd (how the card's tests take
    an independent reference gradient), flash_attention bypasses the
    Function; on the CPU both routes give the plain gradients."""
    x = _inputs(5, 2, 9, 9, 4, 2, 16)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in x[:3])
    do = torch.from_numpy(x[3])
    fn_out = dispatch.flash_attention(q, k, v, scale=0.25)
    fn_grads = torch.autograd.grad(fn_out, [q, k, v], do)
    monkeypatch.setattr(dispatch, "mha_fwd", mha_fwd_ref)
    ref_out = dispatch.flash_attention(q, k, v, scale=0.25)
    assert type(ref_out.grad_fn).__name__ != "FlashAttentionBackward"
    ref_grads = torch.autograd.grad(ref_out, [q, k, v], do)
    torch.testing.assert_close(fn_out, ref_out, rtol=0, atol=0)
    for a, b in zip(fn_grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_function_backward_takes_only_the_asked_gradients():
    x = _inputs(6, 1, 8, 8, 2, 2, 16)
    q = torch.from_numpy(x[0]).requires_grad_()
    k, v = torch.from_numpy(x[1]), torch.from_numpy(x[2])
    out = dispatch.flash_attention(q, k, v, scale=0.25)
    (gq,) = torch.autograd.grad(out.sum(), [q])  # an expanded cotangent
    out_ref, lse = mha_fwd(q.detach(), k, v, scale=0.25)
    delta = out_ref.sum(-1).transpose(1, 2).contiguous()
    want = mha_bwd_dq_ref(q.detach(), k, v, torch.ones_like(out_ref), lse,
                          delta, scale=0.25, causal=True)
    torch.testing.assert_close(gq, want, rtol=1e-6, atol=1e-6)


def test_backward_wrappers_reject_bad_inputs():
    q = torch.zeros(1, 4, 4, 16)
    k = torch.zeros(1, 4, 2, 16)
    lse = torch.zeros(1, 4, 4)
    for fn in (mha_bwd_dq, mha_bwd_dkv):
        with pytest.raises(ValueError, match="dout"):
            fn(q, k, k, q[:, :3], lse, lse, scale=1.0)
        with pytest.raises(ValueError, match="lse"):
            fn(q, k, k, q, lse.double(), lse, scale=1.0)
        with pytest.raises(ValueError, match="delta"):
            fn(q, k, k, q, lse, lse[:, :2], scale=1.0)
        with pytest.raises(ValueError, match=r"in \[8, 256\]"):
            w = torch.zeros(1, 4, 2, 264)
            fn(torch.zeros(1, 4, 4, 264), w, w, torch.zeros(1, 4, 4, 264),
               lse, lse, scale=1.0)
        with pytest.raises(ValueError, match="kv_len requires causal=False"):
            fn(q, k, k, q, lse, lse, 2, scale=1.0, causal=True)
        with pytest.raises(ValueError, match="H % K"):
            w = torch.zeros(1, 4, 3, 16)
            fn(q, w, w, q, lse, lse, scale=1.0)
