"""Which CUDA kernel each attention backward call takes, and that the CPU
path takes none.

``_bwd_route`` picks the backward kernels of a CUDA call by dtype and
shape alone: ``mma`` (tensor cores) for bf16 with hd == hdv in {64, 128},
``fma`` (f32 FMAs) for the rest. It is a pure function, so it is checked
here on meta tensors; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``). On CPU tensors the wrappers return their
plain versions, bit for bit, and count no launch on either route.

Imports no JAX: the routes are the port's own.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.attention.attention import (  # noqa: E402
    _bwd_route, _fwd_route, mha_bwd_dkv, mha_bwd_dq, mha_fwd)
from repro_torch.kernels.attention.ref import (  # noqa: E402
    mha_bwd_dkv_ref, mha_bwd_dq_ref, mha_fwd_ref)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# (B, S, T, H, K, hd, hdv, dtype) -> the CUDA backward kernels it takes
BWD_ROUTE_CASES = {
    "train_llama1b": ((16, 256, 256, 32, 32, 64, 64, "bf16"), "mma"),
    "gqa_qwen2_500m": ((8, 512, 512, 14, 2, 64, 64, "bf16"), "mma"),
    "hd128": ((4, 512, 512, 8, 8, 128, 128, "bf16"), "mma"),
    "hd128_ragged": ((2, 200, 200, 4, 4, 128, 128, "bf16"), "mma"),
    "kvlen_s16": ((8, 16, 576, 12, 4, 64, 64, "bf16"), "mma"),
    "s1": ((2, 1, 64, 4, 4, 64, 64, "bf16"), "mma"),
    "train_f32": ((16, 256, 256, 32, 32, 64, 64, "f32"), "fma"),
    "hd128_f32": ((4, 512, 512, 8, 8, 128, 128, "f32"), "fma"),
    "hd256": ((2, 512, 512, 8, 1, 256, 256, "bf16"), "fma"),
    "hd64_hdv128": ((2, 64, 64, 8, 8, 64, 128, "bf16"), "fma"),
    "hd128_hdv64": ((2, 64, 64, 8, 8, 128, 64, "bf16"), "fma"),
    "hd32": ((2, 64, 64, 8, 8, 32, 32, "bf16"), "fma"),
}


def _meta(B, S, T, H, K, hd, hdv, dtype):
    td = DTYPES[dtype]
    return (torch.empty(B, S, H, hd, dtype=td, device="meta"),
            torch.empty(B, T, K, hd, dtype=td, device="meta"),
            torch.empty(B, T, K, hdv, dtype=td, device="meta"))


@pytest.mark.parametrize("case", list(BWD_ROUTE_CASES))
def test_bwd_route_choice(case):
    """Tensor cores for bf16 heads of 64 and 128 with hd == hdv (the
    training shapes, any S), f32 FMAs for f32 and for every other head."""
    shape, want = BWD_ROUTE_CASES[case]
    assert _bwd_route(*_meta(*shape)) == want


@pytest.mark.parametrize("case", list(BWD_ROUTE_CASES))
def test_bwd_route_matches_fwd_route_past_decode(case):
    """Past the decode rows (S > 4) the backward takes the tensor cores
    exactly where the forward does, so a training step's forward,
    recompute and backward all run on one kind of kernel."""
    shape, _ = BWD_ROUTE_CASES[case]
    q, k, v = _meta(*shape)
    if q.shape[1] > 4:
        assert (_bwd_route(q, k, v) == "mma") == (_fwd_route(q, k, v) == "mma")


def _counts():
    return (mha_fwd.launches, dict(mha_fwd.route_launches),
            mha_bwd_dq.launches, dict(mha_bwd_dq.route_launches),
            mha_bwd_dkv.launches, dict(mha_bwd_dkv.route_launches))


# tiny CPU shapes: (B, S, T, H, K, hd, causal, kv_len)
CPU_CASES = {
    "causal_gqa_hd64": (1, 20, 20, 4, 2, 64, True, None),
    "kvlen_hd128": (1, 3, 24, 2, 1, 128, False, 10),
}


def _bwd_args(case, td, seed=3):
    B, S, T, H, K, hd, causal, kv_len = CPU_CASES[case]
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(td)
    q, k, v, do = rnd(B, S, H, hd), rnd(B, T, K, hd), rnd(B, T, K, hd), \
        rnd(B, S, H, hd)
    out, lse = mha_fwd_ref(q, k, v, kv_len, scale=hd ** -0.5, causal=causal)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta, kv_len), dict(scale=hd ** -0.5,
                                                   causal=causal)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CPU_CASES))
def test_cpu_backward_wrappers_take_the_plain_versions(case, dtype):
    """On CPU tensors mha_bwd_dq and mha_bwd_dkv return their plain
    versions exactly, whatever route the same shape would take on the
    card, and leave every launch and route counter as it was."""
    args, kw = _bwd_args(case, DTYPES[dtype])
    before = _counts()
    dq = mha_bwd_dq(*args, **kw)
    dk, dv = mha_bwd_dkv(*args, **kw)
    assert _counts() == before
    torch.testing.assert_close(dq, mha_bwd_dq_ref(*args, **kw), rtol=0,
                               atol=0)
    want_k, want_v = mha_bwd_dkv_ref(*args, **kw)
    torch.testing.assert_close(dk, want_k, rtol=0, atol=0)
    torch.testing.assert_close(dv, want_v, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cpu_flash_attention_backward_counts_no_launch(dtype):
    """A forward and backward through dispatch.flash_attention on CPU
    tensors (the training step's attention) counts no kernel launch on
    any route of the three wrappers."""
    (q, k, v, do, *_), kw = _bwd_args("causal_gqa_hd64", DTYPES[dtype])
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    before = _counts()
    out = dispatch.flash_attention(q, k, v, **kw)
    grads = torch.autograd.grad(out, [q, k, v], do)
    assert _counts() == before
    assert all(g.shape == x.shape and g.dtype == x.dtype
               for g, x in zip(grads, (q, k, v)))
