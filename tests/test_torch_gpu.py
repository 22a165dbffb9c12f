"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.) The kernel
cases are those of phase 2 of ``chip_smoke.py``; a last test serves a small
model on the card through the kernel. Kernel tolerances, per element:
  * f32 out: 2e-5 absolute (unit-scale values summed in other orders);
  * bf16 out: 2e-2 + 2e-2*|ref| — the kernel rounds the running,
    unnormalized p to bf16, the plain version the normalized p, and the
    output itself has 8 bits of mantissa;
  * lse (f32 from exact products in both dtypes): 1e-4 + 1e-5*|ref|, on
    rows with at least one valid key.
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
