"""llama-3.2-vision-11b's ``SMOKE`` twin in the port against the JAX
package: ``loss_fn`` and every gradient in f32, and in bf16 with the data
pipeline's f32 image embeddings (ROADMAP.md reference caveat 13); the
route without images (JAX's cross sub-layer then runs causal
self-attention with RoPE over the text through the cross weights:
caveat 14) in the forward, prefill, decode and ``greedy_generate``; one
``scale_fused`` step. The layer, the cache with images and the data:
``tests/test_torch_vlm.py``, whose helpers this file takes.

Tolerances: the f32 loss 1e-5 relative (observed 4.6e-7), gradients 1e-5
of each leaf's largest |gradient|, hidden states and logits 1e-4
absolute (``tests/test_torch_serving.py``; observed 1.5e-6), the step's
params 8 ulps of their peak plus 1e-5 of the leaf's step
(``tests/test_torch_trainer.py``'s reasons), the Adam leaves (the norms)
1e-2 of their step (``tests/test_torch_jamba_smoke.py``'s
``VECTOR_REL``, for its reason); bf16: the loss 1e-2 relative (observed
8.4e-6), every gradient per element within 2e-2 of its largest |ref|
plus 2e-2 relative (``_close``; observed 1.05e-2 of the largest |ref|
for the matrices and up to 2.7e-2 for the norm scales, a sum over every
token in bf16, which is 0.70 of their bound).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as j_make  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.core.labels import LabelRules  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import to_flat  # noqa: E402
from repro_torch.training import init_state, make_train_step  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402
from test_torch_vlm import (SEG, TOL, _batch, _close,  # noqa: E402
                            _jax_model, _jb, _jflat, _model, _np, _tb)

VECTOR_REL = 1e-2  # the Adam leaves' share of their step (docstring)


def _ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 23)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_loss(dtype):
    """JAX's (total, metrics, flat gradients) on the first batch."""
    jcfg, jp, _ = _jax_model(dtype)
    (total, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, _jb(_batch()))
    return float(total), {k: float(v) for k, v in m.items()}, _jflat(g)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_smoke_loss_and_grads_match_jax(dtype):
    """``loss_fn`` and every leaf's gradient of the two vlm super-blocks
    (cross, cross_ffn, attn1, ffn1) against JAX's; bf16 with the data
    pipeline's f32 image embeddings (caveat 13)."""
    jcfg, tcfg, jp, tp = _model(dtype)
    jtotal, jm, want = _jax_loss(dtype)
    b = _tb(_batch())
    assert b["image_embeds"].dtype == torch.float32
    leaves = {k: p.detach().requires_grad_() for k, p in flatten(tp).items()}
    total, tm = TM.loss_fn(unflatten(leaves), tcfg, b)
    grads = torch.autograd.grad(total, list(leaves.values()))
    rel = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=rel)
    np.testing.assert_allclose(float(tm["loss"].detach()), jm["loss"],
                               rtol=rel)
    assert float(tm["aux"]) == jm["aux"] == 0.0
    assert set(want) == set(leaves)
    for sub in ("cross/wq", "cross/wk", "cross_ffn/w_up", "attn1/wv",
                "ffn1/w_down"):
        assert f"segments/{SEG}/{sub}" in want, sub
    for k, g in zip(leaves, grads):
        assert g.dtype == leaves[k].dtype, k
        if dtype == "f32":
            err = np.abs(_np(g) - want[k])
            assert np.isfinite(_np(g)).all(), k
            assert (err <= 1e-5 * np.abs(want[k]).max()).all(), (
                k, float(err.max()))
        else:
            _close(g, want[k], TOL[dtype], k)


def test_no_image_route_matches_jax():
    """Without image embeddings (caveat 14) JAX's cross sub-layer runs
    causal self-attention with RoPE over the text through the cross
    weights, in mode "train" and without a cache, so a decode step's
    cross sub-layer sees the current token alone: the forward, the
    prefill and decode logits step by step and ``greedy_generate``'s
    tokens (which pass no images, in both packages) against JAX's."""
    jcfg, tcfg, jp, tp = _model("f32")
    Bs, P, n_dec = 2, 24, 3
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                             (Bs, P + n_dec), dtype=np.int32)
    jh, _, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        th, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4, rtol=0)

    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[:, :P]))
    np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)

    want = np.asarray(JS.greedy_generate(jcfg, jp, jnp.asarray(toks[:, :8]),
                                         5, 16))
    got = TS.greedy_generate(tcfg, tp, toks[:, :8], 5, 16, device="cpu")
    assert got.shape == want.shape == (Bs, 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_train_step_matches_jax():
    """One ``scale_fused`` step (clip 1.0) on JAX's batch with its f32
    images: metrics, every param and the optimizer state's momentum of
    the head against JAX's trainer. The cross weights take SCALE's column
    norm like every hidden matrix, the norms Adam."""
    jcfg, tcfg, jp, tp = _model("f32")
    b = _batch()
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    js, jm = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))(
        JT.init_state(jp, jtx), _jb(b))
    ts, tm = make_train_step(tcfg, ttx, clip_norm=1.0)(init_state(tp, ttx),
                                                       _tb(b))
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    old, got = _jflat(jp), to_flat(ts.params)
    want = _jflat(js.params)
    assert set(got) == set(want)
    for k, w in want.items():
        step = np.abs(w - old[k])
        vec = LabelRules().classify(k, w.ndim) == "vector"
        tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(
            np.abs(w), step))) + (VECTOR_REL if vec else 1e-5) * step.max()
        err = np.abs(got[k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
