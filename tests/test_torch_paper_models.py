"""The paper's two largest models in the port, against the JAX package:
llama-7b (D = 4096, 32 heads of 128) and gemma-2b (8 heads of 256 over one
kv head, vocab 256000).

On the card they need two clauses the port's kernels gained together: the
cross-entropy kernels past D = 2048, and the attention backward at head
dim 256. Here, on the CPU, the wrappers take their plain versions, which
are held against the JAX package's Pallas kernels in interpret mode at
those widths; a small gemma-like model (2 layers, 8 heads of 256 over 1 kv
head) takes two training steps on both sides from the same params; and
the two full-size configurations are held to the JAX ones field by field
and shape by shape, without allocating them. The CUDA kernels are held
against the plain versions on the card by ``tests/test_torch_gpu.py``.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, per element:
  * xent lse, ll and f32 gradients: 2e-5 absolute + 1e-5 relative — exact
    f32 products of the inputs summed in f32 in other orders, over D of up
    to 4100 terms (about 64 * 2**-24 of a unit-scale sum);
  * xent gradients written as bf16: 1e-5 + 8e-3 relative (one rounding on
    each side of f32 sums that differ in their last bits);
  * attention gradients: f32 2e-6 * max|ref|; bf16 1e-5 * max|ref| + 8e-3
    * |ref| (``tests/test_torch_attention_bwd.py`` says why); at hd 256 a
    score sums 256 products, four times as many as the widest case there
    (observed at most 9.8e-7 of max|ref| in f32, 1.3e-3 in bf16);
  * the training steps: those of ``tests/test_torch_trainer.py`` (params
    within a few ulps of their peak plus a share of their travel, metrics
    relative), with its reasons.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.kernels.attention import attention as jattn  # noqa: E402
from repro.kernels.xent import xent as JX  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels.attention.attention import (  # noqa: E402
    _bwd_route, mha_bwd_dkv, mha_bwd_dq)
from repro_torch.kernels.xent import xent as TX  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import init_state, make_train_step  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
PAPER_MODELS = ("llama-7b", "gemma-2b")
_MANT = {"float32": 23, "bfloat16": 7}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------- the full-size configurations

@pytest.mark.parametrize("arch", PAPER_MODELS)
def test_paper_model_param_shapes_match_jax(arch):
    """Config fields and every parameter's path and shape as the JAX
    ``model_spec`` gives them, from the specs alone (nothing allocated)."""
    j, t = jreg.get_arch(arch), treg.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.model_spec(j), is_leaf=lambda x: isinstance(x, JL.Spec))
    want = {path_str(p).lstrip("."): tuple(s.shape) for p, s in leaves}
    assert TM.param_shapes(t) == want
    assert TM.count_params(TM.param_shapes(t)) == j.num_params()


def test_paper_model_shapes_reach_the_new_clauses():
    """llama-7b's loss runs the xent kernels at D = 4096, past the old
    2048; gemma-2b's attention runs the backward at head dim 256 over one
    kv head, on the fma kernels in bf16; both train through the stacked
    leaves the optimizer kernels take (llama-7b's MLP leaf is 1.44e9
    elements, below the vec route's 2**31)."""
    llama, gemma = treg.get_arch("llama-7b"), treg.get_arch("gemma-2b")
    assert llama.d_model == 4096 and llama.head_dim == 128
    assert (gemma.head_dim, gemma.n_heads, gemma.n_kv_heads) == (256, 8, 1)
    assert gemma.padded_vocab == 256000
    shapes = TM.param_shapes(llama)
    assert shapes["segments/seg0_dense/ffn/w_gate"] == (32, 4096, 11008)
    assert np.prod(shapes["segments/seg0_dense/ffn/w_gate"]) < 2**31
    q = torch.empty((1, 8, 8, 256), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 8, 1, 256), dtype=torch.bfloat16, device="meta")
    assert _bwd_route(q, kv, kv) == "fma"
    # gemma-2b's head: 4 splits of 250 vocab tiles forward, 63 chunks of
    # 4096 columns backward
    assert TX.split_plan(4096, 256000) == (4, 250)
    assert TX.chunk_plan(4096, 256000) == (4096, 4096)


# ------------------------------------------------ xent past D = 2048

# (N, D, V, vocab_size, share of -1 labels): llama-7b's D, and D that ends
# the FMA kernels' last slab of 2048 mid-way
XENT_CASES = {
    "d4096": (19, 4096, 256, 250, 0.2),
    "d2056_ragged_slab": (37, 2056, 384, 384, 0.1),
    "d4100_ragged_slab": (21, 4100, 128, 120, 0.2),
}


def _xent_inputs(case, dtype, seed=0):
    N, D, V, vs, masked = XENT_CASES[case]
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D), dtype=np.float32)
    w = rng.standard_normal((D, V), dtype=np.float32) / np.sqrt(D)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < masked] = -1
    lse = (rng.standard_normal(N) + np.log(V)).astype(np.float32)
    gl = np.where(labels >= 0, rng.random(N), 0).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = (jnp.asarray(h).astype(jd), jnp.asarray(w).astype(jd),
         jnp.asarray(labels), jnp.asarray(lse), jnp.asarray(gl))
    t = (torch.from_numpy(h).to(td), torch.from_numpy(w).to(td),
         torch.from_numpy(labels), torch.from_numpy(lse),
         torch.from_numpy(gl))
    return j, t, vs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(XENT_CASES))
def test_xent_past_d2048_matches_jax_kernels(case, dtype):
    """The three xent wrappers (plain versions on the CPU) against the JAX
    Pallas kernels in interpret mode; the backward in f32 and bf16."""
    (hj, wj, lj, sj, gj), (ht, wt, lt, st, gt), vs = _xent_inputs(case,
                                                                  dtype)
    want_lse, want_ll = JX.xent_fwd(hj, wj, lj, vocab_size=vs,
                                    interpret=True)
    lse, ll = TX.xent_fwd(ht, wt, lt, vocab_size=vs)
    np.testing.assert_allclose(_np(lse), _np(want_lse), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ll), _np(want_ll), atol=2e-5, rtol=1e-5)
    for out in ("f32", "bf16"):
        jo, to = DTYPES[out]
        atol, rtol = (2e-5, 1e-5) if out == "f32" else (1e-5, 8e-3)
        for jfn, tfn, shape in ((JX.xent_bwd_dh, TX.xent_bwd_dh, ht.shape),
                                (JX.xent_bwd_dw, TX.xent_bwd_dw, wt.shape)):
            want = jfn(hj, wj, lj, sj, gj, vocab_size=vs, interpret=True,
                       out_dtype=jo)
            got = tfn(ht, wt, lt, st, gt, vocab_size=vs, out_dtype=to)
            assert got.dtype == to and tuple(got.shape) == tuple(shape)
            np.testing.assert_allclose(_np(got), _np(want), atol=atol,
                                       rtol=rtol)


def test_xent_wrappers_take_any_d():
    """The checks that refused D > 2048 are gone: what is left is the
    kernels' 32-bit indexing, and every route keeps its other checks."""
    h = torch.zeros((2, 4096))
    w = torch.zeros((4096, 8))
    lab = torch.zeros(2, dtype=torch.int32)
    lse, ll = TX.xent_fwd(h, w, lab, vocab_size=8)
    assert torch.allclose(lse, torch.full((2,), float(np.log(8))))
    assert "MAX_D" not in TX.__all__ and not hasattr(TX, "MAX_D")
    with pytest.raises(ValueError, match="need h"):
        TX.xent_fwd(h, w[:4000], lab, vocab_size=8)


# -------------------------------------- the attention backward at hd 256

# (B, S, T, H, K, hd, causal, kv_len): gemma-2b's 8 heads over 1 kv head of
# 256, causal square (ragged), causal with T > S, and the kv_len bound
BWD_CASES = {
    "causal_g8_k1_hd256": (1, 21, 21, 8, 1, 256, True, None),
    "rect8x40_g8_k1_hd256": (1, 8, 40, 8, 1, 256, True, None),
    "kvlen29_g8_k1_hd256": (1, 4, 48, 8, 1, 256, False, 29),
}


def _close_grad(got, want, dtype):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    tol = (2e-6 * scale if dtype == "f32"
           else 1e-5 * scale + 8e-3 * np.abs(want))
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= tol).all(), float(err.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_at_hd256_matches_pallas_interpret(case, dtype):
    """mha_bwd_dq and mha_bwd_dkv (plain versions on the CPU) against the
    JAX kernels in interpret mode, lse and delta from the JAX forward."""
    B, S, T, H, K, hd, causal, kv_len = BWD_CASES[case]
    jd, td = DTYPES[dtype]
    scale = hd ** -0.5
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((B, S, H, hd), dtype=np.float32),
         rng.standard_normal((B, T, K, hd), dtype=np.float32),
         rng.standard_normal((B, T, K, hd), dtype=np.float32),
         rng.standard_normal((B, S, H, hd), dtype=np.float32))
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
    args = (q, k, v, do, torch.from_numpy(np.array(lse)),
            torch.from_numpy(np.array(delta)),
            None if kv_len is None else torch.tensor(kv_len,
                                                     dtype=torch.int32))
    kw = dict(scale=scale, causal=causal)
    got_dq = mha_bwd_dq(*args, **kw)
    got_dk, got_dv = mha_bwd_dkv(*args, **kw)
    assert got_dq.dtype == got_dk.dtype == got_dv.dtype == td
    _close_grad(got_dq, dq, dtype)
    _close_grad(got_dk, dk, dtype)
    _close_grad(got_dv, dv, dtype)


# ------------------------------------- a gemma-like model, trained

STEPS = 2


def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p).lstrip("."): np.asarray(x.astype(jnp.float32))
            if x.dtype != jnp.int32 else np.asarray(x) for p, x in leaves}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_gemma_like_train_steps_match_jax(dt):
    """Two ``scale_fused`` steps (clip 1.0) of a 2-layer model with
    gemma-2b's attention layout (8 heads of 256 over 1 kv head, so dK and
    dV sum 8 query heads, and RoPE over 256 dims) on both sides, from the
    JAX init moved over by ``load_flat``, on the JAX data pipeline's
    batches. Tolerances as ``tests/test_torch_trainer.py``."""
    jcfg = tiny_cfg("gemma_like", dtype=dt, n_heads=8, n_kv_heads=1,
                    head_dim=256, d_ff=192, vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = load_flat(_jflat(jp), tcfg, device="cpu")
    assert tuple(flatten(tp)["segments/seg0_dense/attn/wk"].shape) == (
        2, 64, 256)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0)
    js, ts = JT.init_state(jp, jtx), init_state(tp, ttx)
    ds = j_dataset(jcfg, seq_len=32, global_batch=4, seed=3)
    f32 = dt == "float32"
    rtol = ({"loss": 1e-5, "grad_norm": 1e-5, "update_norm": 1e-5} if f32
            else {"loss": 1e-3, "grad_norm": 5e-3, "update_norm": 3e-2})
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    for step in range(STEPS):
        b = {k: np.array(v) for k, v in ds.global_batch_at(step).items()}
        old = _jflat(js.params)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        for k, tol in rtol.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=k)
        for k, w in _jflat(js.params).items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
            got = flatten(ts.params)[k].detach().float().numpy()
            tol = ((8 * _ulp(peak[k], dt) + 1e-5 * travel[k].max()) if f32
                   else 3 * _ulp(peak[k], dt) + 0.15 * travel[k].max())
            err = np.abs(got - w)
            assert (err <= tol).all(), (step, k, float(err.max()))
