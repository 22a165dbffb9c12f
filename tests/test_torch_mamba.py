"""Mamba2 and mamba2-370m in the port against the JAX package: the chunk
choice, ``_causal_conv``, ``_ssd_chunked`` (forward and gradients, and
the overflow of JAX's intra-chunk decay: ROADMAP.md Queue 3 caveat 12),
``apply_mamba`` in train, prefill and decode (the caches written in
place), the ``ssm`` models (the mamba2-370m ``SMOKE`` twin and
``tests/test_serving.py``'s tiny ssm config): loss, gradients, one
``scale_fused`` step, prefill and decode, greedy tokens, a packed batch,
the cache, the alog/dtbias inits and what raises.

Inputs are made with numpy from a seed and handed to both sides; model
params cross over through ``load_flat``. Torch runs on one intra-op
thread (see ``tests/test_torch_optimizers.py``).

Tolerances, per element, against the largest |ref| of the tensor
(``_close``):
  * f32 outputs, states and gradients: 1e-5 of the largest |ref| + 1e-5
    relative (sums of up to 64 products in other orders; observed 4.8e-7
    of it);
  * bf16: 2e-2 of the largest |ref| + 2e-2 relative, as
    ``tests/test_torch_moe.py`` (each side rounds every product and sum
    to bf16 at its own places; observed 1.35e-2 of it);
  * the overflow case against JAX in float64: 1e-4 of the largest |ref|
    (the port's f32 sums of up to 256 terms against f64; observed
    5.2e-6 of it).
The models (f32): hidden states, logits and caches 1e-4 absolute
(``tests/test_torch_serving.py``; observed 3.1e-6), the loss 1e-5
relative, gradients 1e-5 of each leaf's largest |gradient| (observed
1.6e-6 of it), the step's params 8 ulps of their peak plus 1e-5 of the
leaf's step (``tests/test_torch_trainer.py``'s reasons). The layer's
Adam leaves (``ADAM_SSM``) take Adam's first step, lr * g / (|g| + eps)
with g = m_hat: where a gradient nearly cancels (a conv_w tap's sums to
6e-6 of terms near 1e-2, times the clip's factor), eps / |g| is no longer
small and the step carries that share of the two sides' rounding of g;
they are held to 2e-4 of their step, as ``tests/test_torch_arch_configs.py``
holds qwen2's qkv biases (observed 4.8e-5 of it).
"""
import dataclasses
import functools
import math
import warnings
from types import SimpleNamespace

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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import (init_state, make_eval_step,  # noqa: E402
                                  make_train_step)
from repro_torch.training import serving as TS  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p).lstrip("."): np.asarray(x.astype(jnp.float32))
            if x.dtype != jnp.int32 else np.asarray(x) for p, x in leaves}


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 23)


def _close(got, want, tol, what):
    """Per element within tol * max|want| + tol * |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert (err <= tol * scale + tol * np.abs(want)).all(), (
        what, float(err.max() / scale))


def _pair(a, dtype):
    """numpy ``a`` as (JAX, torch) arrays of ``dtype``, the same values."""
    jd, td = DTYPES[dtype]
    return (jnp.asarray(a, jnp.float32).astype(jd),
            torch.tensor(np.asarray(a), dtype=torch.float32).to(td))


# ----------------------------------------------------------- chunk choice

@pytest.mark.parametrize("S", [64, 48, 40, 35])
def test_pick_block_matches_jax(S):
    """The same chunk as JAX's, and a warning at the same lengths (35
    has no divisor in (8, 16])."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = JL._pick_block(S, S, 16)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TL._pick_block(S, S, 16)
    assert got == want
    assert len(tw) == len(jw) == (1 if S == 35 else 0)
    if tw:
        assert str(tw[0].message) == str(jw[0].message)
    assert TL.largest_divisor(S, 16) == JL.largest_divisor(S, 16)


# ----------------------------------------------------------- causal conv

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_causal_conv_matches_jax(mode, dtype):
    """y (after SiLU) and the new state: the last dconv-1 pre-activation
    inputs, with zeros prepended in train and the state in decode."""
    rng = np.random.default_rng(1)
    B, C, dconv = 2, 24, 4
    S = 1 if mode == "decode" else 12
    jx, tx = _pair(rng.standard_normal((B, S, C)), dtype)
    jw, tw = _pair(0.5 * rng.standard_normal((dconv, C)), dtype)
    jb, tb = _pair(0.1 * rng.standard_normal((C,)), dtype)
    jst = tst = None
    if mode == "decode":
        jst, tst = _pair(rng.standard_normal((B, dconv - 1, C)), dtype)
    jy, jnew = jax.jit(JL._causal_conv)(jx, jw, jb, jst)
    ty, tnew = TL._causal_conv(tx, tw, tb, tst)
    assert ty.dtype == tnew.dtype == tx.dtype
    _close(ty, jy, TOL[dtype], "y")
    _close(tnew, jnew, 0.0, "state")   # a copy of inputs: exact


# ------------------------------------------------------------ chunked SSD

def _ssd_inputs(rng, B, S, nh, hd, G, N, dt_max=0.1):
    xh = rng.standard_normal((B, S, nh, hd))
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(dt_max), (B, S, nh)))
    A = -rng.uniform(1.0, 16.0, (nh,))
    Bm = rng.standard_normal((B, S, G, N)) / np.sqrt(N)
    Cm = rng.standard_normal((B, S, G, N)) / np.sqrt(N)
    r = rng.standard_normal((B, S, nh, hd))
    return xh, dt, A, Bm, Cm, r


@pytest.mark.parametrize("G", [1, 2], ids=["groups1", "groups2"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_chunked_matches_jax(dtype, G):
    """y and the gradients of sum(y * r) in x, dt, A, B and C at 4
    chunks of 16; dt and A f32 as ``apply_mamba`` gives them, x, B, C in
    the model dtype. With 2 groups of 2 heads each, a tiled repeat of the
    groups (in place of JAX's ``jnp.repeat``) would pair heads with the
    wrong B and C."""
    rng = np.random.default_rng(2)
    xh, dt, A, Bm, Cm, r = _ssd_inputs(rng, 2, 64, 4, 8, G, 8)
    jd, td = DTYPES[dtype]
    jin = [jnp.asarray(xh, jnp.float32).astype(jd),
           jnp.asarray(dt, jnp.float32), jnp.asarray(A, jnp.float32),
           jnp.asarray(Bm, jnp.float32).astype(jd),
           jnp.asarray(Cm, jnp.float32).astype(jd)]
    tin = [torch.tensor(v, dtype=torch.float32).to(td if k in (0, 3, 4)
                                                   else torch.float32)
           for k, v in enumerate((xh, dt, A, Bm, Cm))]

    def jloss(*a):
        y = JL._ssd_chunked(*a, chunk=16)
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, jy), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*jin)
    tin = [t.requires_grad_() for t in tin]
    y = TL._ssd_chunked(*tin, chunk=16)
    assert y.dtype == td
    tg = torch.autograd.grad((y.float() * torch.from_numpy(r)).sum(), tin)
    tol = TOL[dtype]
    _close(y, jy, tol, "y")
    for name, g, w in zip(("x", "dt", "A", "B", "C"), tg, jg):
        assert g.dtype == tin[["x", "dt", "A", "B", "C"].index(name)].dtype
        _close(g, w, tol, f"d{name}")


def test_ssd_overflow_gradients_finite_and_match_jax_in_float64():
    """Caveat 12's witness at (1, 512, 4 heads of 8), chunk 256, dt 0.1,
    A = -[1, 4, 8, 16]: above the diagonal li - lj reaches 408, past f32
    exp's 88.7. JAX's f32 gradient of dt is not finite (0 * inf in the
    masked decay's backward); the port's f32 gradients are finite and
    match JAX's in float64, where exp(408) fits; its y equals JAX's f32
    y."""
    rng = np.random.default_rng(3)
    xh, _, _, Bm, Cm, r = _ssd_inputs(rng, 1, 512, 4, 8, 1, 8)
    dt = np.full((1, 512, 4), 0.1)
    A = -np.array([1.0, 4.0, 8.0, 16.0])
    args = (xh, dt, A, Bm, Cm)
    assert (dt[0, :255, 3] * 16).sum() > 88.7

    def jloss(*a):
        y = JL._ssd_chunked(*a, chunk=256)
        return jnp.sum(y * r), y

    grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4),
                                      has_aux=True))
    (_, jy32), jg32 = grad(*(jnp.asarray(a, jnp.float32) for a in args))
    assert not np.isfinite(np.asarray(jg32[1])).all()
    with jax.enable_x64(True):
        (_, jy64), jg64 = grad(*(jnp.asarray(a, jnp.float64) for a in args))
        jg64 = [np.asarray(g) for g in jg64]
        jy64 = np.asarray(jy64)
    assert all(np.isfinite(g).all() for g in jg64)

    tin = [torch.tensor(a, dtype=torch.float32).requires_grad_()
           for a in args]
    y = TL._ssd_chunked(*tin, chunk=256)
    tg = torch.autograd.grad((y * torch.from_numpy(r).float()).sum(), tin)
    _close(y, jy32, 1e-5, "y against JAX's f32")
    _close(y, jy64, 1e-4, "y against JAX's f64")
    for name, g, w in zip(("x", "dt", "A", "B", "C"), tg, jg64):
        _close(g, w, 1e-4, f"d{name}")


# ------------------------------------------------------------ apply_mamba

def _narrow_cfg(dtype, G=2):
    return tiny_cfg("mamba_narrow", family="ssm", n_heads=0, n_kv_heads=0,
                    d_ff=0, ssm_state=16, ssm_headdim=16, ssm_ngroups=G,
                    ssm_chunk=16, dtype={"f32": "float32",
                                         "bf16": "bfloat16"}[dtype])


def _layer_case(dtype, B=2, S=48, seed=0):
    """The layer at 8 heads of 16 over 2 groups, chunk 16: random leaves
    of JAX's ``mamba_spec`` shapes, A_log and dt_bias by their init
    rules, and x."""
    jcfg = _narrow_cfg(dtype)
    rng = np.random.default_rng(seed)
    p = {}
    for k, s in JL.mamba_spec(jcfg).items():
        if s.init == "alog":
            p[k] = np.log(rng.uniform(1.0, 16.0, s.shape))
        elif s.init == "dtbias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), s.shape))
            p[k] = dt + np.log(-np.expm1(-dt))
        elif s.init == "ones":
            p[k] = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif s.init == "zeros":
            p[k] = 0.1 * rng.standard_normal(s.shape)
        elif k == "conv_w":
            p[k] = 0.5 * rng.standard_normal(s.shape)
        else:
            p[k] = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
    x = rng.standard_normal((B, S, jcfg.d_model))
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jp, tp = {}, {}
    for k, v in p.items():
        jp[k], tp[k] = _pair(v, dtype)
    jx, tx = _pair(x, dtype)
    return jcfg, _tcfg(jcfg), (jp, jx), (tp, tx), r


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mamba_train_matches_jax(dtype):
    """Train mode over 3 chunks: the output and the gradients of x and
    every leaf of sum(y * r), against JAX's."""
    jcfg, tcfg, (jp, jx), (tp, tx), r = _layer_case(dtype)

    def jloss(p, x):
        y, _ = JL.apply_mamba(p, jcfg, x, JRules(), mode="train")
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jx)
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, cache = TL.apply_mamba(leaves, tcfg, x, mode="train")
    assert cache is None and y.dtype == tx.dtype
    grads = torch.autograd.grad((y.float() * torch.from_numpy(r)).sum(),
                                [x, *leaves.values()])
    tol = TOL[dtype]
    _close(y, jy, tol, "y")
    want = {"x": jgx, **jgp}
    for name, g in zip(["x", *leaves], grads):
        assert g.dtype == tx.dtype
        _close(g, want[name], tol, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mamba_prefill_and_decode_match_jax(dtype):
    """prefill's output and cache (conv in the model dtype, ssm f32), then
    two decode steps: the output and the new conv and ssm states, written
    into the same cache tensors IN PLACE, against JAX's, step by step."""
    jcfg, tcfg, (jp, jx), (tp, tx), _ = _layer_case(dtype, S=34)
    P = 32
    jpre = jax.jit(lambda p, x: JL.apply_mamba(p, jcfg, x, JRules(),
                                               mode="prefill"))
    jy, jc = jpre(jp, jx[:, :P])
    y, pre = TL.apply_mamba(tp, tcfg, tx[:, :P], mode="prefill")
    tol = TOL[dtype]
    _close(y, jy, tol, "prefill y")
    assert set(pre) == {"conv", "ssm"}
    assert pre["conv"].dtype == tx.dtype and pre["ssm"].dtype == torch.float32
    for k in pre:
        _close(pre[k], jc[k], tol, f"prefill {k}")
    # each side's own prefill cache, in a cache of init_cache's dtypes
    tc = TL.mamba_cache(tcfg, tx.shape[0], tx.dtype, "cpu")
    for k in tc:
        tc[k].copy_(pre[k])
    held = dict(tc)
    jdec = jax.jit(lambda p, x, c: JL.apply_mamba(p, jcfg, x, JRules(),
                                                   mode="decode", cache=c))
    for i in range(P, P + 2):
        jy, jc = jdec(jp, jx[:, i:i + 1], jc)
        y, out = TL.apply_mamba(tp, tcfg, tx[:, i:i + 1], mode="decode",
                                cache=tc)
        assert out is tc and all(tc[k] is held[k] for k in tc)
        assert tc["ssm"].dtype == torch.float32 and y.dtype == tx.dtype
        _close(y, jy, tol, f"decode step {i}")
        for k in tc:
            _close(tc[k], jc[k], tol, f"decode step {i} {k}")


# ---------------------------------------------------------------- models

MODEL_CFGS = {
    "smoke": lambda: jreg.get_arch("mamba2-370m", smoke=True),
    # tests/test_serving.py's tiny ssm config
    "ssm_tiny": lambda: tiny_cfg("ssm", family="ssm", n_heads=0,
                                 n_kv_heads=0, ssm_state=16, ssm_headdim=16,
                                 ssm_chunk=8),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name):
    jcfg = MODEL_CFGS[name]()
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model(name):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model(name)
    tcfg = _tcfg(jcfg)
    assert tcfg.segments == (("ssm", jcfg.n_layers),)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


def _batch(jcfg, batch=2, seq=32, seed=3, **kw):
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed, **kw)
    return {k: np.array(v) for k, v in ds.global_batch_at(0).items()}


def test_smoke_twin_is_jax_s():
    assert dataclasses.asdict(treg.get_arch("mamba2-370m", smoke=True)) == \
        dataclasses.asdict(MODEL_CFGS["smoke"]())


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_loss_and_grads_match_jax(name):
    """``loss_fn`` and every leaf's gradient against JAX's (the smoke
    twin's 2 chunks of 16 a row)."""
    jcfg, tcfg, jp, tp = _model(name)
    b = _batch(jcfg)
    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(tp).items()}
    total, tm = TM.loss_fn(unflatten(leaves), tcfg,
                           {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(total, list(leaves.values()))
    np.testing.assert_allclose(_np(total), _np(jtotal), rtol=1e-5)
    assert float(tm["aux"]) == 0.0
    want = _jflat(jg)
    assert set(want) == set(leaves)
    assert f"segments/seg0_ssm/mamba/A_log" in want
    for k, g in zip(leaves, grads):
        w = want[k]
        err = np.abs(_np(g) - w)
        assert np.isfinite(_np(g)).all(), k
        assert (err <= 1e-5 * np.abs(w).max()).all(), (k, float(err.max()))


# the layer's Adam ("vector") leaves besides the norms
ADAM_SSM = ("conv_w", "conv_b", "A_log", "D", "dt_bias")


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_train_step_matches_jax(name):
    """One ``scale_fused`` step (clip 1.0): metrics and every updated
    param against JAX's trainer. conv_w, conv_b, A_log, D, dt_bias and
    the norms take Adam ("vector"), in_proj and out_proj SCALE's
    column norm."""
    jcfg, tcfg, jp, tp = _model(name)
    b = _batch(jcfg)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    js, jm = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))(
        JT.init_state(jp, jtx), {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = make_train_step(tcfg, ttx, clip_norm=1.0)(
        init_state(tp, ttx), {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    old = _jflat(jp)
    for k, w in _jflat(js.params).items():
        step = np.abs(w - old[k])
        rel = 2e-4 if k.rsplit("/", 1)[-1] in ADAM_SSM else 1e-5
        tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(np.abs(w), step))
                       ) + rel * step.max()
        err = np.abs(flatten(ts.params)[k].float().numpy() - w)
        assert (err <= tol).all(), (k, float(err.max()))


def test_packed_batch_loss_matches_jax():
    """A packed batch (segment ids, positions, loss weights) goes through
    unchanged: the Mamba sub-layer ignores the segment ids, as JAX's
    does, and the loss equals JAX's."""
    jcfg, tcfg, jp, tp = _model("smoke")
    b = _batch(jcfg, pack_documents=True)
    assert "segment_ids" in b and len(np.unique(b["segment_ids"])) > 2
    jtotal, _ = jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    total, _ = TM.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
    np.testing.assert_allclose(_np(total), _np(jtotal), rtol=1e-5)


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_prefill_and_decode_match_jax(name):
    """Prefill 24 tokens, then 4 decode steps: the logits and the conv and
    ssm caches against JAX's, step by step; the decode steps keep the
    cache tensors they were given; the last logits equal the full
    forward's (JAX's ``tests/test_serving.py`` check)."""
    jcfg, tcfg, jp, tp = _model(name)
    Bs, P, n_dec = 2, 24, 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (Bs, P + n_dec), dtype=np.int32)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[:, :P]))
    held = flatten(state.cache)
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)
    seg = f"seg0_ssm"

    def check():
        assert int(state.index) == int(jstate.index)
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(
                _np(state.cache[seg]["mamba"][k]),
                _np(jstate.cache[seg]["mamba"][k]), atol=1e-4, rtol=0)
        assert all(v is held[k] for k, v in flatten(state.cache).items())

    check()
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        check()
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, -1]
    torch.testing.assert_close(log[:, -1], ref, atol=2e-4, rtol=0)


def test_greedy_tokens_match_jax():
    jcfg, tcfg, jp, tp = _model("smoke")
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20),
                                               dtype=np.int32)
    want = JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), n_steps=6,
                              max_seq=26)
    got = TS.greedy_generate(tcfg, tp, prompt, n_steps=6, max_seq=26,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_init_cache_matches_jax(name, dtype):
    """Every cache leaf's path, shape and dtype: conv in the model dtype,
    ssm always f32, neither with a sequence axis."""
    jcfg = dataclasses.replace(MODEL_CFGS[name](), dtype=dtype)
    leaves, _ = jax.tree_util.tree_flatten_with_path(JM.init_cache(jcfg, 2,
                                                                   24))
    want = {path_str(p).lstrip("."): (tuple(x.shape), str(x.dtype))
            for p, x in leaves}
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in flatten(TM.init_cache(_tcfg(jcfg), 2, 24,
                                             device="cpu")).items()}
    assert got == want
    L = jcfg.n_layers
    assert got["seg0_ssm/mamba/ssm"] == ((L, 2, jcfg.ssm_nheads,
                                          jcfg.ssm_state, jcfg.ssm_headdim),
                                         "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_alog_and_dtbias_inits(dtype):
    """-exp(A_log) in [-16, -1) and softplus(dt_bias) in [1e-3, 1e-1] (to
    the model dtype's rounding), drawn anew per layer; an init name the
    port does not know raises instead of drawing a normal."""
    cfg = dataclasses.replace(treg.get_arch("mamba2-370m", smoke=True),
                              dtype=dtype)
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    m = p["segments"]["seg0_ssm"]["mamba"]
    assert m["A_log"].dtype == cfg.torch_dtype
    rel = 1e-6 if dtype == "float32" else 2 ** -7
    a = torch.exp(m["A_log"].double())
    assert a.shape == (cfg.n_layers, cfg.ssm_nheads)
    assert (a >= 1 - rel).all() and (a <= 16 * (1 + rel)).all()
    assert a.std() > 1.0 and not torch.equal(a[0], a[1])
    dt = torch.nn.functional.softplus(m["dt_bias"].double())
    assert (dt >= 1e-3 * (1 - rel)).all() and (dt <= 0.1 * (1 + rel)).all()
    assert dt.max() / dt.min() > 2
    bad = TL.Spec((4,), (None,), "uniform")
    with pytest.raises(ValueError, match="unknown init 'uniform'"):
        TM._init_leaf(bad, torch.Generator())


def test_ssm_under_a_mesh_raises_before_any_work():
    """Mamba2 runs on a mesh in modes train and prefill: the train and eval
    steps build on a (duck-typed) (1, 1) mesh
    (``tests/test_torch_sharded_mamba.py`` runs them on a gloo mesh).
    Decode on a mesh is sharded serving, not ported: forward in mode
    decode raises before any work, naming it."""
    tcfg = _tcfg(MODEL_CFGS["smoke"]())
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=mesh))
    assert callable(make_eval_step(tcfg, mesh=mesh))
    with pytest.raises(NotImplementedError, match="sharded serving"):
        TM.forward(None, tcfg, None, mode="decode", mesh=mesh)


def test_remat_policies_match_none():
    """The smoke twin's gradients under remat "full" and "dots" (the SSD's
    batched products recomputed, the projections saved) equal those
    without remat, bitwise."""
    _, tcfg, _, tp = _model("smoke")
    b = {k: torch.from_numpy(v) for k, v in _batch(MODEL_CFGS["smoke"]())
         .items()}
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(tcfg, remat=remat)
        leaves = {k: p.detach().requires_grad_() for k, p in
                  flatten(tp).items()}
        total, _ = TM.loss_fn(unflatten(leaves), c, b)
        out[remat] = torch.autograd.grad(total, list(leaves.values()))
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(out[remat],
                                                     out["none"])), remat
