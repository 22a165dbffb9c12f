"""Multi-head Latent Attention and deepseek-v3-671b in the port against
the JAX package: ``mla_spec``, ``apply_mla_attention`` (train, packed
and the absorbed decode), the MLA sub-layer chosen by
``cfg.attention_kind``, the deepseek-v3 ``SMOKE`` twin's loss, gradients
and ``scale_fused`` step, prefill and decode, the cache, and what raises.

Inputs are made with numpy from a seed and handed to both sides; model
params cross over through ``load_flat``. Torch runs on one intra-op
thread (see ``tests/test_torch_optimizers.py``).

The layer alone runs at a narrow config that keeps deepseek-v3's head
widths (qk_nope 128 + qk_rope 64 = 192 for queries and keys, v 128: the
attention's hd != hdv), 4 heads, d_model 512, ranks 96/64. Tolerances, per
element, against the largest |ref| of the tensor (``_close``):
  * f32 output and gradients: 1e-5 of the largest |ref| + 1e-5 relative
    (sums of up to 512 products in other orders; observed 3.6e-7 of it);
  * bf16 output and gradients: 2e-2 of the largest |ref| + 2e-2 relative,
    as ``tests/test_torch_moe.py`` (each side rounds every product to
    bf16 at its own places, and the scores' bf16 rounding moves the
    softmax: ROADMAP Queue 3 caveat 1; observed 7.8e-3 of it).
The models (JAX's tiny MLA config of ``tests/test_serving.py`` and the
deepseek-v3 ``SMOKE`` twin, f32): hidden states and logits 1e-4 absolute
(``tests/test_torch_serving.py``; observed 2.4e-6), loss and aux 1e-5
relative, gradients 1e-5 of each leaf's largest |gradient| (observed
1.2e-6 of it), the step's params 8 ulps of their peak plus 1e-5 of the
leaf's step (``tests/test_torch_trainer.py``'s reasons).
"""
import contextlib
import dataclasses
import functools
import io
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
from repro_torch.launch import train as launch_train  # noqa: E402
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
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert (err <= tol * scale + tol * np.abs(want)).all(), (
        what, float(err.max() / scale))


def _mla_tiny():
    """JAX's own tiny MLA config (``tests/test_serving.py``)."""
    return tiny_cfg("mla", attention_kind="mla", q_lora_rank=32,
                    kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16,
                    v_head_dim=16)


# --------------------------------------------------------------- mla_spec

def _spec_leaves(spec, is_spec):
    leaves, _ = jax.tree_util.tree_flatten_with_path(spec, is_leaf=is_spec)
    return {path_str(p).lstrip("."): (tuple(s.shape), tuple(s.axes), s.init)
            for p, s in leaves}


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
def test_mla_spec_matches_jax(smoke):
    """Shapes, logical axes ("lora" among them) and inits of the layer,
    and of the whole deepseek-v3 model's MLA leaves, equal JAX's."""
    j = jreg.get_arch("deepseek-v3-671b", smoke=smoke)
    t = treg.get_arch("deepseek-v3-671b", smoke=smoke)
    want = {k: v for k, v in JL.mla_spec(j).items()}
    got = TL.mla_spec(t)
    assert set(got) == set(want) == {"wq_a", "q_norm", "wq_b", "wkv_a",
                                     "kv_norm", "wkv_b", "wo"}
    for k, s in got.items():
        assert (tuple(s.shape), tuple(s.axes), s.init) == (
            tuple(want[k].shape), tuple(want[k].axes), want[k].init), k
    assert got["wq_b"].shape[1] == t.n_heads * (t.qk_nope_dim + t.qk_rope_dim)
    jm = _spec_leaves(JM.model_spec(j), lambda x: isinstance(x, JL.Spec))
    tm = _spec_leaves(TM.model_spec(t), lambda x: isinstance(x, TL.Spec))
    assert tm == jm
    assert "segments/seg1_moe/attn/wkv_b" in tm
    assert TM.param_logical_axes(t)["segments/seg0_dense/attn/wq_a"] == (
        None, "embed", "lora")


# --------------------------------------------------- apply_mla_attention

def _narrow_cfg(dtype):
    """deepseek-v3's head widths at a narrow config."""
    return tiny_cfg("mla_narrow", attention_kind="mla", d_model=512,
                    n_heads=4, n_kv_heads=4, q_lora_rank=96,
                    kv_lora_rank=64, qk_rope_dim=64, qk_nope_dim=128,
                    v_head_dim=128, dtype={"f32": "float32",
                                           "bf16": "bfloat16"}[dtype])


def _layer_case(dtype, B=2, S=48, seed=0):
    jcfg = _narrow_cfg(dtype)
    rng = np.random.default_rng(seed)
    p = {}
    for k, s in JL.mla_spec(jcfg).items():
        if s.init == "ones":
            p[k] = 1.0 + 0.1 * rng.standard_normal(s.shape)
        else:
            p[k] = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
    x = rng.standard_normal((B, S, jcfg.d_model))
    r = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jnp.float32).astype(jd) for k, v in p.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32).to(td)
          for k, v in p.items()}
    jx = jnp.asarray(x, jnp.float32).astype(jd)
    tx = torch.tensor(x, dtype=torch.float32).to(td)
    return jcfg, _tcfg(jcfg), (jp, jx), (tp, tx), r


def _packed_ids(B, S):
    """Three documents a row, pad id 0 at the end of row 0."""
    ids = np.ones((B, S), np.int32)
    ids[:, S // 3:] = 2
    ids[:, 2 * S // 3:] = 3
    ids[0, -5:] = 0
    return ids


@pytest.mark.parametrize("packed", [False, True], ids=["causal", "packed"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_attention_train_matches_jax(dtype, packed):
    """Train mode at hd 192 / hdv 128: the output and the gradients of x
    and every leaf of sum(y * r), against JAX's."""
    jcfg, tcfg, (jp, jx), (tp, tx), r = _layer_case(dtype)
    B, S = tx.shape[:2]
    seg = _packed_ids(B, S) if packed else None
    pos = np.arange(S, dtype=np.int32)

    def jloss(p, x):
        y, _ = JL.apply_mla_attention(
            p, jcfg, x, jnp.asarray(pos), JRules(), mode="train",
            segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(y.astype(jnp.float32) * r), y

    (_, jy), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jx)

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, cache = TL.apply_mla_attention(
        leaves, tcfg, x, torch.from_numpy(pos), mode="train",
        segment_ids=None if seg is None else torch.from_numpy(seg))
    assert cache is None and y.dtype == tx.dtype
    total = (y.float() * torch.from_numpy(r)).sum()
    grads = torch.autograd.grad(total, [x, *leaves.values()])
    tol = TOL[dtype]
    _close(y, jy, tol, "y")
    want = {"x": jgx, **jgp}
    for name, g in zip(["x", *leaves], grads):
        assert g.dtype == tx.dtype
        _close(g, want[name], tol, name)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_mla_attention_prefill_and_absorbed_decode_match_jax(dtype):
    """prefill's S-length latents, then decode steps of the absorbed form
    against a max_seq cache: the output and the cache, written in place,
    against JAX's, step by step."""
    jcfg, tcfg, (jp, jx), (tp, tx), _ = _layer_case(dtype, S=24)
    B, P, T = tx.shape[0], 16, 24
    _, jpre = JL.apply_mla_attention(jp, jcfg, jx[:, :P], jnp.arange(P),
                                     JRules(), mode="prefill")
    y, pre = TL.apply_mla_attention(tp, tcfg, tx[:, :P], torch.arange(P),
                                    mode="prefill")
    assert set(pre) == {"ckv", "krope"}
    assert pre["ckv"].shape == (B, P, tcfg.kv_lora_rank)
    assert pre["krope"].shape == (B, P, 1, tcfg.qk_rope_dim)
    tol = TOL[dtype]
    for k in pre:
        _close(pre[k], jpre[k], tol, f"prefill {k}")
    # the max_seq caches, each side's prefill latents at the front
    jc = {k: jnp.zeros((B, T) + v.shape[2:], v.dtype).at[:, :P].set(v)
          for k, v in jpre.items()}
    tc = {k: torch.zeros((B, T) + v.shape[2:], dtype=v.dtype)
          for k, v in pre.items()}
    for k in tc:
        tc[k][:, :P] = pre[k]
    held = {k: v for k, v in tc.items()}
    jdec = jax.jit(lambda p, x, c, i: JL.apply_mla_attention(
        p, jcfg, x, i + jnp.arange(1), JRules(), mode="decode", cache=c,
        cache_index=i))
    for i in range(P, T):
        jy, jc = jdec(jp, jx[:, i:i + 1], jc, jnp.int32(i))
        idx = torch.tensor(i, dtype=torch.int32)
        y, tc = TL.apply_mla_attention(tp, tcfg, tx[:, i:i + 1],
                                       idx + torch.arange(1), mode="decode",
                                       cache=tc, cache_index=idx)
        assert all(tc[k] is held[k] for k in tc)  # written in place
        _close(y, jy, tol, f"decode step {i}")
        for k in tc:
            _close(tc[k], jc[k], tol, f"decode step {i} {k}")


def test_decode_scores_are_f32_after_the_model_dtype_sum():
    """The absorbed decode keeps JAX's dtypes step by step: in bf16 every
    einsum runs in bf16 and the scores turn f32 only after s_lat +
    s_rope (the softmax, in f32, is the one f32 step)."""
    _, tcfg, _, (tp, tx), _ = _layer_case("bf16", S=4)
    B = tx.shape[0]
    cache = {"ckv": torch.zeros(B, 8, tcfg.kv_lora_rank, dtype=torch.bfloat16),
             "krope": torch.zeros(B, 8, 1, tcfg.qk_rope_dim,
                                  dtype=torch.bfloat16)}
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        seen.append((eq, tuple(o.dtype for o in ops)))
        return real(eq, *ops)

    idx = torch.tensor(2, dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "einsum", spy)
        y, _ = TL.apply_mla_attention(tp, tcfg, tx[:, :1], idx[None],
                                      mode="decode", cache=cache,
                                      cache_index=idx)
    assert [e for e, _ in seen] == ["bqhn,khn->bqhk", "bqhk,btk->bhqt",
                                    "bqhr,btr->bhqt", "bhqt,btk->bqhk",
                                    "bqhk,khv->bqhv"]
    assert all(d == (torch.bfloat16,) * 2 for _, d in seen)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y).all()


# ------------------------------------------------------ the models

MODEL_CFGS = {
    "mla_tiny": _mla_tiny,
    "v3_smoke": lambda: jreg.get_arch("deepseek-v3-671b", smoke=True),
}  # the second's model tests: tests/test_torch_deepseek_v3.py


@functools.lru_cache(maxsize=None)
def _jax_model(name, cf=None):
    jcfg = MODEL_CFGS[name]()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model(name, cf=None):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model(name, cf)
    tcfg = _tcfg(jcfg)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


# ------------------------------------------------- attention_kind (repair)

def test_mla_config_computes_mla_not_gqa():
    """``ModelConfig(attention_kind="mla", ...)`` builds and runs MLA:
    JAX's tiny MLA config's forward equals JAX's on the same weights (the
    port used to build GQA leaves for it and compute GQA)."""
    jcfg, tcfg, jp, tp = _model("mla_tiny")
    assert "wkv_b" in TM.model_spec(tcfg)["segments"]["seg0_dense"]["attn"]
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32),
                                             dtype=np.int32)
    jh, _, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    th, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4, rtol=0)


def test_unknown_attention_kind_raises_before_any_work():
    cfg = tconfig.ModelConfig(attention_kind="mha")
    for call in (lambda: TM.param_shapes(cfg),
                 lambda: TM.init_params(cfg, torch.Generator(), device="cpu"),
                 lambda: TM.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="attention_kind"):
            call()


def test_mla_steps_build_on_a_mesh():
    """MLA runs on a mesh in modes train and prefill: the train and eval
    steps of a dense MLA model and of deepseek-v3's SMOKE twin build on a
    (duck-typed) (1, 1) mesh (``tests/test_torch_sharded_moe.py`` runs
    them on a gloo mesh)."""
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    tx = t_make("scale_fused", 1e-2)
    for tcfg in (_tcfg(_mla_tiny()),
                 treg.get_arch("deepseek-v3-671b", smoke=True)):
        assert callable(make_train_step(tcfg, tx, mesh=mesh))
        assert callable(make_eval_step(tcfg, mesh=mesh))


def test_mla_decode_on_a_mesh_raises_naming_sharded_serving():
    """The absorbed decode over a sequence-sharded latent cache is sharded
    serving, not ported: forward in mode decode on a mesh raises before
    any work, and so does the layer itself."""
    tcfg = _tcfg(_mla_tiny())
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    with pytest.raises(NotImplementedError, match="sharded serving"):
        TM.forward(None, tcfg, None, mode="decode", mesh=mesh)
    with pytest.raises(NotImplementedError, match="sharded serving"):
        TL.apply_mla_attention(None, tcfg, None, None, mode="decode",
                               mesh=mesh)


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_init_cache_matches_jax(name):
    """Every cache leaf's path, shape and dtype: MLA's latent ckv and
    shared rope key krope per segment."""
    jcfg = MODEL_CFGS[name]()
    leaves, _ = jax.tree_util.tree_flatten_with_path(JM.init_cache(jcfg, 2,
                                                                   24))
    want = {path_str(p).lstrip("."): (tuple(x.shape), str(x.dtype))
            for p, x in leaves}
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in flatten(TM.init_cache(_tcfg(jcfg), 2, 24,
                                             device="cpu")).items()}
    assert got == want
    n = jcfg.segments[0][1]
    assert got["seg0_dense/attn/krope"] == ((n, 2, 24, 1, jcfg.qk_rope_dim),
                                            "float32")


def test_mla_prefill_decode_matches_full_forward():
    """JAX ``tests/test_serving.py``'s mla case in the port: prefill 24
    tokens, decode 8 through the absorbed form, and the last logits equal
    the full forward's."""
    _, tcfg, _, tp = _model("mla_tiny")
    B, S, P = 2, 32, 24
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, (B, S), dtype=np.int32))
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, toks)
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, -1]
    state, logits = TS.make_prefill_step(tcfg, max_seq=S)(tp, toks[:, :P])
    assert int(state.index) == P
    decode = TS.make_decode_step(tcfg)
    for i in range(P, S):
        state, logits = decode(tp, state, toks[:, i:i + 1])
    torch.testing.assert_close(logits[:, -1], ref, atol=2e-4, rtol=0)
