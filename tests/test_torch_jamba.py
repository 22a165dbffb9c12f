"""The hybrid super-block (jamba) in the port against the JAX package: the
layout, one super-block's train forward in f32 and bf16, the mixed cache
(attention k/v beside Mamba2's conv/ssm), prefill and decode, greedy
tokens, a packed batch, the remat policies, and what raises. The
``SMOKE`` twin's loss, gradients and train steps:
``tests/test_torch_jamba_smoke.py``.

The model is ``tests/test_serving.py``'s tiny hybrid config: one
super-block of period 4 (attn + MLP, then Mamba2 + MoE, Mamba2 + MLP,
Mamba2 + MoE), 4 experts top-2 at cf 4.0 (no token is dropped), chunk 8.
Params come from JAX's ``init_params`` through ``load_flat``; torch runs
on one intra-op thread (see ``tests/test_torch_optimizers.py``).

Tolerances, per element:
  * the super-block in f32: 1e-5 of the largest |ref| + 1e-5 relative, as
    ``tests/test_torch_mamba.py`` (sums of up to 64 products in other
    orders; observed 6.4e-8 of it); the aux 1e-5 relative;
  * in bf16: 2e-2 of the largest |ref| + 2e-2 relative, as
    ``tests/test_torch_mamba.py`` and ``tests/test_torch_moe.py`` (each
    side rounds every product to bf16 at its own places; observed 8.6e-4
    of the largest). A rounding apart near a tie of two router logits
    would send a token to another expert, an O(1) change no tolerance of
    rounding covers, so the bf16 case's router reads one channel alone,
    which an offset in the residual stream holds positive: every token
    goes to experts 0 and 1 on both sides. Routing itself is held in f32
    here and in ``tests/test_torch_moe.py``;
  * the model in f32: logits and caches 1e-4 absolute
    (``tests/test_torch_serving.py``), the loss 1e-5 relative.
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import make_eval_step, make_train_step  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402

DTYPES = {"f32": "float32", "bf16": "bfloat16"}
TOL = {"f32": 1e-5, "bf16": 2e-2}
SEG = "seg0_hybrid"


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


def _close(got, want, tol, what):
    """Per element within tol * max|want| + tol * |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert (err <= tol * scale + tol * np.abs(want)).all(), (
        what, float(err.max() / scale))


def _hybrid_cfg(dtype="float32", **kw):
    """``tests/test_serving.py``'s tiny hybrid config."""
    base = dict(family="hybrid", hybrid_period=4, n_layers=4, n_experts=4,
                top_k=2, ssm_state=16, ssm_headdim=16, ssm_chunk=8,
                capacity_factor=4.0, dtype=dtype)
    base.update(kw)
    return tiny_cfg("hybrid", **base)


@functools.lru_cache(maxsize=None)
def _jax_model(dtype="float32"):
    jcfg = _hybrid_cfg(dtype)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model(dtype="float32"):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model(dtype)
    tcfg = _tcfg(jcfg)
    assert tcfg.segments == jcfg.segments == (("hybrid", 1),)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


def _batch(jcfg, batch=2, seq=32, seed=3, **kw):
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed, **kw)
    return {k: np.array(v) for k, v in ds.global_batch_at(0).items()}


# ---------------------------------------------------------------- layout

@pytest.mark.parametrize("period", range(1, 9))
def test_superblock_layout_matches_jax(period):
    """Names and sub-layer kinds, in order: attn + ffn0 (MLP), then
    mamba{i} + ffn{i}, MoE at odd i; and the spec's paths and shapes."""
    jcfg = _hybrid_cfg(hybrid_period=period, n_layers=period)
    tcfg = _tcfg(jcfg)
    want = JT.superblock_layout(jcfg, "hybrid")
    assert TT.superblock_layout(tcfg, "hybrid") == want
    assert len(want) == 2 * period
    assert [s for _, s in want].count("moe") == period // 2
    assert TM.param_shapes(tcfg) == {
        path_str(p).lstrip("."): tuple(s.shape) for p, s in
        jax.tree_util.tree_flatten_with_path(
            JM.model_spec(jcfg),
            is_leaf=lambda x: hasattr(x, "init"))[0]}


# ---------------------------------------------------- one super-block

def _superblock_case(dtype):
    """(jcfg, tcfg, JAX and port layer-0 params, x (B, S, D) numpy): the
    tiny model's one super-block from JAX's init. bf16: the MoE router
    reads channel 0 alone, which x's offset holds positive (module
    docstring)."""
    jcfg, tcfg, jp, tp = _model(DTYPES[dtype])
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["segments"][SEG])
    tl = TT._layer(tp["segments"][SEG], 0)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 32, jcfg.d_model))
    if dtype == "bf16":
        router = np.zeros((jcfg.d_model, jcfg.n_experts))
        router[0] = [2.0, 1.0, 0.5, 0.25]
        for name in ("ffn1", "ffn3"):
            jl[name]["router"] = jnp.asarray(router, jnp.bfloat16)
            tl[name]["router"] = torch.tensor(router).to(torch.bfloat16)
        x[..., 0] += 16.0
    return jcfg, tcfg, jl, tl, x


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_superblock_train_forward_matches_jax(dtype):
    """One hybrid super-block in train mode: the output against JAX's, and
    the aux, which sums the two MoE sub-layers' (ffn1, ffn3)."""
    jcfg, tcfg, jl, tl, x = _superblock_case(dtype)
    jd = jcfg.jdtype
    S = x.shape[1]
    jy, jc, jaux = jax.jit(lambda p, x: JT.apply_superblock(
        "hybrid", jcfg, p, x, jnp.arange(S), JRules(), "train", None, None,
        None))(jl, jnp.asarray(x, jnp.float32).astype(jd))
    tx = torch.tensor(x, dtype=torch.float32).to(tcfg.torch_dtype)
    with torch.no_grad():
        ty, tc, taux = TT.apply_superblock("hybrid", tcfg, tl, tx,
                                           torch.arange(S), "train", None,
                                           None)
    assert jc is None and tc is None and ty.dtype == tx.dtype
    _close(ty, jy, TOL[dtype], "y")
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_apply_sub_raises_on_an_unknown_sub_layer():
    """JAX's ``_apply_sub`` raises ``ValueError(sub)`` for a kind it does
    not know; the port's did run the MLP."""
    tcfg = _tcfg(_hybrid_cfg())
    x = torch.ones(1, 4, tcfg.d_model)
    p = {"norm": torch.ones(tcfg.d_model)}
    for sub in ("crossattn", "ffn"):
        with pytest.raises(ValueError, match=sub):
            TT._apply_sub(sub, p, tcfg, x, torch.arange(4), "train", None,
                          None)


# ------------------------------------------------------------- the cache

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_is_mixed_and_matches_jax(dtype):
    """Every cache leaf's path, shape and dtype: the attention's k and v
    with a sequence axis, each Mamba2 sub-layer's conv (model dtype) and
    ssm (always f32) without one."""
    jcfg = _hybrid_cfg(dtype)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.init_cache(jcfg, 2, 24))
    want = {path_str(p).lstrip("."): (tuple(x.shape), str(x.dtype))
            for p, x in leaves}
    got = {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for k, x in flatten(TM.init_cache(_tcfg(jcfg), 2, 24,
                                             device="cpu")).items()}
    assert got == want
    assert set(TM.init_cache(_tcfg(jcfg), 2, 24, device="cpu")[SEG]) == {
        "attn", "mamba1", "mamba2", "mamba3"}
    assert got[f"{SEG}/attn/k"] == ((1, 2, 24, jcfg.n_kv_heads,
                                     jcfg.head_dim), dtype)
    assert got[f"{SEG}/mamba2/ssm"] == ((1, 2, jcfg.ssm_nheads,
                                         jcfg.ssm_state, jcfg.ssm_headdim),
                                        "float32")


# --------------------------------------------------------------- serving

def test_prefill_and_decode_match_jax_and_the_full_forward():
    """Prefill 24 tokens, then 8 decode steps: the logits, the attention's
    k/v and each Mamba2 sub-layer's conv/ssm against JAX's, step by step;
    the decode steps keep the very cache tensors prefill built (the
    attention writes its view by ``index_copy_``, Mamba2 by ``copy_``);
    the last logits equal the port's full forward's."""
    jcfg, tcfg, jp, tp = _model()
    Bs, P, n_dec = 2, 24, 8
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (Bs, P + n_dec), dtype=np.int32)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[:, :P]))
    held = flatten(state.cache)
    assert set(held) == set(_jflat(jstate.cache))
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)

    def check():
        assert int(state.index) == int(jstate.index)
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
        want = _jflat(jstate.cache)
        for k, v in flatten(state.cache).items():
            assert v is held[k], k
            np.testing.assert_allclose(_np(v), want[k], atol=1e-4, rtol=0,
                                       err_msg=k)

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
    jcfg, tcfg, jp, tp = _model()
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 20),
                                               dtype=np.int32)
    want = JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), n_steps=6,
                              max_seq=26)
    got = TS.greedy_generate(tcfg, tp, prompt, n_steps=6, max_seq=26,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- training

def test_packed_batch_loss_matches_jax():
    """A packed batch: the attention sub-layer keeps to each document, the
    Mamba2 sub-layers see the row whole (no segment mask), as JAX's; the
    loss and aux equal JAX's."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(jcfg, pack_documents=True)
    assert "segment_ids" in b and len(np.unique(b["segment_ids"])) > 2
    jtotal, jm = jax.jit(lambda p, b: JM.loss_fn(p, jcfg, b))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    total, tm = TM.loss_fn(tp, tcfg, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
    np.testing.assert_allclose(_np(total), _np(jtotal), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)


def test_remat_policies_match_none():
    """The tiny model's loss gradients under remat "full" and "dots" equal
    those without remat, bitwise: the recomputed forward routes the tokens
    and runs the SSD as the first did."""
    jcfg, tcfg, _, tp = _model()
    b = {k: torch.from_numpy(v) for k, v in _batch(jcfg).items()}
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(tcfg, remat=remat)
        leaves = {k: p.detach().requires_grad_() for k, p in
                  flatten(tp).items()}
        total, m = TM.loss_fn(unflatten(leaves), c, b)
        out[remat] = (total.detach(), m["aux"].detach(),
                      torch.autograd.grad(total, list(leaves.values())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert torch.equal(out[remat][1], out["none"][1]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][2],
                                                     out["none"][2])), remat


def test_hybrid_under_a_mesh_raises_before_any_work():
    """A hybrid segment holds attention, MoE and Mamba2, each with a
    sharded route in modes train and prefill: the train and eval steps
    build on a (duck-typed) (1, 1) mesh
    (``tests/test_torch_sharded_mamba.py`` runs them on a gloo mesh).
    Decode on a mesh is sharded serving, not ported: forward in mode
    decode raises before any work, naming it."""
    tcfg = _tcfg(_hybrid_cfg())
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=mesh))
    assert callable(make_eval_step(tcfg, mesh=mesh))
    with pytest.raises(NotImplementedError,
                       match="sharded serving.*item 12"):
        TM.forward(None, tcfg, None, mode="decode", mesh=mesh)
