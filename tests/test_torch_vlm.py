"""The VLM llama-3.2-vision-11b in the port against the JAX package: the
``vlm`` super-block (cross-attention + MLP, then self-attention + MLP),
the cross sub-layer's spec (no q/k/v bias even under ``qkv_bias``), the
cross-attention layer alone in f32 and in bf16 with f32 image embeddings
(JAX promotes k and v to f32 there: ROADMAP.md reference caveat 13),
remat, prefill and decode with images, the image stubs of the data
pipeline, and what raises on a mesh (decode). The ``SMOKE`` twin's loss and
gradients, the no-image route (caveat 14) and a train step:
``tests/test_torch_vlm_smoke.py``, which takes this file's helpers.

Params come from JAX's ``init_params`` through ``load_flat``, batches from
JAX's data pipeline (f32 image embeddings, as it gives them whatever the
model's dtype); the JAX side runs its attention kernels as on the CPU in
its own tests (interpret mode). Torch runs on one intra-op thread.

Tolerances, per element, against the largest |ref| of the tensor
(``_close``: tol * max|ref| + tol * |ref|, never a bare rtol):
  * f32 outputs and gradients of the layer: 1e-5 (sums of up to 128
    products in other orders; observed 4.5e-7 of the largest |ref|);
  * bf16 (``tests/test_torch_mamba.py``'s): 2e-2, each side rounding
    every product and sum to bf16 at its own places. Observed, of the
    largest |ref|: 5.1e-3 for the layer with f32 images, 7.1e-3 with
    bf16 images;
  * f32 models: logits and caches 1e-4 absolute
    (``tests/test_torch_serving.py``; observed 4.2e-7).
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT_  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.data import make_dataset as t_dataset  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import make_eval_step, make_train_step  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402

ARCH = "llama-3.2-vision-11b"
SEG = "seg0_vlm"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = {"f32": "float32", "bf16": "bfloat16"}
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


def _close(got, want, tol, what):
    """Per element within tol * max|want| + tol * |want|."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert np.isfinite(got).all(), what
    assert (err <= tol * scale + tol * np.abs(want)).all(), (
        what, float(err.max() / scale))


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


@functools.lru_cache(maxsize=None)
def _jax_model(dtype="f32"):
    jcfg = dataclasses.replace(jreg.get_arch(ARCH, smoke=True),
                               dtype=NAMES[dtype])
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model(dtype="f32"):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model(dtype)
    tcfg = treg.get_arch(ARCH, smoke=True)
    tcfg.dtype = NAMES[dtype]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.segments == jcfg.segments == (("vlm", 2),)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _batch(batch=4, seq=32, seed=3):
    jcfg = jreg.get_arch(ARCH, smoke=True)
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed)
    return {k: np.array(v) for k, v in ds.global_batch_at(0).items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("every", [1, 2, 3, 5])
def test_superblock_layout_matches_jax(every):
    jcfg = dataclasses.replace(jreg.get_arch(ARCH, smoke=True),
                               cross_attn_every=every, n_layers=2 * every)
    assert TT.superblock_layout(_tcfg(jcfg), "vlm") == \
        JT_.superblock_layout(jcfg, "vlm")
    assert TT.superblock_layout(_tcfg(jcfg), "vlm")[:2] == (
        ("cross", "cross"), ("cross_ffn", "mlp"))


@pytest.mark.parametrize("qkv_bias", [False, True], ids=["nobias", "bias"])
def test_model_spec_matches_jax(qkv_bias):
    """Every leaf's path, shape, logical axes and init; under ``qkv_bias``
    the self-attention sub-layers have biases and the cross sub-layer
    none, as in JAX."""
    jcfg = dataclasses.replace(jreg.get_arch(ARCH, smoke=True),
                               qkv_bias=qkv_bias)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.model_spec(jcfg), is_leaf=lambda x: isinstance(x, JL.Spec))
    want = {path_str(p).lstrip("."): (tuple(s.shape), tuple(s.axes), s.init)
            for p, s in leaves}
    got = {k: (tuple(s.shape), tuple(s.axes), s.init)
           for k, s in flatten(TM.model_spec(_tcfg(jcfg))).items()}
    assert got == want
    assert f"segments/{SEG}/cross/bq" not in got
    assert (f"segments/{SEG}/attn1/bq" in got) == qkv_bias
    assert got[f"segments/{SEG}/cross/wk"][0] == (2, 128, 2 * 16)


# ------------------------------------------------- the cross-attention layer

def _cross_inputs(dtype, S, T=16, img_dtype=np.float32, seed=0):
    jcfg, tcfg, jp, tp = _model(dtype)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    img = (0.5 * rng.standard_normal((2, T, jcfg.d_model))).astype(img_dtype)
    jd, td = DTYPES[dtype]
    # the sub-layer's weights less its pre-norm scale (``_apply_sub``'s)
    jl = {k: v[0] for k, v in jp["segments"][SEG]["cross"].items()
          if k != "norm"}
    tl = {k: v[0].detach() for k, v in
          tp["segments"][SEG]["cross"].items() if k != "norm"}
    return jcfg, tcfg, jl, tl, x, img, jd, td


@pytest.mark.parametrize("S", [24, 1], ids=["flash", "single_query"])
@pytest.mark.parametrize("dtype,img", [("f32", "f32"), ("bf16", "f32"),
                                       ("bf16", "model")],
                         ids=["f32", "bf16-f32_images", "bf16-bf16_images"])
def test_cross_attention_layer_matches_jax(dtype, img, S):
    """``apply_attention`` with ``kv_source``: 24 queries (flash attention,
    non-causal over the 16 image keys) or one (the decode route, no
    ``kv_len``), output and the gradients of x and of every weight. In a
    bf16 model with f32 images JAX forms k, v in f32 and attends in f32
    with q promoted, its output in q's dtype (caveat 13); the port spells
    that promotion out and lands on the same values."""
    jcfg, tcfg, jl, tl, x, im, jd, td = _cross_inputs(dtype, S)
    if img == "model":
        im = _np(jnp.asarray(im).astype(jd))
    jim = jnp.asarray(im) if img == "f32" else jnp.asarray(im).astype(jd)
    tim = torch.from_numpy(im) if img == "f32" else \
        torch.from_numpy(im).to(td)
    pos = np.arange(S)

    def jf(p, xx):
        return JL.apply_attention(p, jcfg, xx, jnp.asarray(pos), JRules(),
                                  mode="train", kv_source=jim,
                                  causal=False)[0]

    jx = jnp.asarray(x).astype(jd)
    jy, vjp = jax.vjp(jf, jl, jx)
    g = np.random.default_rng(1).standard_normal(jy.shape).astype(np.float32)
    jgp, jgx = vjp(jnp.asarray(g).astype(jd))

    leaves = {k: v.clone().requires_grad_() for k, v in tl.items()}
    tx = torch.from_numpy(x).to(td).requires_grad_()
    ty, cache = TL.apply_attention(leaves, tcfg, tx, torch.arange(S),
                                   "train", kv_source=tim)
    assert cache is None and ty.dtype == td and jy.dtype == jd
    grads = torch.autograd.grad(ty, [tx, *leaves.values()],
                                torch.from_numpy(g).to(td))
    _close(ty, jy, TOL[dtype], "y")
    _close(grads[0], jgx, TOL[dtype], "dx")
    for (k, w), gw in zip(leaves.items(), grads[1:]):
        assert gw.dtype == w.dtype, k
        _close(gw, jgp[k], TOL[dtype], k)


def test_bf16_cross_attention_with_f32_images_runs_f32_attention():
    """The attention of the bf16 cross sub-layer with f32 images takes f32
    q, k and v (the port's kernels then take their f32 route), and returns
    bf16; with bf16 images everything stays bf16."""
    from unittest import mock
    from repro_torch.kernels import dispatch
    _, tcfg, _, tl, x, im, _, td = _cross_inputs("bf16", 24)
    seen = []
    real = dispatch.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return real(q, k, v, **kw)

    with mock.patch.object(dispatch, "flash_attention", spy), \
            torch.no_grad():
        for images in (torch.from_numpy(im), torch.from_numpy(im).to(td)):
            y, _ = TL.apply_attention(tl, tcfg, torch.from_numpy(x).to(td),
                                      torch.arange(24), "train",
                                      kv_source=images)
            assert y.dtype == torch.bfloat16
    assert seen == [(torch.float32,) * 3, (torch.bfloat16,) * 3]


# ------------------------------------------------------- the SMOKE twin

def test_remat_policies_match_none():
    """The image embeddings are a tensor argument of each remat block: the
    loss and every gradient under "full" and "dots" equal "none"'s
    bitwise."""
    _, tcfg, _, tp = _model("f32")
    b = _tb(_batch(batch=2, seq=16))
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(tcfg, remat=remat)
        leaves = {k: p.detach().requires_grad_()
                  for k, p in flatten(tp).items()}
        total, _ = TM.loss_fn(unflatten(leaves), c, b)
        out[remat] = (total.detach(), torch.autograd.grad(
            total, list(leaves.values())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1])), remat


def test_prefill_and_decode_with_images_match_jax():
    """Prefill 24 tokens with the images, then 4 decode steps with them
    (the cross sub-layer recomputes its keys and values from the images
    at every step, the single query on the decode route): logits and the
    cache against JAX's step by step. The cache holds the self-attention
    sub-layer's k/v only; the last logits equal a full forward's."""
    jcfg, tcfg, jp, tp = _model("f32")
    Bs, P, n_dec = 2, 24, 4
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (Bs, P + n_dec), dtype=np.int32)
    img = (0.02 * rng.standard_normal(
        (Bs, jcfg.n_image_tokens, jcfg.d_model))).astype(np.float32)
    jimg, timg = jnp.asarray(img), torch.from_numpy(img)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[:, :P]), jimg)
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[:, :P]), timg)
    held = flatten(state.cache)
    assert set(held) == {f"{SEG}/attn1/k", f"{SEG}/attn1/v"}
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)

    def check():
        assert int(state.index) == int(jstate.index)
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
        want = _jflat(jstate.cache)
        got = flatten(state.cache)
        assert set(got) == set(want) == set(held)
        for k, v in got.items():
            assert v is held[k], k
            np.testing.assert_allclose(_np(v), want[k], atol=1e-4, rtol=0,
                                       err_msg=k)

    check()
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t), jimg)
        state, log = dec(tp, state, torch.from_numpy(t), timg)
        check()
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks),
                             image_embeds=timg)
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, -1]
    torch.testing.assert_close(log[:, -1], ref, atol=2e-4, rtol=0)


# ------------------------------------------------------------------ data

def test_image_stubs_in_the_data_pipeline():
    """``make_dataset`` on the VLM: tokens and labels as text, and f32
    ``image_embeds`` (B, n_image_tokens, d_model) of JAX's distribution
    (0.02 N(0, 1)), a pure function of (seed, step) from the port's own
    generator; ``host_batch_at`` slices them; packing raises, as in
    JAX."""
    tcfg = treg.get_arch(ARCH, smoke=True)
    tcfg.dtype = "bfloat16"
    jcfg = jreg.get_arch(ARCH, smoke=True)
    jd = j_dataset(jcfg, seq_len=32, global_batch=8, seed=4)
    td = t_dataset(tcfg, 32, 8, seed=4, device="cpu")
    jdc = dataclasses.asdict(jd.cfg)
    assert dataclasses.asdict(td.cfg) == jdc
    b, again = td.global_batch_at(3), td.global_batch_at(3)
    want = jd.global_batch_at(3)
    assert set(b) == set(want) == {"tokens", "labels", "image_embeds"}
    for k in b:
        assert tuple(b[k].shape) == tuple(want[k].shape), k
        assert torch.equal(b[k], again[k]), k
    img = b["image_embeds"]
    assert img.dtype == torch.float32
    assert not torch.equal(img, td.global_batch_at(4)["image_embeds"])
    n = img.numel()  # 16384 draws: mean within 4 sigma, std within 2%
    assert abs(float(img.mean())) <= 4 * 0.02 / np.sqrt(n)
    assert abs(float(img.std()) / 0.02 - 1) <= 0.02
    shard = td.host_batch_at(3, host_id=1, n_hosts=2)
    assert torch.equal(shard["image_embeds"], img[4:])
    packed = t_dataset(tcfg, 32, 8, pack_documents=True, device="cpu")
    with pytest.raises(ValueError, match="plain-text"):
        packed.global_batch_at(0)
    with pytest.raises(ValueError, match="plain-text"):
        j_dataset(jcfg, seq_len=32, global_batch=8,
                  pack_documents=True).global_batch_at(0)


def test_vlm_under_a_mesh_raises_before_any_work():
    """The VLM runs on a mesh in modes train and prefill: the train and
    eval steps build on a (duck-typed) (1, 1) mesh
    (``tests/test_torch_sharded_vlm.py`` runs them on a gloo mesh).
    Decode on a mesh (sharded serving) is ported too: ``check_mesh``,
    which raises before any work where a mode has no sharded route, lets
    mode decode through (``tests/test_torch_sharded_serving.py`` serves it
    on a gloo mesh)."""
    tcfg = treg.get_arch(ARCH, smoke=True)
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=mesh))
    assert callable(make_eval_step(tcfg, mesh=mesh))
    for mode in ("train", "prefill", "decode"):
        assert TM.check_mesh(tcfg, mesh, "forward", mode) is None
