"""The audio musicgen-medium in the port against the JAX package: the
(C, V, D) codebook embedding and the (C, D, V) heads (tied: the
embedding read transposed per codebook), the forward's sum over the
codebooks' embeddings, the C-head loss (one ``xent_loss`` a codebook)
and every gradient, tied and untied, the serving logits (B, C, S, V),
prefill and decode with (B, C, 1) tokens, ``greedy_generate`` (JAX takes
the last codebook's logits and feeds (B, 1, 1) tokens back, whose
codebook index it clamps: ROADMAP.md reference caveat 15), one
``scale_fused`` step (the 3-D head in SCALE's momentum group), the
codebook batches of the data pipeline and what raises.

Params come from JAX's ``init_params`` through ``load_flat``, batches from
JAX's data pipeline; the JAX side runs its kernels as on the CPU in its
own tests (interpret mode). The ``SMOKE`` twin is f32. Torch runs on one
intra-op thread.

Tolerances (f32, ``tests/test_torch_trainer.py``'s and
``tests/test_torch_serving.py``'s reasons): hidden states, logits and
caches 1e-4 absolute (observed 9.5e-7), the loss 1e-5 relative,
gradients 1e-5 of each leaf's largest |gradient|, the step's params 8 ulps of their peak plus 1e-5 of the leaf's step
and the Adam leaves (the norms) 1e-2 of their step
(``tests/test_torch_jamba_smoke.py``'s ``VECTOR_REL``, for its reason),
the head's momentum 2e-5 of its largest |value| (it is 1 - beta times
the clipped gradient, which carries the gradients' 1e-5).
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
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.core.labels import LabelRules  # noqa: E402
from repro_torch.data import make_dataset as t_dataset  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import (load_flat,  # noqa: E402
                                        opt_state_to_flat, to_flat)
from repro_torch.training import (init_state, make_eval_step,  # noqa: E402
                                  make_train_step)
from repro_torch.training import serving as TS  # noqa: E402

ARCH = "musicgen-medium"
VECTOR_REL = 1e-2  # the Adam leaves' share of their step (docstring)


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


def _ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 23)


def _cfgs(tied=False):
    jcfg = dataclasses.replace(jreg.get_arch(ARCH, smoke=True),
                               tie_embeddings=tied)
    tcfg = treg.get_arch(ARCH, smoke=True)
    tcfg.tie_embeddings = tied
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_model(tied=False):
    jcfg, _ = _cfgs(tied)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jp, _jflat(jp)


def _model(tied=False):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, tcfg = _cfgs(tied)
    jp, flat = _jax_model(tied)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _batch(batch=4, seq=32, seed=3):
    ds = j_dataset(_cfgs()[0], seq_len=seq, global_batch=batch, seed=seed)
    return {k: np.array(v) for k, v in ds.global_batch_at(0).items()}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


# ------------------------------------------------------------------ spec

@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_model_spec_matches_jax(tied):
    """Every leaf's path, shape, logical axes and init: the (C, V, D)
    embedding, the (C, D, V) heads (none when tied)."""
    jcfg, tcfg = _cfgs(tied)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.model_spec(jcfg), is_leaf=lambda x: isinstance(x, JL.Spec))
    want = {path_str(p).lstrip("."): (tuple(s.shape), tuple(s.axes), s.init)
            for p, s in leaves}
    got = {k: (tuple(s.shape), tuple(s.axes), s.init)
           for k, s in flatten(TM.model_spec(tcfg)).items()}
    assert got == want
    assert got["tok_embed/w"][0] == (4, 128, 128)
    assert ("lm_head/w" in got) == (not tied)
    if not tied:
        assert got["lm_head/w"][:2] == ((4, 128, 128),
                                        (None, "embed", "vocab"))


# ------------------------------------------------------ forward and loss

def test_forward_sums_the_codebook_embeddings():
    """The hidden states of (B, C, S) tokens against JAX's, and the
    embedding alone: the sum of each codebook's lookup. (B, 1, S) tokens
    (fewer codebook rows than codebooks) embed that row in every codebook,
    as JAX's clamped index does (caveat 15; end to end in
    ``test_greedy_generate_matches_jax``)."""
    jcfg, tcfg, jp, tp = _model()
    toks = _batch()["tokens"]
    jh, _, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        th, _, aux = TM.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4, rtol=0)
    assert float(aux) == 0.0
    ew = tp["tok_embed"]["w"]
    t = torch.from_numpy(toks).long()
    want = sum(ew[c][t[:, c]] for c in range(4))
    torch.testing.assert_close(TM._embed(ew, tcfg, t, None, None), want,
                               atol=0, rtol=0)
    torch.testing.assert_close(
        TM._embed(ew, tcfg, t[:, :1], None, None),
        sum(ew[c][t[:, 0]] for c in range(4)), atol=0, rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_loss(tied):
    jcfg, _ = _cfgs(tied)
    jp, _ = _jax_model(tied)
    (total, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, _jb(_batch()))
    return float(total), {k: float(v) for k, v in m.items()}, _jflat(g)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_loss_and_grads_match_jax(tied):
    """``loss_fn``: the four codebook heads' losses summed over one shared
    denominator (each head's last position masked), and every gradient;
    tied, each head is ``tok_embed.w[c]`` read transposed by the
    transposed xent route, and its gradient adds to the lookup's."""
    jcfg, tcfg, jp, tp = _model(tied)
    jtotal, jm, want = _jax_loss(tied)
    leaves = {k: p.detach().requires_grad_() for k, p in flatten(tp).items()}
    total, tm = TM.loss_fn(unflatten(leaves), tcfg, _tb(_batch()))
    grads = torch.autograd.grad(total, list(leaves.values()))
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=1e-5)
    np.testing.assert_allclose(float(tm["loss"].detach()), jm["loss"],
                               rtol=1e-5)
    # 4 heads x 4 rows x 31 labelled positions
    assert float(tm["weight"]) == jm["weight"] == 4 * 4 * 31
    assert set(want) == set(leaves)
    assert ("lm_head/w" in want) == (not tied)
    for k, g in zip(leaves, grads):
        err = np.abs(_np(g) - want[k])
        assert np.isfinite(_np(g)).all(), k
        assert (err <= 1e-5 * np.abs(want[k]).max()).all(), (
            k, float(err.max()))


def test_audio_loss_takes_no_weights():
    """Per-token weights raise ``ValueError`` for the codebook heads, as in
    JAX (packing is a plain-text format)."""
    _, tcfg, _, tp = _model()
    b = _tb(_batch())
    h = torch.zeros(4, 32, tcfg.d_model)
    with pytest.raises(ValueError, match="audio multi-codebook"):
        TM.lm_loss(tp, tcfg, h, b["labels"],
                   weights=torch.ones(4, 32))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_logits_from_hidden_match_jax(tied):
    """Serving logits (B, C, S, V), one row per codebook head."""
    jcfg, tcfg, jp, tp = _model(tied)
    h = np.random.default_rng(2).standard_normal((2, 5, 128)).astype(
        np.float32)
    want = JM.logits_from_hidden(jp, jcfg, jnp.asarray(h))
    got = TM.logits_from_hidden(tp, tcfg, torch.from_numpy(h))
    assert tuple(got.shape) == want.shape == (2, 4, 5, 128)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=0)


# --------------------------------------------------------------- serving

def test_prefill_and_decode_match_jax():
    """Prefill a (2, 4, 24) prompt, then 4 decode steps of (2, 4, 1)
    tokens: the (B, C, 1, V) logits and the cache against JAX's step by
    step, and the last logits against a full forward's."""
    jcfg, tcfg, jp, tp = _model()
    Bs, P, n_dec = 2, 24, 4
    toks = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (Bs, 4, P + n_dec), dtype=np.int32)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[..., :P]))
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[..., :P]))
    assert tuple(log.shape) == jlog.shape == (Bs, 4, 1, 128)
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)

    def check():
        assert int(state.index) == int(jstate.index)
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
        want = _jflat(jstate.cache)
        got = flatten(state.cache)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_allclose(_np(v), want[k], atol=1e-4, rtol=0,
                                       err_msg=k)

    check()
    for i in range(P, P + n_dec):
        t = toks[..., i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        check()
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, :, -1]
    torch.testing.assert_close(log[:, :, -1], ref, atol=2e-4, rtol=0)


def test_greedy_generate_matches_jax():
    """``greedy_generate`` on a (2, 4, 8) prompt: JAX takes ``logits[:,
    -1]``, the last codebook's (B, 1, V), so each next token is (B, 1, 1)
    and every codebook of the next step embeds it (caveat 15); the tokens
    and their (B, n_steps, 1) shape equal JAX's."""
    jcfg, tcfg, jp, tp = _model()
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (2, 4, 8), dtype=np.int32)
    want = np.asarray(JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), 4,
                                         16))
    got = TS.greedy_generate(tcfg, tp, prompt, 4, 16, device="cpu")
    assert tuple(got.shape) == want.shape == (2, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------------- training

def test_smoke_train_step_matches_jax():
    """One ``scale_fused`` step (clip 1.0): metrics, every param and the
    head's momentum against JAX's trainer. The (4, 128, 128) head takes
    SCALE's momentum column norm as one 3-D leaf, the (4, 128, 128)
    embedding the first group's."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch()
    rules = LabelRules()
    assert rules.classify("lm_head/w", 3) == "last"
    assert rules.classify("tok_embed/w", 3) == "first"
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    js, jm = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))(
        JT.init_state(jp, jtx), _jb(b))
    ts, tm = make_train_step(tcfg, ttx, clip_norm=1.0)(init_state(tp, ttx),
                                                       _tb(b))
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    old, got, want = _jflat(jp), to_flat(ts.params), _jflat(js.params)
    assert set(got) == set(want)
    for k, w in want.items():
        step = np.abs(w - old[k])
        vec = rules.classify(k, w.ndim) == "vector"
        tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(
            np.abs(w), step))) + (VECTOR_REL if vec else 1e-5) * step.max()
        err = np.abs(got[k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
    jopt, topt = _jflat(js.opt_state), opt_state_to_flat(ts.opt_state)
    # the head's momentum, one (C, D, V) leaf
    assert jopt["mu/lm_head/w"].shape == (4, 128, 128)
    assert (np.abs(topt["mu/lm_head/w"] - jopt["mu/lm_head/w"])
            <= 2e-5 * np.abs(jopt["mu/lm_head/w"]).max()).all()


# ------------------------------------------------------------------ data

def test_codebook_batches_in_the_data_pipeline():
    """``make_dataset`` on the audio model: tokens and labels (B, C, S),
    the labels each codebook's next token, -1 at its last position; a
    pure function of (seed, step); packing raises, as in JAX."""
    jcfg, tcfg = _cfgs()
    jd = j_dataset(jcfg, seq_len=16, global_batch=4, seed=2)
    td = t_dataset(tcfg, 16, 4, seed=2, device="cpu")
    assert dataclasses.asdict(td.cfg) == dataclasses.asdict(jd.cfg)
    b = td.global_batch_at(1)
    assert set(b) == {"tokens", "labels"}
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == (4, 4, 16)
    assert b["tokens"].dtype == b["labels"].dtype == torch.int32
    assert torch.equal(b["labels"][..., :-1], b["tokens"][..., 1:])
    assert (b["labels"][..., -1] == -1).all()
    assert int(b["tokens"].min()) >= 0
    assert int(b["tokens"].max()) < jcfg.vocab_size
    # the codebooks are drawn apart
    assert not torch.equal(b["tokens"][:, 0], b["tokens"][:, 1])
    assert torch.equal(b["tokens"], td.global_batch_at(1)["tokens"])
    with pytest.raises(ValueError, match="plain-text"):
        t_dataset(tcfg, 16, 4, pack_documents=True,
                  device="cpu").global_batch_at(0)


def test_audio_under_a_mesh_raises_before_any_work():
    """The audio model runs on a mesh in modes train and prefill: the
    train and eval steps build on a (duck-typed) (1, 1) mesh
    (``tests/test_torch_sharded_vlm.py`` runs them on a gloo mesh).
    Decode on a mesh (sharded serving) is ported too: ``check_mesh``,
    which raises before any work where a mode has no sharded route, lets
    mode decode through (``tests/test_torch_sharded_serving.py`` serves it
    on a gloo mesh)."""
    _, tcfg = _cfgs()
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=mesh))
    assert callable(make_eval_step(tcfg, mesh=mesh))
    for mode in ("train", "prefill", "decode"):
        assert TM.check_mesh(tcfg, mesh, "forward", mode) is None
