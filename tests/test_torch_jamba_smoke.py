"""jamba-1.5-large-398b's ``SMOKE`` twin in the port against the JAX
package: two hybrid super-blocks of period 4 (attn + MLP, then Mamba2 +
MoE, Mamba2 + MLP, Mamba2 + MoE), 4 experts top-2 at cf 2.0, chunk 16,
f32. ``loss_fn`` (total, loss, aux) with every gradient, two
``scale_fused`` train steps with their optimizer state, and prefill and
decode step by step through the stacked mixed cache. The super-block
alone, the cache's layout and what raises: ``tests/test_torch_jamba.py``.

JAX's side of the loss and of the steps is computed once, in module
fixtures (its traces take most of this file's time). Params come from
JAX's ``init_params`` through ``load_flat``, batches from JAX's data
pipeline (2 chunks of 16 a row); torch runs on one intra-op thread.

Tolerances (f32, ``tests/test_torch_trainer.py``'s and
``tests/test_torch_mamba.py``'s reasons): the loss and aux 1e-5 relative,
gradients 1e-5 of each leaf's largest |gradient| (observed 4.4e-6 of it),
params 8 ulps of their peak plus 1e-5 of the leaf's step (observed
4.2e-6 of it), logits and caches 1e-4 absolute
(``tests/test_torch_serving.py``). The leaves SCALE
gives to Adam (``_adam``: the norms, the Mamba2 gate norms, conv_w,
conv_b, A_log, D, dt_bias) take lr * m_hat / (sqrt(v_hat) + eps): where
an element's gradient is within a few eps of 0 (mamba2's gate norm has
one at 2.9e-5 of the leaf's largest |gradient|), eps / |g| is no longer
small and the step carries that share of the two sides' rounding of g,
so they are held to ``VECTOR_REL`` = 1e-2 of their step (observed
4.4e-3, there; ``tests/test_torch_mamba.py`` held its own leaves to 2e-4
and ``tests/test_torch_arch_configs.py`` qwen2's biases to 2e-3 for the
same reason). The optimizer state is held to 2e-5 of each leaf's largest
|value|: Adam's mu is (1 - b1) times the clipped gradient and nu (1 - b2)
times its square, so they carry the gradients' 1e-5 and twice it
(observed 9.2e-6, nu of mamba2's D). Each step starts from JAX's state on
both sides, so no step inherits the last one's rounding.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.core.labels import LabelRules  # noqa: E402
from repro_torch.core.pipeline import HostCount  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import (load_flat,  # noqa: E402
                                        load_opt_state,
                                        opt_state_to_flat, to_flat)
from repro_torch.training import init_state, make_train_step  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402

ARCH = "jamba-1.5-large-398b"
VECTOR_REL = 1e-2  # the Adam leaves' share of their step (docstring)
SEG = "seg0_hybrid"
STEPS = 2


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


def _adam(path, w):
    """Whether SCALE's pipeline gives the leaf to Adam ("vector")."""
    return LabelRules().classify(path, w.ndim) == "vector"


def _batches(jcfg, n, batch=4, seq=32, seed=3):
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed)
    return [{k: np.array(v) for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def jax_model():
    """(jcfg, JAX params, their flat numpy copy, the batches)."""
    jcfg = jreg.get_arch(ARCH, smoke=True)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp), _batches(jcfg, STEPS)


@pytest.fixture(scope="module")
def jax_loss(jax_model):
    """JAX's (total, metrics, flat gradients) on the first batch."""
    jcfg, jp, _, batches = jax_model
    (total, m), g = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, _jb(batches[0]))
    return float(total), {k: float(v) for k, v in m.items()}, _jflat(g)


@pytest.fixture(scope="module")
def jax_steps(jax_model):
    """Each of JAX's ``scale_fused`` steps (clip 1.0): (metrics, flat
    params, flat optimizer state)."""
    jcfg, jp, _, batches = jax_model
    tx = j_make("scale_fused", 1e-2)
    step = jax.jit(JT.make_train_step(jcfg, tx, clip_norm=1.0))
    state, out = JT.init_state(jp, tx), []
    for b in batches:
        state, m = step(state, _jb(b))
        out.append(({k: float(v) for k, v in m.items()},
                    _jflat(state.params), _jflat(state.opt_state)))
    return out


def _port(jax_model):
    jcfg, _, flat, batches = jax_model
    tcfg = treg.get_arch(ARCH, smoke=True)
    assert tcfg.segments == jcfg.segments == (("hybrid", 2),)
    return tcfg, load_flat(flat, tcfg, device="cpu"), batches


def test_smoke_loss_aux_and_grads_match_jax(jax_model, jax_loss):
    """``loss_fn`` (total, loss, aux: the four MoE sub-layers' of the two
    super-blocks) and every leaf's gradient against JAX's."""
    tcfg, tp, batches = _port(jax_model)
    jtotal, jm, want = jax_loss
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(tp).items()}
    total, tm = TM.loss_fn(unflatten(leaves), tcfg, _tb(batches[0]))
    grads = torch.autograd.grad(total, list(leaves.values()))
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=1e-5)
    assert jm["aux"] > 0
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), jm[k], rtol=1e-5)
    assert set(want) == set(leaves)
    for sub in ("attn/wq", "ffn0/w_gate", "mamba1/A_log", "ffn1/router",
                "ffn2/w_up", "mamba3/in_proj", "ffn3/w_down"):
        assert f"segments/{SEG}/{sub}" in want, sub
    for k, g in zip(leaves, grads):
        w = want[k]
        err = np.abs(_np(g) - w)
        assert np.isfinite(_np(g)).all(), k
        assert (err <= 1e-5 * np.abs(w).max()).all(), (k, float(err.max()))


def test_smoke_train_steps_match_jax(jax_model, jax_steps):
    """Two ``scale_fused`` steps (clip 1.0) on JAX's batches, each from
    JAX's state before it (the port's first from the same init, its second
    from JAX's first step's params and optimizer state, crossed over by
    ``load_flat`` and ``load_opt_state``): metrics, every param and the
    optimizer state against JAX's trainer. attn, the MLPs, the routers and
    the Mamba2 projections take SCALE's column norm, the 4-D expert leaves
    the plain stage route, the norms and the Mamba2 conv, A_log, D and
    dt_bias Adam."""
    tcfg, tp, batches = _port(jax_model)
    _, _, old, _ = jax_model
    ttx = t_make("scale_fused", 1e-2)
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0)
    ts = init_state(tp, ttx)
    for i, (b, (jm, jparams, jopt)) in enumerate(zip(batches, jax_steps)):
        ts, tm = tstep(ts, _tb(b))
        for k in ("loss", "aux", "grad_norm", "update_norm"):
            np.testing.assert_allclose(float(tm[k]), jm[k], rtol=1e-5,
                                       err_msg=(i, k))
        got = to_flat(ts.params)
        assert set(got) == set(jparams)
        for k, w in jparams.items():
            step = np.abs(w - old[k])
            rel = VECTOR_REL if _adam(k, w) else 1e-5
            tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(
                np.abs(w), step))) + rel * step.max()
            err = np.abs(got[k] - w)
            assert (err <= tol).all(), (i, k, float(err.max()))
        got_s = opt_state_to_flat(ts.opt_state)
        assert set(got_s) == set(jopt) and int(got_s["count"]) == i + 1
        for k, w in jopt.items():
            if k == "count" or not w.size:
                continue
            assert (np.abs(got_s[k] - w) <= 2e-5 * np.abs(w).max()).all(), (
                i, k)
        # the next step starts from JAX's state on both sides
        params = load_flat(jparams, tcfg, device="cpu")
        ts = init_state(params, ttx)._replace(
            step=torch.tensor(i + 1, dtype=torch.int32),
            opt_state=load_opt_state(jopt, params, ttx, device="cpu"),
            host_step=HostCount(i + 1))
        old = jparams


def test_smoke_prefill_and_decode_match_jax(jax_model):
    """Prefill 24 tokens, then 4 decode steps through the two super-blocks'
    stacked cache (each step reads and writes layer l's views of it): the
    logits and every cache leaf (attention k/v, each Mamba2 sub-layer's
    conv/ssm) against JAX's, step by step; the cache tensors are those
    prefill built. At the twin's cf 2.0 = E/k nothing is dropped, so the
    last logits equal the port's full forward's."""
    tcfg, tp, _ = _port(jax_model)
    jcfg, jp, _, _ = jax_model
    Bs, P, n_dec = 2, 24, 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (Bs, P + n_dec), dtype=np.int32)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, P + n_dec))(
        jp, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(tcfg, P + n_dec)(
        tp, torch.from_numpy(toks[:, :P]))
    held = flatten(state.cache)
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
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        check()
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, torch.from_numpy(toks))
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, -1]
    torch.testing.assert_close(log[:, -1], ref, atol=2e-4, rtol=0)
