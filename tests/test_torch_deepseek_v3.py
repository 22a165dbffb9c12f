"""deepseek-v3-671b's ``SMOKE`` twin in the port against the JAX package:
a dense MLA layer, then two MLA + MoE layers with a shared expert (the
``dense``-then-``moe`` segments), f32. ``loss_fn`` with every gradient,
one ``scale_fused`` step, prefill and the absorbed decode step by step,
and the launcher's ``--smoke``. The MLA layer alone, the config and the
cache: ``tests/test_torch_mla.py``.

Params come from JAX's ``init_params`` through ``load_flat``, batches from
JAX's data pipeline; torch runs on one intra-op thread. Tolerances (f32,
``tests/test_torch_trainer.py``'s reasons): loss and aux 1e-5 relative,
gradients 1e-5 of each leaf's largest |gradient| (observed 1.2e-6 of
it), the step's params 8 ulps of their peak plus 1e-5 of the leaf's
step, logits and latent caches 1e-4 absolute
(``tests/test_torch_serving.py``). The decode steps see B = 2 tokens, so
the MoE drops at the twin's cf 2.0 (C = 1) on both sides alike.
"""
import contextlib
import functools
import io

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
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import init_state, make_train_step  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402

ARCH = "deepseek-v3-671b"


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


@functools.lru_cache(maxsize=None)
def _jax_model():
    jcfg = jreg.get_arch(ARCH, smoke=True)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model():
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model()
    tcfg = treg.get_arch(ARCH, smoke=True)
    assert tcfg.segments == (("dense", 1), ("moe", 2))
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


def _batch(jcfg, batch=4, seq=32, seed=3):
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed)
    return {k: np.array(v) for k, v in ds.global_batch_at(0).items()}


def test_v3_smoke_loss_and_grads_match_jax():
    """``loss_fn`` (total, loss, aux) and every leaf's gradient against
    JAX's."""
    jcfg, tcfg, jp, tp = _model()
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
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   rtol=1e-5)
    want = _jflat(jg)
    assert set(want) == set(leaves)
    assert any("wkv_b" in k for k in want)
    for k, g in zip(leaves, grads):
        w = want[k]
        err = np.abs(_np(g) - w)
        assert (err <= 1e-5 * np.abs(w).max()).all(), (k, float(err.max()))


def test_v3_smoke_train_step_matches_jax():
    """One ``scale_fused`` step (clip 1.0) of the SMOKE twin: metrics and
    every updated param against JAX's trainer."""
    jcfg, tcfg, jp, tp = _model()
    b = _batch(jcfg)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    js, jm = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))(
        JT.init_state(jp, jtx), {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = make_train_step(tcfg, ttx, clip_norm=1.0)(
        init_state(tp, ttx), {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "aux", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    old = _jflat(jp)
    for k, w in _jflat(js.params).items():
        step = np.abs(w - old[k])
        tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(np.abs(w), step))
                       ) + 1e-5 * step.max()
        err = np.abs(flatten(ts.params)[k].float().numpy() - w)
        assert (err <= tol).all(), (k, float(err.max()))


def test_v3_smoke_prefill_and_decode_match_jax():
    """deepseek-v3's SMOKE twin (the MoE decode drops at its cf 2.0 with
    B = 2 tokens: C = 1): the logits and the latent caches of prefill and
    of each absorbed decode step against JAX's, step by step."""
    jcfg, tcfg, jp, tp = _model()
    Bs, P, max_seq, n_dec = 2, 8, 16, 4
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (Bs, P + n_dec), dtype=np.int32)
    jstate, jlog = jax.jit(JS.make_prefill_step(jcfg, max_seq))(
        jp, jnp.asarray(toks[:, :P]))
    state, log = TS.make_prefill_step(tcfg, max_seq)(
        tp, torch.from_numpy(toks[:, :P]))
    jdec, dec = jax.jit(JS.make_decode_step(jcfg)), TS.make_decode_step(tcfg)

    def check():
        assert int(state.index) == int(jstate.index)
        np.testing.assert_allclose(_np(log), _np(jlog), atol=1e-4, rtol=0)
        for seg in ("seg0_dense", "seg1_moe"):
            for k in ("ckv", "krope"):
                np.testing.assert_allclose(
                    _np(state.cache[seg]["attn"][k]),
                    _np(jstate.cache[seg]["attn"][k]), atol=1e-4, rtol=0)

    check()
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        check()


def test_launcher_smoke_v3_loss_falls():
    """``python -m repro_torch.launch.train --arch deepseek-v3-671b --smoke
    --device cpu``: 8 steps of the MLA + MoE twin whose loss falls."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = launch_train.main(
            ["--arch", "deepseek-v3-671b", "--smoke", "--device", "cpu",
             "--steps", "8", "--batch", "4", "--seq", "32", "--log-every",
             "1", "--optimizer", "scale_fused", "--lr", "1e-2"])
    out = buf.getvalue()
    assert "arch=deepseek-v3-671b-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and abs(losses[-1] - final) <= 5e-5
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.2, losses
