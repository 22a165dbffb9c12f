"""The port's training step (``repro_torch.training.make_train_step``)
against the JAX package's, and the port's launcher.

A small dense llama (2 layers, d_model 64, 4 heads over 2 kv heads, a
vocab of 250 padded to 256) gets its params from the JAX ``init_params``
(through numpy and ``load_flat``) and its batches from the JAX
``make_dataset``; three steps of ``scale_fused`` with clip 1.0 run on both
sides. The JAX step runs without a guard, its kernels in interpret mode;
the port's kernels take their plain versions on CPU tensors.

Tolerances, with ``ulp(x)`` the spacing of the dtype at x:
  * params, per element: ``ulps * ulp(peak) + c * travel``, ``peak`` the
    largest |value| or |step change| the element took along the JAX
    trajectory and ``travel`` the largest sum of |step changes| of any
    element of the leaf. f32: 8 ulps and c = 1e-5 — the gradients agree to
    about 1e-6 of the leaf's scale (f32 sums in other orders in every
    product and reduction), which SCALE's column normalization carries into
    every element's step (observed 1.1e-6 of the travel). bf16: 3 ulps and
    c = 0.15 — the two sides round their bf16 activations and gradients at
    other places, and the attention and MLP gradients at this random init
    are sums that cancel toward zero, where a few bf16 roundings are a
    large share (reference caveat 1 of ROADMAP.md: 23% on such a sum);
    observed 4.9e-2 of the travel;
  * optimizer state (the head's f32 momentum, the vectors' Adam moments),
    per element against the leaf's largest |value|: f32 4e-6 (observed
    1e-6); bf16 1e-1 — the vectors' bf16 gradients are sums over every
    token of bf16-rounded products that XLA and PyTorch's autograd round
    at other places, off by a few bf16 ulps of the leaf's scale, and the
    second moment doubles that (observed 4.4e-2);
  * metrics, relative: f32 1e-5 for ``loss``, ``grad_norm`` and
    ``update_norm`` (observed 6e-7); bf16 1e-3 for ``loss`` (observed 4e-5),
    5e-3 for ``grad_norm`` (6e-4) and 3e-2 for ``update_norm``, which
    differences bf16 parameters whose roundings may flip (6e-3);
    ``weight`` and ``aux`` exactly.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import (load_flat, load_opt_state,  # noqa: E402
                                        opt_state_to_flat)
from repro_torch.training import (TrainState, init_state,  # noqa: E402
                                  make_train_step)

STEPS = 3
_MANT = {"float32": 23, "bfloat16": 7}


def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p).lstrip("."): np.asarray(x.astype(jnp.float32))
            if x.dtype != jnp.int32 else np.asarray(x) for p, x in leaves}


def _model(dt, **kw):
    jcfg = tiny_cfg("trainer", dtype=dt, vocab_size=250, **kw)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, load_flat(_jflat(jp), tcfg, device="cpu")


def _batches(jcfg, n, batch=4, seq=32):
    ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=3)
    return [{k: np.array(v) for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_train_steps_match_jax(dt):
    jcfg, tcfg, jp, tp = _model(dt)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0)
    js, ts = JT.init_state(jp, jtx), init_state(tp, ttx)
    f32 = dt == "float32"
    rtol = ({"loss": 1e-5, "grad_norm": 1e-5, "update_norm": 1e-5} if f32
            else {"loss": 1e-3, "grad_norm": 5e-3, "update_norm": 3e-2})
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    ptrs = {k: p.data_ptr() for k, p in flatten(tp).items()}
    for step, b in enumerate(_batches(jcfg, STEPS)):
        old = _jflat(js.params)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, _t(b))
        assert isinstance(ts, TrainState) and int(ts.step) == step + 1
        assert set(tm) == {"loss", "grad_norm", "update_norm", "aux",
                           "weight"}
        for k, tol in rtol.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=k)
        assert float(tm["weight"]) == float(jm["weight"])
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
        want = _jflat(js.params)
        for k, w in want.items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
            got = flatten(ts.params)[k].detach().float().numpy()
            tol = ((8 * _ulp(peak[k], dt) + 1e-5 * travel[k].max()) if f32
                   else 3 * _ulp(peak[k], dt) + 0.15 * travel[k].max())
            err = np.abs(got - w)
            assert (err <= tol).all(), (step, k, float(err.max()))
        got_s, want_s = opt_state_to_flat(ts.opt_state), _jflat(js.opt_state)
        assert set(got_s) == set(want_s)
        assert int(got_s["count"]) == int(want_s["count"]) == step + 1
        for k, w in want_s.items():
            if k == "count" or not w.size:
                continue
            tol = (4e-6 if f32 else 1e-1) * np.abs(w).max()
            assert (np.abs(got_s[k] - w) <= tol).all(), (step, k)
    # the fused write updates the parameters in place; no .grad is left
    assert {k: p.data_ptr() for k, p in flatten(ts.params).items()} == ptrs
    assert all(p.grad is None and not p.requires_grad
               for p in flatten(ts.params).values())
    # JAX's TrainState crosses by load_flat and load_opt_state, and one
    # more step from it on both sides agrees as the steps above do
    params = load_flat(_jflat(js.params), tcfg, device="cpu")
    ts = TrainState(torch.tensor(STEPS, dtype=torch.int32), params,
                    load_opt_state(_jflat(js.opt_state), params, ttx,
                                   device="cpu"))
    assert opt_state_to_flat(ts.opt_state).keys() == _jflat(js.opt_state).keys()
    b = _batches(jcfg, STEPS + 1)[-1]
    old = _jflat(js.params)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = tstep(ts, _t(b))
    for k, tol in rtol.items():
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                   err_msg=k)
    for k, w in _jflat(js.params).items():
        step_k = np.abs(w - old[k])
        tol = ((8 * _ulp(np.maximum(np.abs(w), step_k), dt)
                + 1e-5 * step_k.max()) if f32
               else 3 * _ulp(np.maximum(np.abs(w), step_k), dt)
               + 0.15 * step_k.max())
        err = np.abs(flatten(ts.params)[k].float().numpy() - w)
        assert (err <= tol).all(), ("crossed", k, float(err.max()))


def _one_step(tcfg, tp, batch, **kw):
    tx = t_make("scale_fused", 1e-2)
    params = load_flat({k: v.detach().float().numpy()
                        for k, v in flatten(tp).items()}, tcfg, device="cpu")
    return make_train_step(tcfg, tx, clip_norm=1.0, **kw)(
        init_state(params, tx), batch)


def test_grad_accum_matches_one_batch():
    """Two microbatches of 2 rows against the batch of 4 (every row has the
    same number of labelled tokens, so the mean of the microbatch means is
    the batch mean): f32 sums in other orders, as for JAX."""
    jcfg, tcfg, _, tp = _model("float32")
    batch = _t(_batches(jcfg, 1)[0])
    s1, m1 = _one_step(tcfg, tp, batch)
    s2, m2 = _one_step(tcfg, tp, batch, grad_accum=2)
    for k in ("loss", "grad_norm", "update_norm"):
        torch.testing.assert_close(m2[k], m1[k], rtol=1e-5, atol=0)
    # the token weight is averaged over the microbatches, as in JAX
    assert float(m2["weight"]) == float(m1["weight"]) / 2
    for k, p in flatten(s1.params).items():
        old = flatten(tp)[k]
        err = (flatten(s2.params)[k] - p).abs().numpy()
        tol = (8 * _ulp(torch.maximum(old.abs(), p.abs()).numpy(), "float32")
               + 1e-5 * (p - old).abs().max().item())
        assert (err <= tol).all(), k


def test_grad_accum_must_divide_the_batch():
    jcfg, tcfg, _, tp = _model("float32")
    batch = _t(_batches(jcfg, 1)[0])
    with pytest.raises(ValueError, match="must divide the batch axis"):
        _one_step(tcfg, tp, batch, grad_accum=3)


def test_update_entry_point_matches_fused_write():
    """fused_apply=False (update + apply_updates) against the in-place
    write, in f32: the same maths, the write rounding theta once and the
    update entry point the update first (8 ulps of the element's peak)."""
    jcfg, tcfg, _, tp = _model("float32")
    batch = _t(_batches(jcfg, 1)[0])
    s1, m1 = _one_step(tcfg, tp, batch)
    s2, m2 = _one_step(tcfg, tp, batch, fused_apply=False)
    for k in ("loss", "grad_norm", "update_norm"):
        torch.testing.assert_close(m2[k], m1[k], rtol=1e-5, atol=0)
    for k, p in flatten(s1.params).items():
        old = flatten(tp)[k]
        peak = torch.maximum(old.abs(), (p - old).abs()).numpy()
        err = (flatten(s2.params)[k] - p).abs().numpy()
        assert (err <= 8 * _ulp(peak, "float32")).all(), k


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_no_remat_and_recomputes_attention(remat, monkeypatch):
    """The same step under remat and without it: on the CPU the recompute
    repeats the forward's arithmetic, so the results are bitwise equal;
    every super-block's forward runs twice, so attention's does too."""
    jcfg, _, _, _ = _model("float32")
    batch = _t(_batches(jcfg, 1)[0])
    calls = []
    fwd = dispatch.FlashAttention.forward

    def counted(ctx, *args):
        calls.append(1)
        return fwd(ctx, *args)

    monkeypatch.setattr(dispatch.FlashAttention, "forward",
                        staticmethod(counted))
    out = {}
    for mode in ("none", remat):
        _, tcfg, _, tp = _model("float32", remat=mode)
        calls.clear()
        out[mode] = _one_step(tcfg, tp, batch)
        out[mode] += (len(calls),)
    (s0, m0, n0), (s1, m1, n1) = out["none"], out[remat]
    assert (n0, n1) == (tcfg.n_layers, 2 * tcfg.n_layers)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k, p in flatten(s0.params).items():
        assert torch.equal(p, flatten(s1.params)[k]), k


def test_unknown_remat_raises():
    jcfg, tcfg, _, tp = _model("float32", remat="some")
    with pytest.raises(ValueError, match="remat must be"):
        _one_step(tcfg, tp, _t(_batches(jcfg, 1)[0]))


def test_launcher_trains_on_cpu():
    """python -m repro_torch.launch.train --device cpu, through main(argv):
    two steps of llama-60m (f32, batch 2 of 16 tokens)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = launch_train.main([
            "--device", "cpu", "--arch", "llama-60m", "--dtype", "float32",
            "--optimizer", "scale_fused", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1"])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("arch=llama-60m optimizer=scale_fused device=cpu "
                        "guard=on")
    assert lines[1].endswith(" skipped 0 rollbacks 0")
    assert [ln.split()[:2] for ln in lines[1:3]] == [["step", "1"],
                                                     ["step", "2"]]
    assert lines[-1] == f"done: final loss {loss:.4f}"
    assert np.isfinite(loss) and 9.0 < loss < 11.5  # about ln(32000)


def test_launcher_defaults_to_the_card():
    """Without --device the launcher runs on cuda, and without a card it
    raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "llama-60m", "--steps", "1"])
