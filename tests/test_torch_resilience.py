"""The port's resilience subsystem against the JAX package's: the
``REPRO_FAULTS`` grammar, the anomaly guard, the guarded train step with
injected gradient faults, ``dispatch_fail``, and the launcher's resume,
rollback and SIGTERM on ``--device cpu``.

The model is the small dense llama of ``test_torch_trainer.py`` (2
layers, d_model 64, vocab 250 padded to 256, f32), its params from the
JAX ``init_params`` and its batches from the JAX ``make_dataset``;
``scale_fused`` with clip 1.0, the JAX kernels in interpret mode and the
port's on their plain versions. Tolerances:

  * the guard on the same scalars: the verdicts, counters and rollback
    flags exactly; the f32 loss EMA to 1 ulp (the same f32 operations,
    one rounding each);
  * a skipped step (``nan_grad``/``inf_grad`` at step k): params and
    optimizer state bitwise equal to a clean run that never saw step k's
    batch, on the port; against the JAX guarded trainer, per element,
    ``8 ulps of peak + 1e-5 * travel`` for params and ``4e-6`` of the
    leaf's largest |value| for the state (``test_torch_trainer.py``'s f32
    bounds and reasons);
  * GaLore (rank 8, refresh every 3 steps) from a carried JAX state, a
    skip just before a refresh: through the step the refresh must not
    move, params to ``test_torch_galore.py``'s bound (8 ulps of the peak
    plus 5e-4 of the leaf's largest step change, summed over the steps);
    the refresh step's
    projector up to column signs to 1e-3 of its largest |value| (that
    file's LAPACK bound);
  * the 20-step run from one JAX checkpoint: per-step loss relative
    ``1e-5``, the trainer's bound for three steps (f32 sums in other
    orders); over 20 steps the two trajectories stayed within 1.2e-7.
"""
import contextlib
import dataclasses
import io
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import faults as j_faults  # noqa: E402
from repro.training import resilience as JR  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
import repro_torch.checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint.checkpointer import named_leaves  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import ModelConfig  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.training import (GuardPolicy, faults,  # noqa: E402
                                  guard_step, guard_verdict,
                                  init_guard_state, init_state,
                                  make_train_step, parse_faults, resolve_plan)
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import _jflat, _ulp  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.reset()
    yield
    faults.reset()


# -------------------------------------------------------------- the grammar

def test_parse_faults_matches_jax():
    spec = ("nan_grad@3;inf_grad@5; io_error@save:2 ;kill@commit:1;"
            "nan_grad@1;dispatch_fail@norm_update")
    p = parse_faults(spec)
    assert tuple(p) == tuple(j_faults.parse_faults(spec))
    assert p.grad_fault_steps("nan") == (1, 3)
    assert p.grad_fault_steps("inf") == (5,) and p.any_grad_faults
    assert p.io_errors == (("save", 2),) and p.kills == (("commit", 1),)
    assert p.dispatch_ops == ("norm_update",)


@pytest.mark.parametrize("bad", [
    "nan_grad", "nan_grad@x", "nan_grad@-1", "nan_grad@3:4",
    "io_error@tmp:1", "kill@save", "dispatch_fail@", "frobnicate@1"])
def test_parse_faults_rejects_bad_clauses(bad):
    with pytest.raises(ValueError, match="REPRO_FAULTS"):
        parse_faults(bad)


def test_resolve_plan_none_when_unset(monkeypatch):
    monkeypatch.delenv(faults.ENV_VAR, raising=False)
    assert resolve_plan() is None
    monkeypatch.setenv(faults.ENV_VAR, "  ")
    assert resolve_plan() is None
    monkeypatch.setenv(faults.ENV_VAR, "nan_grad@7")
    assert resolve_plan().grad_fault_steps("nan") == (7,)


# ----------------------------------------------- the guard on the same scalars

LOSSES = [3.0, 2.5, np.nan, 2.0, 10.0, np.inf, 1.9, 1.8, 50.0, np.nan,
          np.nan, np.nan, 1.7, 1.6]
GNORMS = [1.0, 1.0, 1.0, np.inf, 1.0, 1.0, np.nan, 1.0, 1.0, 1.0, 1.0, 1.0,
          1.0, 1.0]


@pytest.mark.parametrize("policy", [
    {}, {"max_bad_steps": 2}, {"spike_factor": 2.0, "spike_warmup": 2,
                               "ema_beta": 0.5},
    {"spike_factor": 3.0, "spike_warmup": 3, "max_bad_steps": 3}])
def test_guard_matches_jax_on_the_same_scalars(policy):
    jp, tp = JR.GuardPolicy(**policy), GuardPolicy(**policy)
    js, ts = JR.init_guard_state(), init_guard_state()
    for loss, gn in zip(LOSSES, GNORMS):
        jl, jg = jnp.float32(loss), jnp.float32(gn)
        tl = torch.tensor(loss, dtype=torch.float32)
        tg = torch.tensor(gn, dtype=torch.float32)
        jok = JR.guard_verdict(jp, js, jl, jg)
        tok = guard_verdict(tp, ts, tl, tg)
        assert bool(tok) == bool(jok), (loss, gn)
        js, jrb = JR.guard_step(jp, js, jok, jl)
        ts, trb = guard_step(tp, ts, tok, tl)
        assert bool(trb) == bool(jrb)
        for f in ("ema_count", "skipped", "consecutive_bad"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), f
            assert getattr(ts, f).dtype == torch.int32
        want = float(js.loss_ema)
        assert abs(float(ts.loss_ema) - want) <= _ulp(want, "float32")


# ------------------------------------------------------ the guarded train step

def _model(opt="scale_fused", **kw):
    jcfg = tiny_cfg("resilience", vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, j_make(opt, 1e-2, **kw), t_make(opt, 1e-2, **kw)


def _batches(jcfg, n):
    ds = j_dataset(jcfg, seq_len=32, global_batch=4, seed=3)
    return [{k: np.array(v) for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_state_from_jax(jstate, tcfg, ttx, tmp):
    """A JAX TrainState carried into the port through a JAX checkpoint."""
    jckpt.save(tmp, int(jstate.step), jstate)
    from repro_torch.models import init_params
    like = init_state(init_params(tcfg, torch.Generator().manual_seed(9),
                                  device="cpu"), ttx,
                      guard=jstate.guard is not None)
    return ckpt.restore(tmp, int(jstate.step), like)


def _port_run(tcfg, ttx, state, batches, plan=None, **kw):
    step = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy(),
                           faults=plan, **kw)
    m = None
    for b in batches:
        state, m = step(state, _t(b))
    return state, m


def _bitwise(a, b, skip=(".step",)):
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert list(la) == list(lb)
    for k, x in la.items():
        if k not in skip:
            assert torch.equal(x, lb[k]), k


def test_guard_requires_guard_carrying_state(tmp_path):
    jcfg, tcfg, jp, jtx, ttx = _model()
    state = _port_state_from_jax(JT.init_state(jp, jtx), tcfg, ttx,
                                 str(tmp_path))
    with pytest.raises(ValueError, match="guard-carrying"):
        _port_run(tcfg, ttx, state, _batches(jcfg, 1))


def _faulted_and_clean(kind, tmp_path):
    """Port runs over 5 batches with a fault at step 2, and clean over the
    batches of steps 0, 1, 3, 4, from one JAX state."""
    jcfg, tcfg, jp, jtx, ttx = _model()
    js0 = JT.init_state(jp, jtx, guard=True)
    batches = _batches(jcfg, 5)
    start = _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "a"))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy(),
                            faults=parse_faults(f"{kind}@2"))
    faulted, ms = start, []
    for b in batches:
        faulted, m = tstep(faulted, _t(b))
        ms.append(m)
    clean, _ = _port_run(
        tcfg, ttx, _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "b")),
        [batches[i] for i in (0, 1, 3, 4)])
    return jcfg, jp, jtx, js0, batches, faulted, ms, clean


@pytest.mark.parametrize("kind", ["nan_grad", "inf_grad"])
def test_injected_grad_fault_skips_step_bitwise(kind, tmp_path):
    """5 steps with a fault at step 2 == the clean run over the batches of
    steps 0, 1, 3, 4, bitwise (params, optimizer state, the guard's EMA).
    The skipped step reports update_norm 0."""
    _, _, _, _, _, faulted, ms, clean = _faulted_and_clean(kind, tmp_path)
    assert [int(m["bad_step"]) for m in ms] == [0, 0, 1, 0, 0]
    assert int(ms[-1]["skipped"]) == 1 and not bool(ms[-1]["rollback"])
    assert float(ms[2]["update_norm"]) == 0.0
    assert not np.isfinite(float(ms[2]["grad_norm"]))
    _bitwise(faulted._replace(guard=faulted.guard._replace(skipped=None)),
             clean._replace(guard=clean.guard._replace(skipped=None)))
    assert int(faulted.step) == 5 and int(clean.step) == 4
    assert int(faulted.opt_state.count) == 4


def test_injected_grad_fault_matches_the_jax_guarded_trainer(tmp_path):
    """The same faulted run (nan_grad@2) against the JAX guarded trainer's,
    within the trainer's f32 bounds."""
    plan = "nan_grad@2"
    jcfg, jp, jtx, js, batches, faulted, _, _ = _faulted_and_clean(
        "nan_grad", tmp_path)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0,
                                       guard=JR.GuardPolicy(),
                                       faults=j_faults.parse_faults(plan)))
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    for b in batches:
        old = _jflat(js.params)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        for k, w in _jflat(js.params).items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
    assert int(jm["skipped"]) == 1
    got = flatten(faulted.params)
    for k, w in _jflat(js.params).items():
        tol = 8 * _ulp(peak[k], "float32") + 1e-5 * travel[k].max()
        err = np.abs(got[k].numpy() - w)
        assert (err <= tol).all(), (k, float(err.max()))
    got_s = {k.lstrip("."): x for k, x in named_leaves(faulted.opt_state)}
    for k, w in _jflat(js.opt_state).items():
        if w.size and k != "count":
            tol = 4e-6 * np.abs(w).max()
            assert (np.abs(got_s[k].numpy() - w) <= tol).all(), k
    assert int(got_s["count"]) == int(_jflat(js.opt_state)["count"]) == 4


def test_faulted_build_is_bitwise_inert_off_the_fault_step(tmp_path):
    jcfg, tcfg, jp, jtx, ttx = _model()
    js0 = JT.init_state(jp, jtx, guard=True)
    batches = _batches(jcfg, 3)
    faulted, _ = _port_run(
        tcfg, ttx, _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "a")),
        batches, plan=parse_faults("nan_grad@9"))
    clean, _ = _port_run(
        tcfg, ttx, _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "b")),
        batches)
    _bitwise(faulted, clean, skip=())


def test_update_entry_point_skip_is_bitwise(tmp_path):
    """fused_apply=False: update + apply_updates make new params, and the
    update still writes the optimizer state in place."""
    jcfg, tcfg, jp, jtx, ttx = _model()
    js0 = JT.init_state(jp, jtx, guard=True)
    batches = _batches(jcfg, 3)
    faulted, m = _port_run(
        tcfg, ttx, _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "a")),
        batches, plan=parse_faults("inf_grad@1"), fused_apply=False)
    clean, _ = _port_run(
        tcfg, ttx, _port_state_from_jax(js0, tcfg, ttx, str(tmp_path / "b")),
        [batches[0], batches[2]], fused_apply=False)
    assert int(m["skipped"]) == 1
    _bitwise(faulted._replace(guard=None), clean._replace(guard=None))


def test_galore_skip_before_a_refresh_matches_jax(tmp_path):
    """GaLore, rank 8, refresh every 3 steps. From a JAX state after one
    step (its projector carried over), a NaN at step 2 is skipped: the
    count stays 2, so step 3 must not refresh (a host mirror that ran
    ahead would), and step 4 refreshes in both."""
    jcfg, tcfg, jp, jtx, ttx = _model("galore", rank=8, update_proj_gap=3)
    batches = _batches(jcfg, 5)
    plan = "nan_grad@2"
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0,
                                       guard=JR.GuardPolicy(),
                                       faults=j_faults.parse_faults(plan)))
    js = JT.init_state(jp, jtx, guard=True)
    js, _ = jstep(js, {k: jnp.asarray(v) for k, v in batches[0].items()})
    state = _port_state_from_jax(js, tcfg, ttx, str(tmp_path))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy(),
                            faults=parse_faults(plan))
    key = "segments/seg0_dense/ffn/w_gate"
    peak = {k: np.abs(v) for k, v in _jflat(js.params).items()}
    moved = dict.fromkeys(peak, 0.0)  # sum over steps of the largest change
    for i in (1, 2, 3, 4):
        old = _jflat(js.params)
        proj_before = state.opt_state.extra["proj"][key].clone()
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batches[i].items()})
        state, tm = tstep(state, _t(batches[i]))
        assert int(tm["bad_step"]) == int(jm["bad_step"]) == (i == 2)
        assert state.opt_state.host_count.n == int(state.opt_state.count)
        proj = state.opt_state.extra["proj"][key]
        jproj = np.asarray(js.opt_state.extra["proj"]["segments"]["seg0_dense"]
                           ["ffn"]["w_gate"])
        if i < 4:
            # no refresh: the carried projector, and params on JAX's
            assert torch.equal(proj, proj_before), i
            for k, w in _jflat(js.params).items():
                step_k = np.abs(w - old[k])
                peak[k] = np.maximum(peak[k], np.maximum(np.abs(w), step_k))
                moved[k] += step_k.max()
                tol = 8 * _ulp(peak[k], "float32") + 5e-4 * moved[k]
                err = np.abs(flatten(state.params)[k].numpy() - w)
                assert (err <= tol).all(), (i, k, float(err.max()))
        else:
            assert not torch.equal(proj, proj_before)
            sign = np.sign((proj.numpy() * jproj).sum(axis=-2,
                                                      keepdims=True))
            err = np.abs(proj.numpy() * sign - jproj).max()
            assert err <= 1e-3 * np.abs(jproj).max(), err


def test_guarded_state_checkpoint_roundtrip(tmp_path):
    jcfg, tcfg, jp, jtx, ttx = _model()
    state = _port_state_from_jax(JT.init_state(jp, jtx, guard=True), tcfg,
                                 ttx, str(tmp_path / "a"))
    state, _ = _port_run(tcfg, ttx, state, _batches(jcfg, 2))
    ckpt.save(str(tmp_path / "b"), 2, state)
    restored, step = ckpt.restore_latest(str(tmp_path / "b"), state)
    assert step == 2 and int(restored.guard.ema_count) == 2
    _bitwise(state, restored, skip=())


def test_twenty_steps_from_one_jax_checkpoint_track_jax(tmp_path):
    """The longer comparison: JAX's trainer and the port's, both guarded,
    run 20 steps from one JAX checkpoint (after 2 JAX steps) on the same
    numpy batches; per-step losses agree to 1e-5 relative."""
    jcfg, tcfg, jp, _, _ = _model()
    jtx = j_make("scale_fused", _sched())
    batches = _batches(jcfg, 22)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0,
                                       guard=JR.GuardPolicy()))
    js = JT.init_state(jp, jtx, guard=True)
    for b in batches[:2]:
        js, _ = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ttx = t_make("scale_fused", _sched(torch))
    state = _port_state_from_jax(js, tcfg, ttx, str(tmp_path))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy())
    worst = 0.0
    for b in batches[2:]:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        state, tm = tstep(state, _t(b))
        rel = abs(float(tm["loss"]) - float(jm["loss"])) / float(jm["loss"])
        worst = max(worst, rel)
    assert int(state.step) == int(js.step) == 22
    assert float(tm["loss"]) < float(_first_loss(jcfg, jp, batches[2]))
    assert worst <= 1e-5, worst


def _sched(lib=None):
    if lib is None:
        from repro.core import linear_warmup_cosine
    else:
        from repro_torch.core import linear_warmup_cosine
    return linear_warmup_cosine(1e-2, 22)


def _first_loss(jcfg, jp, batch):
    return JT.make_eval_step(jcfg)(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()})["loss"]


# ------------------------------------------------------------ dispatch_fail

def test_dispatch_fail_raises_instead_of_degrading(monkeypatch):
    """The JAX package degrades to its reference; the port has no
    fallback, so the named entry point raises, before any launch."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (32, 16), np.float32))
    monkeypatch.setenv(faults.ENV_VAR, "dispatch_fail@norm_update")
    dispatch.normalize(g, "col")        # not named: runs
    theta = g.clone()
    with pytest.raises(faults.FaultError, match="norm_update"):
        dispatch.norm_update(theta, g, 0.01, "col")
    assert torch.equal(theta, g)        # raised before touching theta
    monkeypatch.setenv(faults.ENV_VAR, "dispatch_fail@*")
    for call in (lambda: dispatch.normalize(g, "col"),
                 lambda: dispatch.momentum_norm(g.clone(), g, 0.9, "col"),
                 lambda: dispatch.momentum_norm_update(
                     g.clone(), g.clone(), g, 0.9, 0.01, "col")):
        with pytest.raises(faults.FaultError, match="REPRO_FAULTS"):
            call()


def test_dispatch_fail_reaches_the_train_step(monkeypatch, tmp_path):
    jcfg, tcfg, jp, jtx, ttx = _model()
    state = _port_state_from_jax(JT.init_state(jp, jtx, guard=True), tcfg,
                                 ttx, str(tmp_path))
    monkeypatch.setenv(faults.ENV_VAR, "dispatch_fail@flash_attention")
    with pytest.raises(faults.FaultError, match="flash_attention"):
        _port_run(tcfg, ttx, state, _batches(jcfg, 1))


# ------------------------------------------------- the launcher, on the CPU

def _tiny_arch(arch, smoke=False):
    return ModelConfig(name=arch, n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab_size=256,
                       dtype="float32")


def _main(monkeypatch, args):
    monkeypatch.setattr(launch_train, "get_arch", _tiny_arch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loss = launch_train.main(["--device", "cpu", "--batch", "2",
                                  "--seq", "16", "--log-every", "1"] + args)
    return loss, buf.getvalue()


def test_launcher_skips_injected_nan_and_completes(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "nan_grad@2")
    loss, out = _main(monkeypatch, ["--steps", "6", "--ckpt-dir",
                                    str(tmp_path), "--ckpt-every", "6"])
    lines = out.splitlines()
    assert lines[0].startswith("fault injection active")
    assert lines[1].endswith("device=cpu guard=on")
    assert np.isfinite(loss) and "skipped 1 rollbacks 0" in out
    assert ckpt.latest_step(str(tmp_path)) == 6


def test_launcher_resume_auto_is_bitwise(tmp_path, monkeypatch):
    """6 steps with a checkpoint every 3, against the committed step 3 of
    the same run resumed with --resume auto to step 6: the final
    checkpoints' leaves are bitwise equal."""
    a, b = tmp_path / "a", tmp_path / "b"
    flags = ["--steps", "6", "--ckpt-every", "3", "--optimizer",
             "scale_fused"]
    _main(monkeypatch, flags + ["--ckpt-dir", str(a)])
    assert sorted(os.listdir(a)) == ["step_0000000003", "step_0000000006"]
    os.makedirs(b)
    os.rename(a / "step_0000000003", b / "step_0000000003")
    _, out = _main(monkeypatch, flags + ["--ckpt-dir", str(b), "--resume",
                                         "auto"])
    assert "resumed from step 3" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step ")] == ["4", "5", "6"]
    for name in ("shard_00000.mpk", "shard_00000.mpk.zst"):
        pa = a / "step_0000000006" / name
        if pa.exists():
            assert pa.read_bytes() == (b / "step_0000000006" / name
                                       ).read_bytes()
    assert (a / "step_0000000006" / "manifest.00000.json").read_text() == \
        (b / "step_0000000006" / "manifest.00000.json").read_text()


def test_launcher_rollback_without_checkpoint_cuts_lr_and_continues(
        monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "nan_grad@2;nan_grad@3")
    loss, out = _main(monkeypatch, ["--steps", "6", "--max-bad-steps", "2"])
    assert np.isfinite(loss)
    assert "rollback #1: no checkpoint" in out and "peak lr x0.5" in out


def test_launcher_rollback_restores_and_bounded_rollbacks_abort(
        tmp_path, monkeypatch):
    """Checkpoints at steps 2 and 4; the faults at 4 and 5 replay after
    every restore of step 4: rollback #1 restores it, #2 aborts."""
    monkeypatch.setenv(faults.ENV_VAR, "nan_grad@4;nan_grad@5")
    monkeypatch.setattr(launch_train, "get_arch", _tiny_arch)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            pytest.raises(RuntimeError, match="giving up after 1 rollbacks"):
        launch_train.main(["--device", "cpu", "--batch", "2", "--seq", "16",
                           "--log-every", "1", "--steps", "8", "--ckpt-dir",
                           str(tmp_path), "--ckpt-every", "2",
                           "--max-bad-steps", "2", "--max-rollbacks", "1"])
    assert "rollback #1: restored step 4, peak lr x0.5" in buf.getvalue()


_SIGTERM_MAIN = """
import sys
from repro_torch.launch import train
from repro_torch.models import ModelConfig
train.get_arch = lambda arch, smoke=False: ModelConfig(
    name=arch, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, dtype="float32")
train.main(sys.argv[1:])
"""


def test_launcher_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_MAIN, "--device", "cpu", "--steps",
         "100000", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--ckpt-dir", str(tmp_path), "--ckpt-every", "100000", "--resume",
         "auto"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("step "):
                break
        else:
            pytest.fail("launcher exited before its first step:\n"
                        + "".join(lines))
        proc.send_signal(signal.SIGTERM)
        lines.extend(proc.stdout)
        assert proc.wait(timeout=120) == 0, "".join(lines)
    finally:
        proc.kill()
    out = "".join(lines)
    last = [ln for ln in out.splitlines() if ln.startswith("sigterm:")]
    assert last and last[0].endswith("exiting cleanly"), out
    n = int(last[0].split()[3].rstrip(","))
    assert ckpt.latest_step(str(tmp_path)) == n >= 1
