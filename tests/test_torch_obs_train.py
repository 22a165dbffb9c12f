"""The telemetry plane in the port's trainer and launcher against the JAX
package's, on the CPU: ``make_train_step(stats=...)`` and the launcher's
``--log-dir`` / ``--metrics-every`` / ``--stats-every`` /
``--profile-steps``.

  * a run with stats is bitwise a run without (guard on; the fused write
    and ``update`` + ``apply_updates``; and the fused write with neither
    ``norm_metrics`` nor the guard, where the cadence step takes the
    pre-step snapshot itself);
  * the cadence equals JAX's across a ``nan_grad@K`` skip and across a
    checkpoint restore, off-cadence steps carry zeros and ``stats/valid``
    0, and on-cadence values follow JAX's trainer;
  * both launchers train the same tiny llama from the same weights and
    batches and write JSONL that JAX's ``validate_jsonl`` accepts, with
    the same record kinds, steps and key sets;
  * SIGTERM flushes the metrics tail (``run_end`` with reason
    ``sigterm``).

Tolerances: the stats along a trained trajectory in f32, 1e-3 relative:
the two trainers' parameters drift apart by f32 roundings in other orders
(``tests/test_torch_trainer.py``: about 1e-6 of a leaf's scale a step),
and the update norms difference parameters of unit scale that moved by
1e-2, which carries that drift up by two orders (observed 2e-5); the
printed losses 2e-4 (``tests/test_torch_tied.py``'s); everything
else exactly.
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro import obs as JO  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import faults as j_faults  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro.training.resilience import GuardPolicy as JGuard  # noqa: E402
import repro_torch.checkpoint as ckpt  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.checkpoint.checkpointer import named_leaves  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels.colnorm import colnorm as C  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import (GuardPolicy, TrainState,  # noqa: E402
                                  init_state, make_train_step, parse_faults)
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import _batches, _jflat, _t  # noqa: E402

TRAJ_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def _model(dt="float32"):
    jcfg = tiny_cfg("obs", dtype=dt, vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp


def _leaves(state):
    return dict(named_leaves(state._replace(step=None)))


# --------------------------------------------------- bitwise inertness

@pytest.mark.parametrize("fused,guard,norm_metrics", [
    (True, True, True), (False, True, True), (True, False, False)])
def test_a_run_with_stats_is_bitwise_a_run_without(fused, guard,
                                                   norm_metrics):
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(
        tiny_cfg("obs", dtype="bfloat16", vocab_size=250)))
    ds = make_dataset(tcfg, 32, 4, seed=3, device="cpu")
    batches = [ds.global_batch_at(i) for i in range(4)]
    runs = []
    for stats in (None, TO.StatsPolicy(every_k=1),
                  TO.StatsPolicy(every_k=3)):
        tx = t_make("scale_fused", 1e-2)
        state = init_state(TM.init_params(
            tcfg, torch.Generator().manual_seed(0), device="cpu"), tx,
            guard=guard)
        step = make_train_step(tcfg, tx, clip_norm=1.0, fused_apply=fused,
                               norm_metrics=norm_metrics,
                               guard=GuardPolicy() if guard else None,
                               stats=stats)
        n0 = C.norm_sumsq.launches
        for b in batches:
            state, metrics = step(state, b)
        assert C.norm_sumsq.launches == n0
        assert state.host_step.n == int(state.step) == 4
        runs.append((_leaves(state), metrics))
    (base, m0), (every, m1), (third, m3) = runs
    for other in (every, third):
        assert set(other) == set(base)
        for k, x in base.items():
            assert x.dtype == other[k].dtype and torch.equal(x, other[k]), k
    for k, v in m0.items():
        assert torch.equal(v, m1[k]) and torch.equal(v, m3[k]), k
    assert float(m1["stats/valid"]) == 1.0
    assert float(m3["stats/valid"]) == 0.0   # completed step 4, every 3
    assert set(m1) == set(m0) | set(TO.stats_keys(TO.StatsPolicy()))


# ----------------------------------------------- the cadence against JAX

FAULT = "nan_grad@3"   # the 4th step (device step 3): on the cadence
EVERY = 2
STEPS = 6


def _jax_stats_run():
    jcfg, tcfg, jp = _model()
    jtx = j_make("scale_fused", 1e-2)
    fn = jax.jit(JT.make_train_step(
        jcfg, jtx, clip_norm=1.0, guard=JGuard(),
        faults=j_faults.parse_faults(FAULT),
        stats=JO.StatsPolicy(every_k=EVERY)))
    state = JT.init_state(jp, jtx, guard=True)
    out = []
    for b in _batches(jcfg, STEPS):
        state, m = fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        out.append({k: float(v) for k, v in m.items()})
    return jcfg, tcfg, jp, out


def _check_step(i, got, want):
    assert set(got) == set(want), i
    for k, w in want.items():
        g = float(got[k])
        if not k.startswith("stats/"):
            continue
        if w == 0.0 or not np.isfinite(w):
            assert g == w or (np.isnan(g) and np.isnan(w)), (i, k, g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=TRAJ_RTOL,
                                       err_msg=f"step {i + 1} {k}")


def test_cadence_equals_jax_across_a_skip_and_a_restore(tmp_path):
    jcfg, tcfg, jp, want = _jax_stats_run()
    valid = [m["stats/valid"] for m in want]
    assert valid == [0.0, 1.0, 0.0, 1.0, 0.0, 1.0]
    assert [m["skipped"] for m in want] == [0, 0, 0, 1, 1, 1]
    # the skipped step is on the cadence: NaN gradient stats, no update
    assert np.isnan(want[3]["stats/lm_head/grad_norm"])
    assert want[3]["stats/lm_head/update_norm"] == 0.0

    ttx = t_make("scale_fused", 1e-2)
    pol = TO.StatsPolicy(every_k=EVERY)

    def build(tx):
        return make_train_step(tcfg, tx, clip_norm=1.0, guard=GuardPolicy(),
                               faults=parse_faults(FAULT), stats=pol)

    state = init_state(load_flat(_jflat(jp), tcfg, device="cpu"), ttx,
                       guard=True)
    step = build(ttx)
    batches = [_t(b) for b in _batches(jcfg, STEPS)]
    got = []
    for b in batches[:3]:
        state, m = step(state, b)
        got.append(m)
    ckpt.save(str(tmp_path), 3, state)
    # a fresh process's state, restored: the host mirror is re-seated
    ttx2 = t_make("scale_fused", 1e-2)
    like = init_state(load_flat(_jflat(jp), tcfg, device="cpu"), ttx2,
                      guard=True)
    assert like.host_step.n == 0
    state = ckpt.restore(str(tmp_path), 3, like)
    assert isinstance(state, TrainState) and state.host_step.n == 3
    step = build(ttx2)
    for b in batches[3:]:
        state, m = step(state, b)
        got.append(m)
    assert state.host_step.n == int(state.step) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        _check_step(i, g, w)
        if not w["stats/valid"]:
            assert all(float(v) == 0.0 for k, v in g.items()
                       if k.startswith("stats/")), i


def test_a_hand_built_state_reads_its_step_once():
    jcfg, tcfg, jp = _model()
    tx = t_make("scale", 1e-2)
    s = init_state(load_flat(_jflat(jp), tcfg, device="cpu"), tx)
    bare = TrainState(torch.tensor(5, dtype=torch.int32), s.params,
                      s.opt_state)
    step = make_train_step(tcfg, tx, stats=TO.StatsPolicy(every_k=6))
    state, m = step(bare, _t(_batches(jcfg, 1)[0]))
    assert float(m["stats/valid"]) == 1.0 and state.host_step.n == 6
    # without stats nothing is read and nothing is mirrored
    state, m = make_train_step(tcfg, tx)(bare, _t(_batches(jcfg, 1)[0]))
    assert state.host_step is None and "stats/valid" not in m


# ------------------------------------------------------------ launchers

def _tiny_arch(arch, smoke=False):
    """JAX's get_arch, patched to the tiny llama."""
    del smoke
    return tiny_cfg(arch, vocab_size=256)


def _tiny_arch_t(arch, smoke=False):
    """The port's get_arch, patched to the same llama."""
    return tconfig.ModelConfig(**dataclasses.asdict(_tiny_arch(arch)))


class _JaxBatches:
    """The JAX SyntheticLM's batches, as torch tensors."""

    def __init__(self, cfg, seq_len, global_batch, seed):
        self.ds = JD.make_dataset(cfg, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed)

    def host_batch_at(self, step):
        return _t({k: np.array(v)
                   for k, v in self.ds.host_batch_at(step).items()})


# the record fields that are words; every other is a JSON number or null
WORDS = {"schema", "kind", "arch", "optimizer", "reason", "event"}


def _records(path):
    recs = [json.loads(x) for x in open(path)]
    for r in recs:
        for k, v in r.items():
            if k not in WORDS:
                assert v is None or isinstance(v, (bool, int, float)), (
                    r["kind"], k, v)
    return recs


def test_both_launchers_write_the_same_records(tmp_path, monkeypatch):
    flags = ["--arch", "tiny", "--optimizer", "scale_fused", "--steps", "5",
             "--batch", "2", "--seq", "16", "--log-every", "1", "--seed",
             "0", "--metrics-every", "2", "--stats-every", "2",
             "--profile-steps", "1:2"]
    monkeypatch.setattr(j_launch, "get_arch", _tiny_arch)
    monkeypatch.setattr(t_launch, "get_arch", _tiny_arch_t)
    jp = JM.init_params(jax.random.PRNGKey(0), _tiny_arch("tiny"))
    monkeypatch.setattr(t_launch, "init_params",
                        lambda c, gen, device: load_flat(_jflat(jp), c,
                                                         device=device))
    monkeypatch.setattr(t_launch, "make_dataset",
                        lambda c, seq_len, global_batch, seed, pack_documents,
                        device: _JaxBatches(_tiny_arch("tiny"), seq_len,
                                            global_batch, seed))
    recs = {}
    for name, main, extra in (("jax", j_launch.main, []),
                              ("port", t_launch.main, ["--device", "cpu"])):
        d = tmp_path / name
        # the JAX profiler writes its own format: the port's trace only
        prof = [] if name == "port" else ["--profile-steps", ""]
        with contextlib.redirect_stdout(io.StringIO()):
            main(flags + ["--log-dir", str(d)] + extra + prof)
        path = str(d / "metrics.0.jsonl")
        assert JO.validate_jsonl(path) == TO.validate_jsonl(path)
        recs[name] = _records(path)
    jr, tr = recs["jax"], recs["port"]
    assert [r["kind"] for r in tr] == [r["kind"] for r in jr] == [
        "run_header", "train_step", "train_step", "train_step", "train_step",
        "run_end"]
    assert [r["step"] for r in tr] == [r["step"] for r in jr] == [
        0, 1, 2, 4, 5, 5]
    for a, b in zip(tr, jr):
        assert set(a) == set(b), (a["kind"], set(a) ^ set(b))
        assert a["host"] == b["host"] == 0
    assert {k: v for k, v in tr[0].items() if k != "t"} == \
        {k: v for k, v in jr[0].items() if k != "t"}
    assert tr[-1]["fallbacks"] is None and tr[-1]["reason"] == "done"
    for a, b in zip(tr[1:-1], jr[1:-1]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0, atol=2e-4)
        on = "stats/lm_head/colnorm_disp" in a
        assert on == (a["step"] % 2 == 0)
        for k, v in b.items():
            if k.startswith("stats/"):
                np.testing.assert_allclose(a[k], v, rtol=TRAJ_RTOL,
                                           atol=1e-12, err_msg=k)
        assert a["time/step_n"] >= 1 and a["tokens_per_s"] > 0
        assert a["rollbacks"] == 0 and a["lr_scale"] == 1.0
        assert not any(k.startswith("mem/") for k in a)   # a CPU run
    trace = tmp_path / "port" / "profile" / "trace_steps_1_2.json"
    text = trace.read_text()
    for span in ("train_step", "data_wait", "fwd", "optimizer_update",
                 "guard", "obs_stats"):
        assert f'"{span}"' in text, span


def test_launcher_rollback_logs_an_event_and_flushes(tmp_path, monkeypatch):
    monkeypatch.setenv(j_faults.ENV_VAR, "nan_grad@1;nan_grad@2")
    monkeypatch.setattr(t_launch, "get_arch", _tiny_arch_t)
    with contextlib.redirect_stdout(io.StringIO()):
        t_launch.main(["--device", "cpu", "--batch", "2", "--seq", "16",
                       "--steps", "4", "--max-bad-steps", "2",
                       "--log-dir", str(tmp_path), "--metrics-every", "1",
                       "--stats-every", "1"])
    recs = _records(tmp_path / "metrics.0.jsonl")
    JO.validate_jsonl(str(tmp_path / "metrics.0.jsonl"))
    ev = [r for r in recs if r["kind"] == "event"]
    assert len(ev) == 1 and ev[0]["event"] == "rollback"
    assert ev[0]["rollbacks"] == 1 and ev[0]["lr_scale"] == 0.5
    assert ev[0]["skipped"] == 2
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert steps[-1]["rollbacks"] == 1 and steps[-1]["lr_scale"] == 0.5
    assert all(r["stats/valid"] == 1.0 if "stats/valid" in r else True
               for r in steps)
    assert recs[-1]["kind"] == "run_end" and recs[-1]["rollbacks"] == 1


_SIGTERM_MAIN = """
import sys
from repro_torch.launch import train
from repro_torch.models import ModelConfig
train.get_arch = lambda arch, smoke=False: ModelConfig(
    name=arch, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
    vocab_size=256, dtype="float32")
train.main(sys.argv[1:])
"""


def test_cli_sigterm_flushes_metrics_tail(tmp_path):
    """SIGTERM mid-run: the run_end record (reason sigterm) is on disk
    before the process exits."""
    env = dict(os.environ)
    env.pop(j_faults.ENV_VAR, None)
    env["PYTHONPATH"] = (os.path.join(os.path.dirname(__file__), "..", "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    env["OMP_NUM_THREADS"] = "1"
    logdir = tmp_path / "logs"
    proc = subprocess.Popen(
        [sys.executable, "-c", _SIGTERM_MAIN, "--device", "cpu", "--steps",
         "100000", "--batch", "2", "--seq", "16", "--log-every", "1",
         "--metrics-every", "1", "--stats-every", "3", "--log-dir",
         str(logdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
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
    path = str(logdir / "metrics.0.jsonl")
    assert TO.validate_jsonl(path) == JO.validate_jsonl(path) >= 3
    recs = _records(path)
    assert recs[0]["kind"] == "run_header"
    assert recs[-1]["kind"] == "run_end" and recs[-1]["reason"] == "sigterm"
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert steps and steps[-1]["step"] == recs[-1]["step"]


def test_launch_flags_match_jax():
    """The telemetry flags and their defaults are JAX's."""
    def flags(mod):
        seen = {}
        real = argparse.ArgumentParser.parse_args

        def grab(self, argv=None, ns=None):
            seen.update({a.dest: a.default for a in self._actions})
            raise SystemExit(0)
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = real
        return seen
    want = ("log_dir", "metrics_every", "stats_every", "profile_steps",
            "profile_dir")
    jf, tf = flags(j_launch), flags(t_launch)
    assert {k: tf[k] for k in want} == {k: jf[k] for k in want}
