"""The port's optimizer zoo (``repro_torch.core.make_optimizer``) against
the JAX package's, name by name (those that multiply matrices in
``test_torch_optimizers_matrix.py``, with this file's machinery): the tiny ragged LLaMA of
``test_torch_scale.py`` (2 layers, d_model 64, d_ff 173, vocab 1000),
numpy grads from a seed, three steps through ``update`` (the trainer's
clip tree-map, then ``apply_updates``) and through ``update_params`` (the
clip factor folded in as ``grad_scale``), in f32 and in bf16. The JAX
side runs eagerly, once per case and dtype: on its plain path its two
entry points are bitwise equal, so one trajectory serves both of the
port's (the fused names run each JAX entry, its kernels in interpret
mode). The state crosses by ``load_opt_state`` before the first step; for
the projection family (rank 8) after one JAX step, so that the three
steps run from JAX's own projector (``jax.random`` cannot be drawn in
torch; ``test_torch_galore.py`` holds the refresh step itself).

Tolerances, per element, with ``ulp(x)`` the spacing of the dtype at x:
  * params in f32: 8 ulps of the element's peak (the largest |value| or
    |step change| of its JAX trajectory), as in ``test_torch_scale.py``;
    for the names whose step divides by an Adam bias correction or
    multiplies matrices (``MIXED``), plus 256 ulps of the leaf's largest
    step change for each step. Two causes, both measured: XLA's
    ``pow(0.999f, 3)`` is one ulp off the correctly rounded value torch
    gives, and ``1 - b2**t`` magnifies that to 2e-5 of Adam's step
    (about 170 ulps of it); the Newton-Schulz, SVD and projection
    products sum in other orders, to 12-46 ulps of the leaf's largest
    element a call;
  * params in bf16: 1 ulp of the peak, as in ``test_torch_scale.py``; a
    ``MIXED`` name may flip a rounding once a step, so 3;
  * state in f32 (moments, projectors, Stable-SPAM's EMAs): 4 ulps of the
    leaf's largest |value|; 8 for the projection family (R = P^T G sums in
    other orders); 1024 for Stable-SPAM, whose AdaClip threshold divides
    by ``1 - theta**t`` (the pow ulp above, magnified by 1/(1 - 0.999**t))
    and whose ``nu`` squares the clipped gradient; bf16-stored momentum 1
    ulp;
  * the projectors are carried, not refreshed, in these steps: equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import OPTIMIZER_NAMES as J_NAMES  # noqa: E402
from repro.core import OPTIMIZER_REGISTRY as J_REG  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro_torch import core as TCore  # noqa: E402
from repro_torch.core.pipeline import HostCount, jax_mul  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import (load_flat, load_opt_state,  # noqa: E402
                                        opt_state_to_flat)
from test_torch_scale import (JCFG, STEPS, _T, _grads, _model, _np,  # noqa: E402
                              _track, _ulp, jax_flat, jax_state_flat)

PROJ = ("galore", "fira", "apollo", "apollo_mini")
GS = 0.37  # the clip factor of every step

# case -> (registry name, kwargs)
ALL_CASES = {name: (name, {"rank": 8} if name in PROJ[:3] else {})
             for name in J_NAMES}
ALL_CASES.update({
    "sgd_colnorm_fused": ("sgd_colnorm", {"impl": "fused"}),
    "sgd_nesterov": ("sgd_momentum", {"nesterov": True}),
    "adam_bf16_momentum": ("adam", {"momentum_dtype": "bfloat16"}),
    "adams_wd": ("adams", {"weight_decay": 0.01}),
    "stable_spam_reset2": ("stable_spam", {"reset_interval": 2}),
})
# the names that multiply matrices run in test_torch_optimizers_matrix.py
MATRIX_NAMES = {"muon", "swan", "sgd_nsnorm", "sgd_svdnorm", *PROJ}
CASES = {c: v for c, v in ALL_CASES.items() if v[0] not in MATRIX_NAMES}
# step divides by an Adam bias correction on a matrix, or multiplies
# matrices (see the module docstring)
MIXED = {"adam", "adamw", "adams", "stable_spam", "muon", "swan", "galore",
         "fira", "apollo", "apollo_mini", "sgd_nsnorm", "sgd_svdnorm"}
_J = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's CPU ops on one thread for this module, restored after it:
    these tensors are tiny, and under a loaded test run (one worker a
    core) torch's OpenMP threads spin against the other workers, which
    made these files several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(case):
    name, kw = ALL_CASES[case]
    return j_make(name, 1e-2, **kw), TCore.make_optimizer(name, 1e-2, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(case, dt, entry):
    """JAX's trajectory: (params and state where the port starts, the
    params after each step, the final state, the per-element track).

    The names that multiply matrices run op by op (``jax.disable_jit``):
    eagerly, JAX's Newton-Schulz compiles a new ``scan`` on every call; op
    by op each op compiles once. (Op by op slows the element-wise names,
    whose jitted helpers then no longer compile.)"""
    if ALL_CASES[case][0] not in MATRIX_NAMES:
        return _jax_trajectory(case, dt, entry)
    with jax.disable_jit():
        return _jax_trajectory(case, dt, entry)


def _jax_trajectory(case, dt, entry):
    jtx, _ = _build(case)
    jdt = _J[dt]
    jp, _ = _model(jdt)
    js = jtx.init(jp)
    if ALL_CASES[case][0] in PROJ:  # one step that forms JAX's projector
        jg, _ = _grads(jp, 9)
        jp, js = jtx.update_params(jg, js, jp)
    start = (jax_flat(jp), jax_state_flat(js))
    gs = jnp.asarray(GS, jnp.float32)
    track = {}
    for step in range(STEPS):
        jg, _ = _grads(jp, step)
        old = jp
        if entry == "update":
            jg = jax.tree_util.tree_map(lambda g: g * gs, jg)
            ju, js = jtx.update(jg, js, jp)
            jp = jax.tree_util.tree_map(
                lambda p, u: p + u.astype(p.dtype), jp, ju)
        else:
            jp, js = jtx.update_params(jg, js, jp, grad_scale=gs)
        track = _track(track, jp, old)
    return start, jax_flat(jp), jax_state_flat(js), track


def _port_params(flat, dt):
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(
        dataclasses.replace(JCFG, dtype=dt)))
    return flatten(load_flat(flat, tcfg, device="cpu"))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["update", "update_params"])
@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_jax_after_three_steps(case, entry, dt):
    _check(case, entry, dt)


def _check(case, entry, dt):
    name, kw = ALL_CASES[case]
    fused = {**J_REG[name].defaults, **kw}.get("impl") == "fused"
    (p0, s0), want_p, want_s, track = _jax_run(
        case, dt, entry if fused else "update_params")
    _, ttx = _build(case)
    jdt = _J[dt]
    tp = _port_params(p0, dt)
    ts = load_opt_state(s0, tp, ttx, device="cpu")
    assert ts.host_count.n == int(s0[".count"])
    gs = torch.tensor(GS, dtype=torch.float32)
    for step in range(STEPS):
        _, gflat = _grads_like(p0, step)
        tg = {k: torch.tensor(v).to(_T[jdt]) for k, v in gflat.items()}
        if entry == "update_params":
            ptrs = {k: t.data_ptr() for k, t in tp.items()}
            tp, ts = ttx.update_params(tg, ts, tp, grad_scale=gs)
            assert {k: t.data_ptr() for k, t in tp.items()} == ptrs
        else:
            tg = {k: jax_mul(g, gs) for k, g in tg.items()}
            tu, ts = ttx.update(tg, ts, tp)
            tp = TCore.apply_updates(tp, tu)
    mixed = name in MIXED
    for k, w in want_p.items():
        err = np.abs(_np(tp[k]) - w)
        peak, stp = track[k]
        if jdt == jnp.float32:
            tol = 8 * _ulp(peak, jdt)
            if mixed:
                tol = tol + STEPS * 256 * _ulp(stp.max(), jdt)
        else:
            tol = (STEPS if mixed else 1) * _ulp(peak, jdt)
        assert (err <= tol).all(), (k, float(err.max()),
                                    float((err / tol).max()))
    got = opt_state_to_flat(ts)
    want = {k.lstrip("."): v for k, v in want_s.items()}
    assert set(got) == set(want)
    assert got["count"] == want["count"] == STEPS + (name in PROJ)
    assert ts.host_count.n == int(want["count"])
    bf16_mu = kw.get("momentum_dtype") == "bfloat16"
    for k, w in want.items():
        if k == "count" or not w.size:
            assert got[k].shape == w.shape
            continue
        if k.startswith("extra/proj/"):
            np.testing.assert_array_equal(got[k], w)
            continue
        if bf16_mu and k.startswith("mu/") and w.ndim >= 2:
            tol = _ulp(np.abs(w).max(), jnp.bfloat16)
        else:
            ulps = (1024 if name == "stable_spam" else
                    8 if name in PROJ else 4)
            tol = ulps * _ulp(np.abs(w).max(), jnp.float32)
        err = np.abs(got[k] - w)
        assert (err <= tol).all(), (k, float(err.max()), float(tol))


def _grads_like(flat, step):
    """``_grads`` from the flat shapes: the same seeded draws, in JAX's
    leaf order (``flat`` is a ``jax_flat``)."""
    rng = np.random.default_rng(100 + step)
    return None, {k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in flat.items()}


def _layout(state):
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in {"count": state.count,
                         **flatten(state.mu, "mu"), **flatten(state.nu, "nu"),
                         **(flatten(state.extra, "extra")
                            if state.extra is not None else {})}.items()}


@pytest.mark.parametrize("case", list(ALL_CASES))
def test_state_layout_is_jax_and_a_fixed_point(case):
    """init's layout (placeholders included) is JAX's, and update and
    update_params leave every shape and dtype as init made them."""
    jtx, ttx = _build(case)
    jp, tp = _model(jnp.bfloat16)
    s0 = ttx.init(tp)
    spec = _layout(s0)
    js = jtx.init(jp)
    jspec = {path_str(p).lstrip("."): (tuple(x.shape), str(x.dtype))
             for p, x in jax.tree_util.tree_flatten_with_path(js)[0]}
    assert spec == jspec
    _, gflat = _grads(jp, 0)
    tg = {k: torch.tensor(v).to(torch.bfloat16) for k, v in gflat.items()}
    _, s1 = ttx.update(tg, s0, tp)
    _, s2 = ttx.update_params(tg, s1, tp, grad_scale=torch.tensor(0.5))
    for s in (s1, s2):
        assert _layout(s) == spec
    assert int(s2.count) == s2.host_count.n == 2


@pytest.mark.parametrize("name", ["adamw", "adams"])
def test_weight_decay_needs_params_in_delta_mode(name):
    """As in JAX: decoupled weight decay reads the params, so ``update``
    without them raises."""
    jp, tp = _model(jnp.float32)
    jtx = j_make(name, 1e-2, weight_decay=0.01)
    ttx = TCore.make_optimizer(name, 1e-2, weight_decay=0.01)
    jg, gflat = _grads(jp, 0)
    with pytest.raises(ValueError, match="weight_decay requires params"):
        jtx.update(jg, jtx.init(jp))
    with pytest.raises(ValueError, match="weight_decay requires params"):
        ttx.update({k: torch.tensor(v) for k, v in gflat.items()},
                   ttx.init(tp))


def test_registry_matches_jax():
    """The 20 names in JAX's order, with JAX's defaults, fused flags and
    lowering notes, and the same kwargs."""
    assert TCore.OPTIMIZER_NAMES == J_NAMES and len(J_NAMES) == 20
    for name in J_NAMES:
        t, j = TCore.OPTIMIZER_REGISTRY[name], J_REG[name]
        assert (t.defaults, t.fused, t.lowering) == (j.defaults, j.fused,
                                                     j.lowering)
        assert t.valid_kwargs() == j.valid_kwargs()


def test_reset_runs_on_the_device_without_a_host_branch():
    """Stable-SPAM's momentum reset (count % k == 0 and count > 0) is a
    device-side where: it zeroes the moments at count 2 and leaves them
    at counts 0 and 1."""
    _, tp = _model(jnp.float32)
    tx = TCore.make_optimizer("stable_spam", 1e-2, reset_interval=2)
    s = tx.init(tp)
    g = {k: torch.ones_like(p) for k, p in tp.items()}
    for _ in range(2):
        _, s = tx.update(g, s, tp)
    k = "lm_head/w"
    before = s.mu[k].clone()
    assert before.abs().min() > 0
    _, s = tx.update(g, s, tp)
    # reset, then one EMA step from zero: (1 - b1) * g, clipped/scaled
    # as the hook scales it
    assert (s.mu[k].abs() < before.abs()).all()
    assert isinstance(s.host_count, HostCount) and s.host_count.n == 3
