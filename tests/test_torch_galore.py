"""The port's projection family (GaLore, Fira, APOLLO, APOLLO-Mini; rank 8)
against the JAX package's, where the two can be held against each other:

  * the projection helpers (``_project``, ``_project_back`` both ways,
    ``_svd_projector``) on the same inputs;
  * GaLore's and Fira's refresh step from ``init``: the SVD projector is
    held only up to the sign of each column (LAPACK builds choose signs
    differently), the low-rank first moment up to the matching signs, and
    the step's update, which does not depend on the signs, directly. Only
    this first refresh is sign-invariant: a later one keeps the moments
    of the old basis, so each side's signs enter its update; the steps
    after it run from a carried JAX projector instead;
  * APOLLO's random projector cannot be drawn as ``jax.random`` draws it:
    the port's draw is held to JAX's shape and 1/sqrt(r) scale and to its
    own reproducibility (seed, refresh block, leaf); the steps that run
    from a carried JAX projector are in ``test_torch_optimizers_matrix.py``;
  * the host step mirror decides the refresh without reading the device.

Tolerances, per element, with M the largest |ref| of the leaf (f32):
  * the helpers: 16 ulps of M (f32 products summed in other orders);
  * the refreshed projector, sign-aligned, and the first moment: 1e-3 of
    M — singular vectors from two LAPACK builds, whose error grows as
    ulp * |G| / (gap between singular values); the top singular values
    of these random gradients lie close together (measured up to
    1.5e-4);
  * the refresh step's params: 8 ulps of the element's peak plus 5e-4 of
    the leaf's largest step change per step, the projector's error
    carried into the step (measured up to 7.9e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core import pipeline as JP  # noqa: E402
from repro_torch import core as TCore  # noqa: E402
from repro_torch.core import pipeline as TP  # noqa: E402
from repro_torch.models.weights import (load_opt_state,  # noqa: E402
                                        opt_state_to_flat)
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_scale import (_grads, _model, _np, _track, _ulp,  # noqa: E402
                              jax_flat, jax_state_flat)

SHAPES = {"left": (2, 64, 173), "right": (2, 173, 64), "square": (40, 40)}


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, ulps):
    m = np.abs(want).max()
    assert (np.abs(got - want) <= ulps * _ulp(m, jnp.float32)).all(), (
        float(np.abs(got - want).max()), float(m))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_projection_helpers_match_jax(shape):
    sh = SHAPES[shape]
    g = _rand(sh, 1)
    r = TP._rank_for(sh, 8)
    assert r == JP._rank_for(sh, 8) and \
        TP._proj_left(sh) == JP._proj_left(sh)
    d = sh[-2] if TP._proj_left(sh) else sh[-1]
    p = _rand(sh[:-2] + (d, r), 2)
    R = TP._project(torch.tensor(g), torch.tensor(p))
    jR = JP._project(jnp.asarray(g), jnp.asarray(p))
    _close(R.numpy(), np.asarray(jR), 16)
    back = TP._project_back(R, torch.tensor(p), sh)
    jback = JP._project_back(jR, jnp.asarray(p), sh)
    assert tuple(back.shape) == sh
    _close(back.numpy(), np.asarray(jback), 16)
    # the SVD projector: JAX's shape, orthonormal columns
    P = TP._svd_projector(torch.tensor(g), r)
    assert tuple(P.shape) == tuple(JP._svd_projector(jnp.asarray(g), r).shape)
    eye = P.mT @ P
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(r, dtype=np.float32), eye.shape), atol=1e-5)


def _signs(got, want):
    """+-1 per projector column aligning ``got`` with ``want``."""
    return np.where((got * want).sum(axis=-2, keepdims=True) < 0, -1.0, 1.0)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["galore", "fira"])
def test_refresh_step_matches_jax_up_to_column_signs(mode, dt):
    jdt = getattr(jnp, dt)
    jp, tp = _model(jdt)
    jtx, ttx = j_make(mode, 1e-2, rank=8), TCore.make_optimizer(
        mode, 1e-2, rank=8)
    js = jtx.init(jp)
    ts = load_opt_state(jax_state_flat(js), tp, ttx, device="cpu")
    jg, gflat = _grads(jp, 0)
    old = jp
    jp, js = jtx.update_params(jg, js, jp)
    tp, ts = ttx.update_params(
        {k: torch.tensor(v).to(getattr(torch, dt)) for k, v in gflat.items()},
        ts, tp)
    track = _track({}, jp, old)
    for k, w in jax_flat(jp).items():
        peak, stp = track[k]
        if dt == "float32":
            tol = 8 * _ulp(peak, jdt) + 5e-4 * stp.max()
        else:
            tol = 2 * _ulp(peak, jdt)
        err = np.abs(_np(tp[k]) - w)
        assert (err <= tol).all(), (k, float(err.max()))
    jproj = {k: np.asarray(v) for k, v in jax_flat(js.extra["proj"]).items()}
    jmu = jax_flat(js.mu)
    n = 0
    for k, w in jproj.items():
        if not w.size:
            continue
        n += 1
        got = ts.extra["proj"][k].numpy()
        s = _signs(got, w)
        assert (np.abs(got * s - w) <= 1e-3 * np.abs(w).max()).all(), k
        # the first moment follows the signs: rows (left) or columns
        # (right) of the low-rank moment
        sh = tp[k].shape
        sm = s.swapaxes(-1, -2) if TP._proj_left(sh) else s
        m = ts.mu[k].numpy() * sm
        assert (np.abs(m - jmu[k]) <= 1e-3 * np.abs(jmu[k]).max()).all(), k
    assert n == 7  # every hidden matrix of the two-layer model


def test_random_projector_is_reproducible_with_jax_shape_and_scale():
    _, tp = _model(jnp.float32)
    jp, _ = _model(jnp.float32)
    tx = TCore.make_optimizer("apollo", 1e-2, rank=8, update_proj_gap=2)
    s0, s1 = tx.init(tp), tx.init(tp)
    js = j_make("apollo", 1e-2, rank=8).init(jp)
    jproj = jax_flat(js.extra["proj"])
    for k, p in s0.extra["proj"].items():
        assert tuple(p.shape) == jproj[k].shape
        torch.testing.assert_close(p, s1.extra["proj"][k], rtol=0, atol=0)
        if p.numel():  # N(0, 1) / sqrt(r)
            assert abs(float(p.std()) * np.sqrt(8) - 1) < 0.1, k
    other = TCore.make_optimizer("apollo", 1e-2, rank=8, seed=1).init(tp)
    k = "segments/seg0_dense/attn/wq"
    assert not torch.equal(other.extra["proj"][k], s0.extra["proj"][k])
    # steps 0 and 1 keep block 0's draw, step 2 draws block 1's
    g = {k: torch.ones_like(p) for k, p in tp.items()}
    first = s0.extra["proj"][k].clone()
    for count in range(3):
        _, s0 = tx.update(g, s0, tp)
        same = torch.equal(s0.extra["proj"][k], first)
        assert same == (count < 2), count
    _, s1 = tx.update(g, s1, tp)
    _, s1 = tx.update(g, s1, tp)
    _, s1 = tx.update(g, s1, tp)
    torch.testing.assert_close(s0.extra["proj"][k], s1.extra["proj"][k],
                               rtol=0, atol=0)


def test_refresh_reads_the_host_mirror():
    """load_opt_state sets the mirror from count; a state without one reads
    the device count once."""
    jp, tp = _model(jnp.float32)
    tx = TCore.make_optimizer("galore", 1e-2, rank=8, update_proj_gap=2)
    g = {k: torch.tensor(v) for k, v in _grads(jp, 0)[1].items()}
    s = tx.init(tp)
    _, s = tx.update(g, s, tp)  # count 0: refresh
    k = "segments/seg0_dense/attn/wq"
    loaded = load_opt_state(opt_state_to_flat(s), tp, tx, device="cpu")
    assert loaded.host_count.n == 1
    before = loaded.extra["proj"][k].clone()
    _, loaded = tx.update(g, loaded, tp)  # count 1: no refresh
    assert torch.equal(loaded.extra["proj"][k], before)
    bare = loaded._replace(host_count=None)
    loaded.extra["proj"][k].zero_()
    _, bare = tx.update(g, bare, tp)  # count 2: refresh, from int(count)
    assert bare.host_count.n == 3
    assert loaded.extra["proj"][k].abs().sum() > 0
