"""The port's sign, Newton-Schulz and SVD normalizations and SWAN's
``swan_normalize`` against the JAX package's, on 2-D and stacked leaves,
with d_in <= d_out and d_in > d_out (NS works on the transpose), in f32
and bf16, the JAX side eager.

Tolerances, per element, with ``ulp(x)`` the spacing of f32 at x and M the
largest |ref| of the leaf:
  * sign: equal;
  * ns: 64 ulps of M — five Newton-Schulz steps of f32 matrix products
    summed in other orders (XLA's dot against torch's), measured at 19-33;
  * svd: 64 ulps of M — u @ vt from two LAPACK solvers (the product is
    invariant to the sign of each singular pair), measured at 12-22;
  * swan: 128 ulps of M — the standardization's mean and population
    deviation (``jnp.std``; ``torch.std(correction=0)``) sum in other
    orders before the NS steps, measured at 23-46;
  * bf16 leaves: the f32 bound plus 1 bf16 ulp of the element (each side
    rounds its f32 result once).
A stack whose slices differ in scale by 1e3 checks that each slice is
scaled by its own Frobenius norm, as JAX's ``vmap`` over slices gives.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import normalization as JN  # noqa: E402
from repro_torch.core import normalization as TN  # noqa: E402

from test_torch_optimizers import one_torch_thread  # noqa: E402,F401

JS = importlib.import_module("repro.core.swan")
TS = importlib.import_module("repro_torch.core.swan")

SHAPES = {"wide": (64, 256), "tall": (173, 64), "stacked_wide": (2, 64, 173),
          "stacked_tall": (2, 256, 64), "scaled_slices": (3, 40, 29)}
ULPS = {"sign": 0, "ns": 64, "svd": 64, "swan": 128}
FNS = {
    "sign": (JN.signnorm, TN.signnorm),
    "ns": (JN.ns_orthogonalize, TN.ns_orthogonalize),
    "svd": (JN.svd_orthogonalize, TN.svd_orthogonalize),
    "swan": (JS.swan_normalize, TS.swan_normalize),
}


def _ulp(x, mant=23):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - mant)


def _input(shape):
    g = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    if len(shape) == 3 and shape[0] == 3:
        g *= np.array([1.0, 1e3, 1e-3], np.float32)[:, None, None]
    return g


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(FNS))
def test_normalization_matches_jax(kind, shape, dt):
    g = _input(SHAPES[shape])
    jf, tf = FNS[kind]
    jg = jnp.asarray(g).astype(dt)
    tg = torch.tensor(g).to(getattr(torch, dt))
    want = np.asarray(jf(jg).astype(jnp.float32))
    got_t = tf(tg)
    assert got_t.dtype == tg.dtype and tuple(got_t.shape) == g.shape
    got = got_t.float().numpy()
    # per slice: the largest |ref| of each leading slice
    m = np.abs(want).max(axis=(-2, -1), keepdims=True)
    tol = ULPS[kind] * _ulp(m)
    if dt == "bfloat16":
        tol = tol + _ulp(want, 7)
    err = np.abs(got - want)
    assert (err <= tol).all(), (float(err.max()), float((err / np.maximum(
        tol, 1e-45)).max()))


@pytest.mark.parametrize("steps", [1, 3])
def test_ns_steps_matches_jax(steps):
    g = _input((2, 64, 173))
    want = np.asarray(JN.ns_orthogonalize(jnp.asarray(g), steps))
    got = TN.ns_orthogonalize(torch.tensor(g), steps).numpy()
    m = np.abs(want).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(got - want) <= 64 * _ulp(m)).all()


def test_normalize_names_every_kind():
    assert set(TN.NORMALIZATIONS) == set(JN.NORMALIZATIONS)
    g = torch.tensor(_input((64, 256)))
    for kind in TN.NORMALIZATIONS:
        assert TN.normalize(g, kind).shape == g.shape
    with pytest.raises(ValueError, match="unknown normalization"):
        TN.normalize(g, "nonesuch")
    with pytest.raises(ValueError, match="expects a matrix"):
        TN.ns_orthogonalize(torch.ones(4))
