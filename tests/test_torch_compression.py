"""The port's column-wise int8 gradient compression
(``repro_torch.core.compression``) against the JAX package's: the int8
payload and the per-column scales bitwise equal (the same f32 operations;
``torch.round`` and ``jnp.round`` both round half to even), the
round trip bitwise equal in f32 and bf16, the wire ratio equal, and a
``compressed`` SCALE step on the tiny model of ``test_torch_scale.py``
within that file's SCALE tolerance (8 f32 ulps of the element's peak).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as JC  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro_torch.core import compression as TC  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_scale import _grads, _model, _np, _ulp, jax_flat  # noqa: E402

SHAPES = {"matrix": (64, 33), "stacked": (2, 40, 17), "vector": (50,)}


def _g(shape, dt):
    g = np.random.default_rng(len(shape)).standard_normal(shape).astype(
        np.float32)
    g[..., 0] = 0.0                       # an all-zero column (matrices)
    g.reshape(-1)[:4] = [0.5, 1.5, -2.5, 127.0]  # ties under the scale
    return jnp.asarray(g).astype(dt), torch.tensor(g).to(getattr(torch, dt))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_compress_roundtrip_matches_jax(shape, dt):
    jg, tg = _g(SHAPES[shape], dt)
    jc, tc = JC.compress_leaf(jg), TC.compress_leaf(tg)
    assert tc.q.dtype == torch.int8 and tuple(tc.scale.shape) == \
        tuple(jc.scale.shape)
    np.testing.assert_array_equal(tc.q.numpy(), np.asarray(jc.q))
    np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
    back = TC.decompress({"g": tc}, {"g": tg})["g"]
    want = JC.decompress_leaf(jc, jg.dtype)
    assert back.dtype == tg.dtype
    np.testing.assert_array_equal(_np(back), _np(want))
    assert TC.compression_ratio({"g": tg}) == JC.compression_ratio(
        {"g": jg})


def test_compressed_scale_step_matches_jax():
    jp, tp = _model(jnp.float32)
    jtx, ttx = JC.compressed(j_make("scale", 1e-2)), TC.compressed(
        t_make("scale", 1e-2))
    assert ttx.update_params is None
    jg, gflat = _grads(jp, 0)
    ju, _ = jtx.update(jg, jtx.init(jp), jp)
    tu, _ = ttx.update({k: torch.tensor(v) for k, v in gflat.items()},
                       ttx.init(tp), tp)
    for k, w in jax_flat(ju).items():
        assert (np.abs(_np(tu[k]) - w) <= 8 * _ulp(w, jnp.float32)).all(), k
    assert jax.tree_util.tree_structure(ju) is not None
