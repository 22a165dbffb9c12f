"""The port's optimizer kernels 7-10 (their plain PyTorch versions, which
the wrappers run on CPU tensors) against the JAX package's TPU kernels run
in interpret mode, on the same inputs made with numpy from a seed.

Kernels: ``colnorm.norm_sumsq``, ``norm_apply``, ``update_apply`` and
``scale_head.momentum_sumsq``, on ragged 2-D and stacked 3-D shapes, col
and row, f32 and bf16 operands, with and without a gscale, and bf16
momentum storage. Tolerances, per element:
  * f32 sums of squares: 1e-6 relative — both sides sum positive f32
    terms, in other orders;
  * f32 element-wise outputs: 2 f32 ulps of the largest term of the
    formula (|out| for norm_apply; |theta| + |lr*gscale*g/norm| for
    update_apply; |beta*m| + |(1-beta)*gscale*g| for the EMA): the JAX
    side's compiled division and its FMA-contracted EMA round once or
    twice differently from the port's separate IEEE operations;
  * bf16 outputs: 1 bf16 ulp of the same scale (one rounding of f32
    values that may differ in their last bits).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.colnorm import colnorm as JC  # noqa: E402
from repro.kernels.scale_head import scale_head as JH  # noqa: E402
from repro_torch.kernels.colnorm import colnorm as TC  # noqa: E402
from repro_torch.kernels.colnorm import ref as TR  # noqa: E402
from repro_torch.kernels.scale_head import scale_head as TH  # noqa: E402

SHAPES = {"2d_50x257": (50, 257), "3d_3x77x129": (3, 77, 129),
          "3d_2x300x64": (2, 300, 64)}
AXES = ("col", "row")
GSCALES = {"nogs": None, "gs0.37": 0.37}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32 and bf16 unit roundoff scaled to the spacing at a value: an ulp of x
# is 2**(floor(log2 |x|) - mantissa bits)
_MANT = {"f32": 23, "bf16": 7}


def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


def _inputs(shape, seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _pair(a, dt):
    """The same numbers as a canonical (L, m, n) JAX array and torch tensor."""
    j = JC._canon3(jnp.asarray(a).astype(DT[dt][0]))
    t = TC.canon3(torch.tensor(a).to(DT[dt][1]))
    return j, t


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_within(got, want, scale, dt, ulps):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = np.abs(got - want)
    tol = ulps * _ulp(scale, dt)
    assert (err <= tol).all(), (f"max err {err.max():.3e}, worst err/tol "
                                f"{(err / tol).max():.2f}")


def _gs_np(gscale):
    return np.float32(1.0 if gscale is None else gscale)


@pytest.mark.parametrize("gs", list(GSCALES))
@pytest.mark.parametrize("dt", list(DT))
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_norm_sumsq_matches_jax(shape, axis, dt, gs):
    (g,) = _inputs(SHAPES[shape], 0, 1)
    jg, tg = _pair(g, dt)
    gscale = GSCALES[gs]
    want = JC.norm_sumsq(jg, axis, interpret=True,
                         gscale=1.0 if gscale is None else gscale)
    before = TC.norm_sumsq.launches
    got = TC.norm_sumsq(tg, axis, gscale=gscale)
    assert TC.norm_sumsq.launches == before  # CPU: plain version, no launch
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("gs", list(GSCALES))
@pytest.mark.parametrize("dts", ["f32", "bf16", "bf16->f32"])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_norm_apply_matches_jax(shape, axis, dts, gs):
    dt, out = (dts.split("->") + [None])[:2]
    g, _, _ = _inputs(SHAPES[shape], 1)
    jg, tg = _pair(g, dt)
    gscale = GSCALES[gs]
    ss = JC.norm_sumsq(jg, axis, interpret=True)
    want = JC.norm_apply(jg, ss, axis, interpret=True,
                         gscale=1.0 if gscale is None else gscale,
                         out_dtype=DT[out][0] if out else None)
    got = TC.norm_apply(tg, torch.tensor(np.asarray(ss)), axis,
                        gscale=gscale, out_dtype=DT[out][1] if out else None)
    assert got.dtype == (DT[out or dt][1])
    _assert_within(got, want, _np(want), out or dt, 2 if (out or dt) == "f32"
                   else 1)


@pytest.mark.parametrize("gs", list(GSCALES))
@pytest.mark.parametrize("dts", ["f32", "bf16", "bf16+f32g"])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_update_apply_matches_jax_in_place(shape, axis, dts, gs):
    tdt = "bf16" if dts.startswith("bf16") else "f32"
    gdt = "f32" if dts in ("f32", "bf16+f32g") else "bf16"
    g, th, _ = _inputs(SHAPES[shape], 2)
    jg, tg = _pair(g, gdt)
    jt, tt = _pair(th, tdt)
    gscale = GSCALES[gs]
    lr = 0.01
    ss = JC.norm_sumsq(jg, axis, interpret=True,
                       gscale=1.0 if gscale is None else gscale)
    want = JC.update_apply(jt, jg, ss, lr, axis, interpret=True,
                           gscale=1.0 if gscale is None else gscale)
    ptr = tt.data_ptr()
    got = TC.update_apply(tt, tg, torch.tensor(np.asarray(ss)), lr, axis,
                          gscale=gscale)
    assert got is tt and tt.data_ptr() == ptr  # written in place
    step = np.abs(lr * _gs_np(gscale) * _np(jg)
                  / (np.sqrt(_np(ss)) + 1e-8))
    _assert_within(got, want, np.abs(_np(jt)) + step, tdt,
                   2 if tdt == "f32" else 1)


@pytest.mark.parametrize("gs", list(GSCALES))
@pytest.mark.parametrize("dts", ["f32", "f32m+bf16g", "bf16"])
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_momentum_sumsq_matches_jax_in_place(shape, axis, dts, gs):
    mdt = "bf16" if dts == "bf16" else "f32"
    gdt = "f32" if dts == "f32" else "bf16"
    g, m, _ = _inputs(SHAPES[shape], 3)
    jg, tg = _pair(g, gdt)
    jm, tm = _pair(m, mdt)
    gscale, beta = GSCALES[gs], 0.9
    want_m, want_ss = JH.momentum_sumsq(
        jm, jg, beta, axis, interpret=True,
        gscale=1.0 if gscale is None else gscale)
    ptr = tm.data_ptr()
    got_m, got_ss = TH.momentum_sumsq(tm, tg, beta, axis, gscale=gscale)
    assert got_m is tm and tm.data_ptr() == ptr and tm.dtype == DT[mdt][1]
    terms = (np.abs(np.float32(beta) * _np(jm))
             + np.abs(np.float32(0.1) * _gs_np(gscale) * _np(jg)))
    _assert_within(got_m, want_m, terms, mdt, 2 if mdt == "f32" else 1)
    # ss sums the pre-cast f32 m': the same 1e-6 bound on both routes
    # (its terms differ in their last bits where the EMAs do)
    np.testing.assert_allclose(_np(got_ss), _np(want_ss), rtol=1e-6, atol=0)


def test_head_update_apply_is_update_apply_without_gscale():
    g, th, _ = _inputs((40, 70), 4)
    tg, tt = torch.tensor(g)[None], torch.tensor(th)[None]
    ss = TR.norm_sumsq_ref(tg, "col")
    want = TR.update_apply_ref(tt.clone(), tg, ss, 0.01, "col")
    before = TC.update_apply.launches
    got = TH.head_update_apply(tt, tg, ss, 0.01, "col")
    assert got is tt and torch.equal(got, want)
    assert TC.update_apply.launches == before


@pytest.mark.parametrize("shape", [(24, 2048, 5461), (24, 5461, 2048),
                                   (1, 32000, 2048), (1, 2048, 32000),
                                   (3, 77, 129), (1, 1, 1), (1, 7, 100000)])
@pytest.mark.parametrize("axis", AXES)
def test_split_plan_covers_the_reduce_axis(shape, axis):
    """The CUDA reductions' split: S ranges of ``chunk`` cover the reduce
    axis exactly, none empty, at most 64 terms per lane, within the grid."""
    L, m, n = shape
    S, chunk = TC.split_plan(axis, L, m, n)
    red, lanes = (m, 8) if axis == "col" else (n, 32)
    assert 1 <= S <= 65535
    assert (S - 1) * chunk < red <= S * chunk
    assert chunk <= 64 * lanes or S == 65535
    assert TC.split_plan(axis, L, m, n) == (S, chunk)  # shape alone decides


def test_llama1b_tok_embed_col_split_fills_the_card():
    S, _ = TC.split_plan("col", 1, 32000, 2048)
    assert 64 * S >= 132 * 4  # 64 column tiles alone would use 16 SMs


@pytest.mark.parametrize("bad", ["axis", "ndim"])
def test_wrappers_reject_bad_arguments(bad):
    g = torch.ones(2, 3, 4)
    with pytest.raises(ValueError):
        if bad == "axis":
            TC.norm_sumsq(g, "diag")
        else:
            TC.norm_sumsq(g[0], "col")
