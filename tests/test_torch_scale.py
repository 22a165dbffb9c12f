"""The port's SCALE optimizer (``repro_torch.core``) against the JAX
package's on the same inputs: a tiny ragged LLaMA whose params cross by
``load_flat``, numpy grads from a seed, three steps through ``update`` +
``apply_updates`` and through ``update_params``, for ``impl="jnp"`` on
both sides and ``impl="fused"`` on both sides (the JAX kernels in
interpret mode, the port's kernels through their plain versions on CPU
tensors). The optimizer state crosses by ``load_opt_state``.

Tolerances, per element, with ``ulp(x)`` the spacing of the dtype at x:
  * params: ``ulps * ulp(peak)``, where ``peak`` is the largest of
    |value| and |step change| the element took over the JAX trajectory
    (a rounding that differs at any step persists at that step's scale),
    with 8 ulps in f32, about two a step (the two sides sum squares in
    other orders, XLA contracts the EMA into FMAs and its pow differs from
    torch's in the last bit: the step differs by an ulp and the add then
    rounds differently) and 1 ulp in bf16 (those f32 differences flip a
    rounding at most once);
  * state (momentum, Adam moments): ``ulps * ulp(max |ref| of the leaf)``,
    4 ulps in f32 and 1 in bf16; the EMA of random grads can cancel toward zero,
    so the leaf's scale, not the element's, is the measure;
  * under bf16 momentum on the fused route the apply reads the stored
    bf16 momentum, whose rounding flips where the two sides' f32 EMAs
    differ in their last bit: the head's params get, on top, one bf16 ulp
    of their largest step change per step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_arch  # noqa: E402
from repro.core import apply_updates as j_apply  # noqa: E402
from repro.core import global_norm as j_global_norm  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core import labels as JLab  # noqa: E402
from repro.core import normalization as JN  # noqa: E402
from repro.core import schedules as JS  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.kernels import dispatch as JD  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import core as TCore  # noqa: E402
from repro_torch.core import labels as TLab  # noqa: E402
from repro_torch.core import normalization as TN  # noqa: E402
from repro_torch.core import schedules as TS  # noqa: E402
from repro_torch.core.pipeline import Stages, jax_mul  # noqa: E402
from repro_torch.kernels import dispatch as TD  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import (load_flat, load_opt_state,  # noqa: E402
                                        opt_state_to_flat)

JCFG = dataclasses.replace(get_arch("llama-60m"), n_layers=2, d_model=64,
                           n_heads=4, n_kv_heads=4, d_ff=173,
                           vocab_size=1000)
STEPS = 3
_MANT = {jnp.float32: 23, jnp.bfloat16: 7}
_T = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _ulp(x, jdt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[jdt])


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def jax_flat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p): np.asarray(x.astype(jnp.float32)) for p, x in leaves}


def jax_state_flat(state) -> dict:
    """JAX PipeState -> {"count", "mu/<path>", "nu/<path>"} as path_str
    writes it (with the NamedTuple's leading '.')."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {path_str(p): np.asarray(x.astype(jnp.float32))
            if x.dtype != jnp.int32 else np.asarray(x) for p, x in leaves}


def _model(jdt):
    jcfg = dataclasses.replace(JCFG, dtype=jnp.dtype(jdt).name)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    tp = flatten(load_flat(jax_flat(jp), tcfg, device="cpu"))
    return jp, tp


def _grads(jp, step):
    rng = np.random.default_rng(100 + step)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in jax_flat(jp).items()}
    jg = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(flat[path_str(p)]).astype(x.dtype), jp)
    return jg, flat


def _track(track, new, old):
    """Elementwise (peak, step) along a trajectory: the largest |value| or
    |step change|, and the largest |step change|."""
    new, old = jax_flat(new), jax_flat(old)
    out = {}
    for k, v in new.items():
        peak, step = track.get(k, (np.abs(old[k]), 0.0))
        d = np.abs(v - old[k])
        out[k] = (np.maximum(peak, np.maximum(np.abs(v), d)),
                  np.maximum(step, d))
    return out


def _assert_params_close(got: dict, want, track, jdt, bf16_mu=()):
    ulps = 8 if jdt == jnp.float32 else 1
    for k, w in jax_flat(want).items():
        err = np.abs(_np(got[k]) - w)
        peak, step = track[k]
        tol = ulps * _ulp(peak, jdt)
        if k in bf16_mu:  # the fused apply reads the bf16-stored momentum
            tol = tol + STEPS * _ulp(step, jnp.bfloat16)
        assert (err <= tol).all(), (k, float(err.max()),
                                    float((err / tol).max()))


def _assert_state_close(got, want, mdt):
    got, want = opt_state_to_flat(got), jax_state_flat(want)
    want = {k.lstrip("."): v for k, v in want.items()}
    assert set(got) == set(want)
    assert got["count"] == want["count"]
    for k, w in want.items():
        if k == "count" or not w.size:
            assert got[k].shape == w.shape
            continue
        jdt = mdt if k.startswith("mu/") and w.ndim >= 2 else jnp.float32
        ulps = 4 if jdt == jnp.float32 else 1
        tol = ulps * _ulp(np.abs(w).max(), jdt)
        err = np.abs(got[k] - w)
        assert (err <= tol).all(), (k, float(err.max()), float(tol))


# name -> (optimizer name, kwargs, param dtype, grad_scale)
CASES = {
    "col": ("scale", {}, jnp.float32, None),
    "row": ("scale", {"norm_rest": "row"}, jnp.float32, None),
    "larger": ("scale", {"norm_last": "larger", "norm_rest": "larger"},
               jnp.float32, None),
    "lr_scaling": ("scale", {"lr_scaling": True}, jnp.float32, None),
    "mmt_matrix": ("scale", {"momentum_on": ("last", "matrix")},
                   jnp.float32, None),
    "bf16_momentum": ("scale", {"momentum_dtype": "bfloat16"}, jnp.float32,
                      None),
    "adapm": ("adapm", {}, jnp.float32, None),
    "schedule": ("scale", {"lr": "warmup_cosine"}, jnp.float32, None),
    "bf16": ("scale", {}, jnp.bfloat16, None),
    "bf16_grad_scale": ("scale", {}, jnp.bfloat16, 0.37),
}


def _build(case, impl):
    name, kw, _, _ = CASES[case]
    kw = dict(kw)
    lr = kw.pop("lr", 1e-2)
    if lr == "warmup_cosine":  # step 0 warms up, steps 1-2 decay
        jlr, tlr = (JS.linear_warmup_cosine(1e-2, 4),
                    TS.linear_warmup_cosine(1e-2, 4))
    else:
        jlr = tlr = lr
    if impl == "fused":
        kw["impl"] = "fused"
    return j_make(name, jlr, **kw), TCore.make_optimizer(name, tlr, **kw)


@pytest.mark.parametrize("entry", ["update", "update_params"])
@pytest.mark.parametrize("impl", ["jnp", "fused"])
@pytest.mark.parametrize("case", list(CASES))
def test_scale_matches_jax_after_three_steps(case, impl, entry):
    _, kw, jdt, gs = CASES[case]
    jtx, ttx = _build(case, impl)
    jp, tp = _model(jdt)
    track = {}
    js, ts = jtx.init(jp), ttx.init(tp)
    j_gs = None if gs is None else jnp.asarray(gs, jnp.float32)
    t_gs = None if gs is None else torch.tensor(gs, dtype=torch.float32)
    for step in range(STEPS):
        jg, gflat = _grads(jp, step)
        tg = {k: torch.tensor(v).to(_T[jdt]) for k, v in gflat.items()}
        j_old = jp
        if entry == "update_params":
            jp, js = jtx.update_params(jg, js, jp, grad_scale=j_gs)
            ptrs = {k: t.data_ptr() for k, t in tp.items()}
            tp, ts = ttx.update_params(tg, ts, tp, grad_scale=t_gs)
            assert {k: t.data_ptr() for k, t in tp.items()} == ptrs
        else:
            if gs is not None:  # the trainer's clip tree-map, JAX promotion
                jg = jax.tree_util.tree_map(lambda g: g * j_gs, jg)
                tg = {k: jax_mul(g, t_gs) for k, g in tg.items()}
            ju, js = jtx.update(jg, js, jp)
            tu, ts = ttx.update(tg, ts, tp)
            for k, u in jax.tree_util.tree_flatten_with_path(ju)[0]:
                assert tu[path_str(k)].dtype == _T[u.dtype.type]
            jp, tp = j_apply(jp, ju), TCore.apply_updates(tp, tu)
        track = _track(track, jp, j_old)
    mdt = jnp.bfloat16 if kw.get("momentum_dtype") == "bfloat16" \
        else jnp.float32
    bf16_mu = ({k for k, v in jax_flat(js.mu).items() if v.ndim >= 2}
               if mdt == jnp.bfloat16 and impl == "fused" else ())
    _assert_params_close(tp, jp, track, jdt, bf16_mu)
    _assert_state_close(ts, js, mdt)


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["jnp", "fused"])
def test_init_state_is_a_fixed_point_of_update(impl, mdt):
    jp, tp = _model(jnp.bfloat16)
    tx = TCore.make_optimizer("scale", 1e-2, impl=impl, momentum_dtype=mdt)
    s0 = tx.init(tp)
    spec = {k: (tuple(x.shape), x.dtype)
            for k, x in opt_state_to_flat_like(s0).items()}
    _, gflat = _grads(jp, 0)
    tg = {k: torch.tensor(v).to(torch.bfloat16) for k, v in gflat.items()}
    _, s1 = tx.update(tg, s0, tp)
    _, s2 = tx.update_params(tg, s1, tp, grad_scale=torch.tensor(0.5))
    for s in (s1, s2):
        assert {k: (tuple(x.shape), x.dtype)
                for k, x in opt_state_to_flat_like(s).items()} == spec
    assert int(s2.count) == 2
    # and the layout is JAX's, placeholders included
    js = j_make("scale", 1e-2, momentum_dtype=mdt).init(jp)
    jspec = {k.lstrip("."): (tuple(v.shape), str(v.dtype)) for k, v in
             ((path_str(p), x) for p, x in
              jax.tree_util.tree_flatten_with_path(js)[0])}
    assert {k: (s, str(d).replace("torch.", "")) for k, (s, d)
            in spec.items()} == jspec


def opt_state_to_flat_like(state):
    return {"count": state.count,
            **{f"mu/{k}": x for k, x in state.mu.items()},
            **{f"nu/{k}": x for k, x in state.nu.items()}}


def test_state_bridge_roundtrips_jax_state():
    """A JAX state after a step (bf16 momentum) crosses exactly, with
    path_str's own keys, and comes back as the same numbers."""
    jp, tp = _model(jnp.bfloat16)
    jtx = j_make("scale", 1e-2, momentum_dtype="bfloat16")
    jg, _ = _grads(jp, 0)
    _, js = jtx.update(jg, jtx.init(jp), jp)
    flat = jax_state_flat(js)
    assert "." in "".join(flat)  # NamedTuple keys as path_str gives them
    ttx = TCore.make_optimizer("scale", 1e-2, momentum_dtype="bfloat16")
    ts = load_opt_state(flat, tp, ttx, device="cpu")
    assert ts.mu["lm_head/w"].dtype == torch.bfloat16
    assert ts.mu["tok_embed/w"].shape == (0,)
    back = opt_state_to_flat(ts)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k.lstrip(".")], v)
    with pytest.raises(KeyError):
        load_opt_state({"count": flat[".count"]}, tp, ttx, device="cpu")


def test_jax_mul_promotes_as_jax_does():
    """bf16 g times an f32 0-d array is f32 in JAX (torch keeps bf16); a
    Python number is weakly typed in JAX and keeps g's dtype."""
    g = np.random.default_rng(5).standard_normal((4, 33)).astype(np.float32)
    jg, tg = jnp.asarray(g).astype(jnp.bfloat16), torch.tensor(g).bfloat16()
    s = np.float32(0.37)
    assert (tg * torch.tensor(s)).dtype == torch.bfloat16  # torch's own rule
    for js, ts in ((jnp.asarray(s), torch.tensor(s)), (0.37, 0.37)):
        want = jg * js
        got = jax_mul(tg, ts)
        assert got.dtype == _T[want.dtype.type]
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("rules", ["default", "tied"])
def test_labels_match_jax(rules):
    jp, tp = _model(jnp.float32)
    jr, tr = ((JLab.LabelRules(), TLab.LabelRules()) if rules == "default"
              else (JLab.LabelRules.tied(), TLab.LabelRules.tied()))
    want = {path_str(p): lab for p, lab in jax.tree_util.tree_flatten_with_path(
        JLab.label_tree(jp, jr))[0]}
    assert TLab.label_tree(tp, tr) == want
    want_t = {path_str(p): t for p, t in jax.tree_util.tree_flatten_with_path(
        JLab.transposed_tree(jp, jr))[0]}
    assert TLab.transposed_tree(tp, tr) == want_t
    tied_cfg = {"tok_embed/w": tp["tok_embed/w"], "final_norm/s":
                tp["final_norm/s"]}
    with pytest.raises(ValueError):
        TLab.label_tree(tied_cfg, require_last=True)


@pytest.mark.parametrize("sched", ["constant", "warmup_cosine"])
def test_schedules_match_jax(sched):
    if sched == "constant":
        jf, tf = JS.constant(3e-4), TS.constant(3e-4)
    else:
        jf, tf = (JS.linear_warmup_cosine(1e-3, 50),
                  TS.linear_warmup_cosine(1e-3, 50))
    for step in range(0, 60, 3):
        got = tf(torch.tensor(step, dtype=torch.int32))
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        assert got.dtype == torch.float32 and got.shape == ()
        # f32 arithmetic on both sides; cos may differ in its last bit
        np.testing.assert_allclose(got.numpy(), want, rtol=2.5e-7, atol=0)


def test_global_norm_matches_jax():
    jp, tp = _model(jnp.bfloat16)
    got = TCore.global_norm(tp)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(j_global_norm(jp)),
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["col", "row", "larger", "none"])
def test_normalization_matches_jax(kind):
    g = np.random.default_rng(6).standard_normal((3, 40, 29)).astype(
        np.float32)
    k = TN.resolve_larger(kind, g.shape)
    assert k == JN.resolve_larger(kind, g.shape)
    assert TN.flip_kind(kind) == JN.flip_kind(kind)
    got, want = TN.normalize(torch.tensor(g), k), JN.normalize(
        jnp.asarray(g), k)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-7)
    assert TN.resolve_larger("larger", (8, 8)) == "col"


@pytest.mark.parametrize("kind", ["sign", "ns", "svd"])
def test_unported_norm_kinds_raise(kind):
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        TN.normalize(torch.ones(4, 4), kind)


# dispatch: kernel entry points (plain versions on CPU) against JAX's
# dispatch (interpret mode); the 4-D leaf is outside kernel coverage and
# takes the plain oracle on both sides
DISPATCH_SHAPES = {"3d": (2, 37, 65), "4d": (2, 2, 9, 17)}


def _dispatch_inputs(shape):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("op", ["normalize", "norm_update", "momentum_norm",
                                "momentum_norm_update"])
@pytest.mark.parametrize("shape", list(DISPATCH_SHAPES))
def test_dispatch_matches_jax(op, shape):
    sh = DISPATCH_SHAPES[shape]
    assert TD.supported(sh, "col") == JD.supported(sh, "col")
    g, th, m = _dispatch_inputs(sh)
    jg, jt, jm = map(jnp.asarray, (g, th, m))
    tg, tt, tm = map(torch.tensor, (g, th, m))
    kw = dict(gscale=0.5)
    if op == "normalize":
        want, got = (JD.normalize(jg, "larger", **kw),
                     TD.normalize(tg, "larger", **kw))
        outs = [(got, want)]
    elif op == "norm_update":
        want = JD.norm_update(jt, jg, 0.01, "row", **kw)
        got = TD.norm_update(tt, tg, 0.01, "row", **kw)
        assert got is tt
        outs = [(got, want)]
    elif op == "momentum_norm":
        (wm, wd), (gm, gd) = (JD.momentum_norm(jm, jg, 0.9, "col", **kw),
                              TD.momentum_norm(tm, tg, 0.9, "col", **kw))
        assert gm is tm
        outs = [(gm, wm), (gd, wd)]
    else:
        (wt, wm), (gt, gm) = (
            JD.momentum_norm_update(jt, jm, jg, 0.9, 0.01, "col", **kw),
            TD.momentum_norm_update(tt, tm, tg, 0.9, 0.01, "col", **kw))
        assert gt is tt and gm is tm
        outs = [(gt, wt), (gm, wm)]
    for got, want in outs:
        assert got.shape == tuple(want.shape)
        # f32: sums in other orders, XLA's FMA-contracted EMA
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-6, atol=2e-7)


def test_make_optimizer_registry():
    assert TCore.OPTIMIZER_NAMES == ("scale", "scale_fused", "adapm")
    for name in TCore.OPTIMIZER_NAMES:
        assert (TCore.OPTIMIZER_REGISTRY[name].defaults
                == __import__("repro.core", fromlist=["x"])
                .OPTIMIZER_REGISTRY[name].defaults)
    for name in ("adam", "nonesuch"):
        with pytest.raises(KeyError, match="ported: scale, scale_fused"):
            TCore.make_optimizer(name)
    with pytest.raises(ValueError, match="unknown kwarg"):
        TCore.make_optimizer("scale", 1e-3, nesterov=True)
    with pytest.raises(ValueError, match="Queue 1 item 8"):
        Stages(nesterov=True)
