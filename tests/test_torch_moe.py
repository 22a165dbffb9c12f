"""The MoE family in the port against the JAX package: ``apply_moe``, the
``moe`` super-block and its aux loss, training and serving.

Inputs are made with numpy from a seed and handed to both sides; params
cross over through ``load_flat``. Torch runs on one intra-op thread (see
``tests/test_torch_optimizers.py``).

``apply_moe`` alone gets dyadic activations and router weights (small
integers over powers of two), so the router logits are exact on both
sides whatever the order of the sums and the two sides route every
(token, choice) pair alike; exactly tied logits (duplicated router
columns) then tie exactly, and must pick JAX's experts (the lower index
first). The expert weights are normal. Tolerances, per element:
  * f32 output and aux: 1e-5 absolute + 1e-5 relative (unit-scale sums of
    32 and 48 products in other orders; observed 4.8e-7 absolute);
  * f32 gradients: 1e-5 of the leaf's largest |ref| + 1e-5 relative
    (observed 4.5e-7 of it);
  * bf16 output: 2e-2 + 2e-2 * |ref|, as ``tests/test_torch_model.py``
    (the experts' bf16 products and SiLU round at other places; observed
    3.1e-2 absolute on an output of 2.4); aux, computed in f32 from exact
    logits: 1e-6 relative (observed 1.1e-7);
  * bf16 gradients: 2e-2 of the leaf's largest |ref| + 2e-2 relative
    (each side rounds every product of the backward to bf16 at its own
    places; observed 8.8e-3 of the largest).

The model: dbrx-132b's ``SMOKE`` (f32, 4 experts top-2, cf 2.0) and a tiny
config with ``first_dense_layers=1`` (a dense segment, then an MoE one)
and a shared expert, from JAX's ``init_params``. Its hidden states, loss
and gradients are f32 sums in other orders through whole layers: 1e-4
absolute for hidden and logits (``tests/test_torch_serving.py``; observed
1.5e-6), 1e-5 relative for the loss and aux (observed 1.2e-7), 1e-5 of
each leaf's largest |gradient| (observed 9.0e-7, the router's).
The training steps keep ``tests/test_torch_trainer.py``'s tolerances and
reasons (f32).
"""
import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.sharding import Rules as JRules  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten, unflatten  # noqa: E402
from repro_torch.models.weights import (load_flat,  # noqa: E402
                                        opt_state_to_flat)
from repro_torch.training import (init_state, make_eval_step,  # noqa: E402
                                  make_train_step)
from repro_torch.training import serving as TS  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
_MANT = {"float32": 23, "bfloat16": 7}


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


def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


# ----------------------------------------------------------- apply_moe

B, S = 2, 24  # T = 48 tokens
# case -> ModelConfig overrides; "tie" duplicates router columns
MOE_CASES = {
    "base": {},                        # one group of 48, C 30
    "drop_cf1": {"capacity_factor": 1.0},   # C 24: tokens drop
    # G 3 groups of 16, C 8: drops counted per group
    "groups16": {"moe_group_size": 16, "capacity_factor": 1.0},
    "shared": {"n_shared_experts": 1},
    "tied": {"tie": True},
}


def _moe_case(case, dtype, seed=0):
    kw = dict(MOE_CASES[case])
    tie = kw.pop("tie", False)
    jcfg = tiny_cfg("moe", family="moe", d_model=32, n_experts=4, top_k=2,
                    moe_d_ff=48, dtype={"f32": "float32",
                                        "bf16": "bfloat16"}[dtype], **kw)
    D, E, Fd = jcfg.d_model, jcfg.n_experts, jcfg.moe_d_ff
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, S, D)) * 4) / 4
    router = np.round(rng.standard_normal((D, E)) * 8) / 64
    if tie:
        router[:, 3] = router[:, 1]
    p = {"router": router,
         "w_gate": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
         "w_up": rng.standard_normal((E, D, Fd)) / np.sqrt(D),
         "w_down": rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)}
    if jcfg.n_shared_experts:
        Fs = Fd * jcfg.n_shared_experts
        p.update(shared_gate=rng.standard_normal((D, Fs)) / np.sqrt(D),
                 shared_up=rng.standard_normal((D, Fs)) / np.sqrt(D),
                 shared_down=rng.standard_normal((Fs, D)) / np.sqrt(Fs))
    r = rng.standard_normal((B, S, D)).astype(np.float32)
    jd, td = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jnp.float32).astype(jd) for k, v in p.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32).to(td)
          for k, v in p.items()}
    jx = jnp.asarray(x, jnp.float32).astype(jd)
    tx = torch.tensor(x, dtype=torch.float32).to(td)
    return jcfg, _tcfg(jcfg), (jp, jx), (tp, tx), r


def _routing(cfg, x, router):
    """(top_i, keep, probs) of the layer's own routing, ``moe_route``."""
    G, Tg, _ = TL.moe_groups(cfg, x.shape[0] * x.shape[1])
    probs, _, top_i, _, keep = TL.moe_route({"router": router}, cfg,
                                            x.reshape(G, Tg, -1))
    return top_i, keep, probs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_jax(case, dtype):
    """Output, aux, and the gradients of x, the router and every expert
    leaf of sum(y * r) + aux against JAX's ``apply_moe``."""
    jcfg, tcfg, (jp, jx), (tp, tx), r = _moe_case(case, dtype)
    f32 = dtype == "f32"

    def jloss(p, x):
        y, aux = JL.apply_moe(p, jcfg, x, JRules())
        return jnp.sum(y.astype(jnp.float32) * r) + aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jx)

    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = tx.clone().requires_grad_()
    y, aux = TL.apply_moe(leaves, tcfg, x)
    assert y.dtype == tx.dtype and aux.dtype == torch.float32
    total = (y.float() * torch.from_numpy(r)).sum() + aux
    grads = torch.autograd.grad(total, [x, *leaves.values()])

    if f32:
        np.testing.assert_allclose(_np(y), _np(jy), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(_np(aux), _np(jaux), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(y), _np(jy), atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(_np(aux), _np(jaux), rtol=1e-6)
    want = {"x": jgx, **jgp}
    for name, g in zip(["x", *leaves], grads):
        w = _np(want[name])
        scale = np.abs(w).max()
        tol = ((1e-5 * scale + 1e-5 * np.abs(w)) if f32
               else (2e-2 * scale + 2e-2 * np.abs(w)))
        err = np.abs(_np(g) - w)
        assert g.dtype == tx.dtype and (err <= tol).all(), (
            name, float(err.max() / scale))

    top_i, keep, probs = _routing(tcfg, tx, tp["router"])
    if case in ("drop_cf1", "groups16"):
        assert not keep.all()  # some (token, choice) pairs dropped
    elif case in ("base", "tied"):
        assert keep.all()
    if case == "tied":
        # experts 1 and 3 tie exactly; where a tie sits in the top k, the
        # lower index comes first, as jax.lax.top_k has it
        top_p = probs.gather(-1, top_i)
        ties = top_p[..., 0] == top_p[..., 1]
        assert ties.any()
        assert (top_i[..., 0][ties] < top_i[..., 1][ties]).all()
        srt = probs.sort(-1, descending=True).values
        assert (srt[..., 1] == srt[..., 2]).any()  # ties across the cut


def test_apply_moe_group_layout():
    """The group count and capacity are JAX's Python arithmetic."""
    for T, gs, cf, k, E in ((48, 2048, 1.25, 2, 4), (48, 16, 1.25, 2, 4),
                            (4096, 2048, 1.25, 4, 16), (4, 2048, 1.25, 4, 16),
                            (4, 2048, 4.0, 4, 16), (50, 16, 1.0, 2, 4)):
        cfg = tconfig.ModelConfig(family="moe", n_experts=E, top_k=k,
                                  capacity_factor=cf, moe_group_size=gs)
        G = max(1, T // gs)
        while T % G:
            G -= 1
        C = min(max(1, int(cf * (T // G) * k / E)), T // G)
        assert TL.moe_groups(cfg, T) == (G, T // G, C)
    dbrx = treg.get_arch("dbrx-132b")
    # chip_smoke.py phase 16's batch: 2 groups of 2048, capacity 640
    assert TL.moe_groups(dbrx, 16 * 256) == (2, 2048, 640)
    # its decode step: 4 tokens, capacity 1 at cf 1.25, 4 at cf E/k
    assert TL.moe_groups(dbrx, 4) == (1, 4, 1)
    assert TL.moe_groups(dataclasses.replace(dbrx, capacity_factor=4.0),
                         4) == (1, 4, 4)


# ------------------------------------------------------------- the model

MODEL_CFGS = {
    "dbrx_smoke": lambda: jreg.get_arch("dbrx-132b", smoke=True),
    "first_dense_shared": lambda: tiny_cfg(
        "moe_fd", family="moe", n_layers=3, first_dense_layers=1,
        n_experts=4, top_k=2, moe_d_ff=48, n_shared_experts=1,
        vocab_size=200, moe_group_size=32),
}


@functools.lru_cache(maxsize=None)
def _jax_model(name, cf=None):
    jcfg = MODEL_CFGS[name]()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    return jcfg, jp, _jflat(jp)


def _model(name, cf=None):
    """(jcfg, tcfg, JAX params, the port's copy of them: fresh tensors)."""
    jcfg, jp, flat = _jax_model(name, cf)
    tcfg = _tcfg(jcfg)
    return jcfg, tcfg, jp, load_flat(flat, tcfg, device="cpu")


_BATCHES: dict = {}


def _batches(jcfg, n, batch=4, seq=32, seed=3):
    """JAX's SyntheticLM batches as numpy (kept per config and shape)."""
    key = (repr(jcfg), n, batch, seq, seed)
    if key not in _BATCHES:
        ds = j_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed)
        _BATCHES[key] = [{k: np.array(v) for k, v in
                          ds.global_batch_at(i).items()} for i in range(n)]
    return _BATCHES[key]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_moe_forward_loss_and_grads_match_jax(name):
    """``forward`` (hidden and the summed aux) and ``loss_fn`` (total,
    loss, aux) with every gradient, against JAX's."""
    jcfg, tcfg, jp, tp = _model(name)
    assert [k for k, _ in tcfg.segments] == [k for k, _ in jcfg.segments]
    b = _batches(jcfg, 3)[0]
    jh, _, jaux = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(b["tokens"]))
    th, _, taux = TM.forward(tp, tcfg, torch.from_numpy(b["tokens"]))
    np.testing.assert_allclose(_np(th), _np(jh), atol=1e-4, rtol=0)
    assert float(jaux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)

    (jtotal, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(p, jcfg, b), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in b.items()})
    leaves = {k: p.detach().requires_grad_() for k, p in
              flatten(tp).items()}
    total, tm = TM.loss_fn(unflatten(leaves), tcfg, _t(b))
    grads = torch.autograd.grad(total, list(leaves.values()))
    np.testing.assert_allclose(_np(total), _np(jtotal), rtol=1e-5)
    for k in ("loss", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    want = _jflat(jg)
    assert set(want) == set(leaves)
    for k, g in zip(leaves, grads):
        w = want[k]
        err = np.abs(_np(g) - w)
        assert (err <= 1e-5 * np.abs(w).max()).all(), (k, float(err.max()))


@pytest.mark.parametrize("name", list(MODEL_CFGS))
def test_moe_train_steps_match_jax(name):
    """Three ``scale_fused`` steps (clip 1.0) from the same params on the
    same batches: metrics, params and optimizer state against JAX's. The
    4-D expert leaves take the pipeline's plain stage route on both sides
    (no optimizer kernel takes ndim 4)."""
    jcfg, tcfg, jp, tp = _model(name)
    assert TM.param_shapes(tcfg)[
        f"segments/seg{len(tcfg.segments) - 1}_moe/ffn/w_gate"] == (
        tcfg.segments[-1][1], tcfg.n_experts, tcfg.d_model, tcfg.moe_d_ff)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0)
    js, ts = JT.init_state(jp, jtx), init_state(tp, ttx)
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    for step, b in enumerate(_batches(jcfg, 3)):
        old = _jflat(js.params)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, _t(b))
        for k in ("loss", "grad_norm", "update_norm", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
        for k, w in _jflat(js.params).items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
            got = flatten(ts.params)[k].detach().float().numpy()
            tol = 8 * _ulp(peak[k], "float32") + 1e-5 * travel[k].max()
            err = np.abs(got - w)
            assert (err <= tol).all(), (step, k, float(err.max()))
        got_s, want_s = opt_state_to_flat(ts.opt_state), _jflat(js.opt_state)
        assert set(got_s) == set(want_s)
        for k, w in want_s.items():
            if k == "count" or not w.size:
                continue
            assert (np.abs(got_s[k] - w) <= 4e-6 * np.abs(w).max()).all(), (
                step, k)


def test_moe_aux_survives_grad_accum():
    """The port of ``tests/test_train_integration.py``'s
    ``test_grad_accum_keeps_aux_metrics``: ``aux`` is a metric at
    grad_accum 1 and 2 (the mean of the microbatches'), the halves close to
    the whole batch, and each equal to JAX's at the same accumulation."""
    jcfg = tiny_cfg("moe", family="moe", n_experts=4, top_k=2, moe_d_ff=64,
                    capacity_factor=2.0)
    tcfg = _tcfg(jcfg)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    b = _batches(jcfg, 1, batch=8, seed=0)[0]
    out = {}
    for accum in (1, 2):
        jtx, ttx = j_make("scale", 3e-3), t_make("scale", 3e-3)
        jstep = jax.jit(JT.make_train_step(jcfg, jtx, grad_accum=accum,
                                           clip_norm=1.0))
        _, jm = jstep(JT.init_state(jp, jtx),
                      {k: jnp.asarray(v) for k, v in b.items()})
        tp = load_flat(_jflat(jp), tcfg, device="cpu")
        _, tm = make_train_step(tcfg, ttx, grad_accum=accum, clip_norm=1.0)(
            init_state(tp, ttx), _t(b))
        assert "aux" in tm and "update_norm" in tm
        for k in ("aux", "loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=(accum, k))
        out[accum] = tm
    np.testing.assert_allclose(float(out[1]["aux"]), float(out[2]["aux"]),
                               atol=5e-3)
    np.testing.assert_allclose(float(out[1]["loss"]), float(out[2]["loss"]),
                               atol=1e-3)


# ------------------------------------------------------------- serving

def _serve_model(cf):
    return _model("dbrx_smoke", cf)


def test_moe_prefill_and_decode_match_jax():
    """At dbrx SMOKE's own capacity factor the decode steps see B tokens
    and drop some (C = 1 at B = 2): the same semantics as JAX's, step by
    step."""
    jcfg, tcfg, jp, tp = _serve_model(1.25)
    Bs, P, max_seq, n_dec = 2, 8, 16, 4
    assert TL.moe_groups(tcfg, Bs)[2] == 1
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
        for kv in ("k", "v"):
            np.testing.assert_allclose(
                _np(state.cache["seg0_moe"]["attn"][kv]),
                _np(jstate.cache["seg0_moe"]["attn"][kv]), atol=1e-4, rtol=0)

    check()
    for i in range(P, P + n_dec):
        t = toks[:, i:i + 1]
        jstate, jlog = jdec(jp, jstate, jnp.asarray(t))
        state, log = dec(tp, state, torch.from_numpy(t))
        check()


def test_moe_decode_matches_full_forward_at_cf_e_over_k():
    """At cf = E / k no (token, choice) is dropped, whatever the batch, so
    prefill + decode reproduces the full forward's last logits (f32)."""
    jcfg, tcfg, _, tp = _serve_model(2.0)  # E / k = 4 / 2
    Bs, Sq, P = 2, 32, 24
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (Bs, Sq), dtype=np.int32))
    with torch.no_grad():
        h, _, _ = TM.forward(tp, tcfg, toks)
        ref = TM.logits_from_hidden(tp, tcfg, h)[:, -1]
    state, logits = TS.make_prefill_step(tcfg, max_seq=Sq)(tp, toks[:, :P])
    decode = TS.make_decode_step(tcfg)
    for i in range(P, Sq):
        state, logits = decode(tp, state, toks[:, i:i + 1])
    torch.testing.assert_close(logits[:, -1], ref, atol=2e-4, rtol=0)


def test_moe_greedy_tokens_match_jax():
    jcfg, tcfg, jp, tp = _serve_model(1.25)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 8),
                                               dtype=np.int32)
    want = JS.greedy_generate(jcfg, jp, jnp.asarray(prompt), n_steps=6,
                              max_seq=16)
    got = TS.greedy_generate(tcfg, tp, prompt, n_steps=6, max_seq=16,
                             device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ the mesh

_DUCK_MESH = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(1, 1))


@pytest.mark.parametrize("arch", ["dbrx-132b", "deepseek-v3-671b"])
def test_moe_steps_build_on_a_mesh(arch):
    """Expert parallelism over "model" is ported: the SMOKE twins' train
    and eval steps build on a (duck-typed) (1, 1) mesh, each parameter
    given its sharding (``tests/test_torch_sharded_moe.py`` runs them on
    a gloo mesh)."""
    tcfg = treg.get_arch(arch, smoke=True)
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=_DUCK_MESH))
    assert callable(make_eval_step(tcfg, mesh=_DUCK_MESH))


@pytest.mark.parametrize("arch,match", [
    ("mamba2-370m", "Mamba2"),
    ("jamba-1.5-large-398b", "hybrid.*Mamba2")])
def test_unsharded_families_still_raise_on_a_mesh(arch, match):
    """Mamba2 and the hybrid (``tests/test_torch_sharded_mamba.py``) run
    sharded in modes train and prefill: their train and eval steps build,
    and forward raises in mode decode (sharded serving), naming the
    segment, before it touches a tensor. (The VLM and audio decode on a
    mesh: ``tests/test_torch_sharded_serving.py``.)"""
    tcfg = treg.get_arch(arch, smoke=True)
    tx = t_make("scale_fused", 1e-2)
    assert callable(make_train_step(tcfg, tx, mesh=_DUCK_MESH))
    assert callable(make_eval_step(tcfg, mesh=_DUCK_MESH))
    with pytest.raises(NotImplementedError, match=match + ".*item 12"):
        TM.forward(None, tcfg, None, mode="decode", mesh=_DUCK_MESH)
