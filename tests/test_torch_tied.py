"""The port's tied-embedding head (``tie_embeddings=True``) against the JAX
package, on the CPU: the LM head is the token embedding, stored (V, D),
and the loss reads it in place through the ``transposed=True`` clause of
the three xent kernels. Mirrors ``tests/test_tied.py`` less its sharded
and audio cases (ROADMAP.md Queue 1 items 12 and 13).

  * kernels: the plain ``xent_fwd`` / ``xent_bwd_dh`` / ``xent_bwd_dw``
    with ``transposed=True`` against the Pallas kernels in interpret mode
    (N 48 against a token tile of 64, D 32, V 200 with ``vocab_size`` 190,
    so that padded rows of dW exist, and labels of -1), dW (V, D) with its
    padded rows 0;
  * ``dispatch.xent_loss(transposed=True)`` and its gradients against
    JAX's ``custom_vjp``;
  * ``loss_fn`` of a two-layer tied llama (d_model 64, a vocab of 250
    padded to 256) and every gradient, the embedding's being the sum of
    the lookup's and the head's;
  * three ``make_train_step`` steps of ``scale`` and ``scale_fused`` under
    ``LabelRules.tied()`` against the JAX trainer; the untied rules on a
    tied tree raise, as in JAX;
  * the launcher's ``--tie-embeddings``: SCALE gets the tied rules and
    Adam none, as JAX's ``build``, and the port's losses follow the JAX
    launcher's from the same weights;
  * a checkpoint of a JAX-trained tied state restores into the port
    bitwise, and after one port step the port's checkpoint restores
    through ``repro.checkpoint.restore`` bitwise.

Inputs are made with numpy from a seed and handed to both sides.
Tolerances, per element unless said:
  * lse, ll, losses and f32 gradients of the kernels and of ``xent_loss``:
    2e-5 absolute + 1e-5 relative (exact f32 products summed in f32 in
    other orders), as in ``tests/test_torch_xent.py``; dh and dw written
    as bf16: 1e-5 + 8e-3 relative (one bf16 rounding on each side of f32
    sums that differ in their last bits);
  * the model: the loss 1e-4 absolute in f32, 2e-2 + 2e-2 relative in
    bf16 (``tests/test_torch_xent.py``'s model tolerances); each gradient
    leaf in f32 within 1e-4 of its largest |element| (sums of a few
    hundred f32 products through two layers; observed 4.4e-7), in bf16
    within 5e-2 relative in norm (the two sides round bf16 activations and
    gradients at other places, and at random init the attention gradients
    are sums that cancel toward zero, ROADMAP.md reference caveat 1;
    observed 9.1e-3 at worst, 3.7e-3 for the embedding);
  * the trainer: ``tests/test_torch_trainer.py``'s tolerances (the tied
    embedding is one more matrix under the same SCALE maths);
  * the launcher's printed losses (4 decimals): 2e-4 in f32 (the printed
    rounding plus f32 sums in other orders);
  * the checkpoint: bitwise.
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.core import LabelRules as JRules  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.kernels import dispatch as JK  # noqa: E402
from repro.kernels.xent import xent as JX  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
import repro_torch.checkpoint as ckpt  # noqa: E402
from repro_torch.core import LabelRules  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels import dispatch as TK  # noqa: E402
from repro_torch.kernels.xent import xent as TX  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import (load_flat,  # noqa: E402
                                        opt_state_to_flat)
from repro_torch.training import (GuardPolicy, TrainState,  # noqa: E402
                                  init_state, make_train_step,
                                  value_and_grad)
from test_torch_checkpoint import _assert_bitwise  # noqa: E402
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import _batches, _jflat, _t, _ulp  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = {"f32": "float32", "bf16": "bfloat16"}
F32_ATOL, F32_RTOL = 2e-5, 1e-5
BF16_OUT_ATOL, BF16_OUT_RTOL = 1e-5, 8e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, atol=F32_ATOL, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _out_tol(dtype):
    return (F32_ATOL, F32_RTOL) if dtype == "f32" else (BF16_OUT_ATOL,
                                                         BF16_OUT_RTOL)


# ------------------------------------------------- the kernels' plain versions

# (N, D, V, vocab_size, share of -1 labels): N 48 against the Pallas token
# tile of 64 (ragged), V 200 against its vocab tile of 256, padded rows
KERNEL_CASES = {"padded": (48, 32, 200, 190, 0.2),
                "exact": (37, 32, 256, 256, 0.1)}


def _inputs(case, dtype, seed=0):
    """(jax, torch) tuples of h (N, D), w (V, D), labels, lse, gl."""
    N, D, V, vs, masked = KERNEL_CASES[case]
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D), dtype=np.float32)
    w = rng.standard_normal((V, D), dtype=np.float32) / np.sqrt(D)
    labels = rng.integers(0, V, N).astype(np.int32)
    labels[rng.random(N) < masked] = -1
    lse = (rng.standard_normal(N) + np.log(V)).astype(np.float32)
    gl = np.where(labels >= 0, rng.random(N), 0).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = (jnp.asarray(h).astype(jd), jnp.asarray(w).astype(jd),
         jnp.asarray(labels), jnp.asarray(lse), jnp.asarray(gl))
    t = (torch.from_numpy(h).to(td), torch.from_numpy(w).to(td),
         torch.from_numpy(labels), torch.from_numpy(lse),
         torch.from_numpy(gl))
    return j, t, vs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_transposed_xent_fwd_plain_matches_jax_kernel(case, dtype):
    (hj, wj, lj, _, _), (ht, wt, lt, _, _), vs = _inputs(case, dtype)
    want_lse, want_ll = JX.xent_fwd(hj, wj, lj, vocab_size=vs,
                                    interpret=True, transposed=True)
    lse, ll = TX.xent_fwd(ht, wt, lt, vocab_size=vs, transposed=True)
    assert lse.dtype == ll.dtype == torch.float32
    _close(lse, want_lse)
    _close(ll, want_ll)
    assert (ll[lt < 0] == 0).all() and (ll[lt >= vs] == 0).all()


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_transposed_xent_bwd_plain_matches_jax_kernels(case, dtype, out):
    """dH (N, D) and dW in the embedding's own (V, D) layout, its rows at
    or past vocab_size 0."""
    (hj, wj, lj, sj, gj), (ht, wt, lt, st, gt), vs = _inputs(case, dtype, 1)
    jo, to = DTYPES[out]
    for jfn, tfn, shape in ((JX.xent_bwd_dh, TX.xent_bwd_dh, ht.shape),
                            (JX.xent_bwd_dw, TX.xent_bwd_dw, wt.shape)):
        want = jfn(hj, wj, lj, sj, gj, vocab_size=vs, interpret=True,
                   out_dtype=jo, transposed=True)
        got = tfn(ht, wt, lt, st, gt, vocab_size=vs, out_dtype=to,
                  transposed=True)
        assert got.dtype == to and tuple(got.shape) == tuple(shape)
        _close(got, want, *_out_tol(out))
    dw = TX.xent_bwd_dw(ht, wt, lt, st, gt, vocab_size=vs, transposed=True)
    assert tuple(dw.shape) == tuple(wt.shape) and (dw[vs:] == 0).all()


def test_transposed_routes_and_supported_shapes():
    """The CPU leaves the launch counters alone; the tensor-core layout
    test takes the (V, D) storage as it is, and ``xent_supported`` follows
    the layout as JAX's does."""
    _, (h, w, labels, lse, gl), vs = _inputs("padded", "bf16")
    fns = (TX.xent_fwd, TX.xent_bwd_dh, TX.xent_bwd_dw)
    before = [(f.launches, dict(f.route_launches)) for f in fns]
    TX.xent_fwd(h, w, labels, vocab_size=vs, transposed=True)
    for f in fns[1:]:
        f(h, w, labels, lse, gl, vocab_size=vs, transposed=True)
    assert [(f.launches, dict(f.route_launches)) for f in fns] == before
    hb = torch.zeros(64, 2048, dtype=torch.bfloat16)
    wb = torch.zeros(32003, 2048, dtype=torch.bfloat16)  # V of any size
    assert TX.mma_layout(hb, wb, transposed=True)
    assert not TX.mma_layout(hb, wb.T, transposed=True)  # D not contiguous
    assert not TX.mma_layout(hb[:, ::2], wb[:, :1024], transposed=True)
    assert not TX.mma_layout(hb.float(), wb.float(), transposed=True)
    for hs, ws in (((4, 8), (16, 8)), ((2, 4, 8), (16, 8)), ((4, 8), (8, 16)),
                   ((4, 8), (16, 9))):
        assert TK.xent_supported(hs, ws, True) == JK.xent_supported(
            hs, ws, "interpret", True)


# ------------------------------------------ the autograd Function against JAX

@pytest.mark.parametrize("weights", ["none", "fractional"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_transposed_xent_loss_and_grads_match_jax(dtype, weights):
    """Values and (dh, dw) of ``dispatch.xent_loss(transposed=True)``
    against JAX's under ``jax.grad``, h (B, S, D), dW (V, D) in w's
    dtype."""
    rng = np.random.default_rng(4)
    B, S, D, V, vs = 2, 24, 32, 200, 190
    h = rng.standard_normal((B, S, D), dtype=np.float32)
    w = rng.standard_normal((V, D), dtype=np.float32) / np.sqrt(D)
    labels = rng.integers(-1, vs, (B, S)).astype(np.int32)
    c = rng.random((B, S)).astype(np.float32)
    wts = (rng.random((B, S)).astype(np.float32) if weights == "fractional"
           else None)
    jd, td = DTYPES[dtype]

    def jloss(hh, ww):
        out = JK.xent_loss(hh, ww, jnp.asarray(labels), vocab_size=vs,
                           weights=None if wts is None else jnp.asarray(wts),
                           transposed=True)
        return jnp.sum(out * c), out

    (_, want), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h).astype(jd), jnp.asarray(w).astype(jd))
    ht = torch.from_numpy(h).to(td).requires_grad_()
    wt = torch.from_numpy(w).to(td).requires_grad_()
    got = TK.xent_loss(ht, wt, torch.from_numpy(labels), vocab_size=vs,
                       weights=None if wts is None else torch.from_numpy(wts),
                       transposed=True)
    gh, gw = torch.autograd.grad((got * torch.from_numpy(c)).sum(), [ht, wt])
    assert gh.dtype == td and gw.dtype == td and gw.shape == (V, D)
    _close(got, want)
    _close(gh, jgh, *_out_tol(dtype))
    _close(gw, jgw, *_out_tol(dtype))
    assert (gw[vs:] == 0).all()


# --------------------------------------------------------------- the model

def _cfgs(dt, **kw):
    jcfg = tiny_cfg("tied", dtype=NAMES[dt], vocab_size=250,
                    tie_embeddings=True, **kw)
    return jcfg, tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _model(dt):
    jcfg, tcfg = _cfgs(dt)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, load_flat(_jflat(jp), tcfg, device="cpu")


def _grad_close(got, want, dt, k):
    if dt == "f32":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 5e-2, (k, rel)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_tied_loss_fn_and_every_gradient_match_jax(dt):
    """The tied model has no lm_head; its loss and every gradient leaf
    against JAX's. The embedding's gradient is the lookup's plus the
    head's: on rows no token of the batch looks up it is the head's alone
    (f32: bitwise the gradient of ``lm_loss`` on the same hidden)."""
    jcfg, tcfg, jp, tp = _model(dt)
    assert "lm_head" not in tp and "lm_head" not in jp
    batch = _batches(jcfg, 1, batch=2, seq=24)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch), has_aux=True))(jp)
    tot, tm, grads = value_and_grad(tp, tcfg, _t(batch))
    atol, rtol = (1e-4, 0.0) if dt == "f32" else (2e-2, 2e-2)
    _close(tot, jtot, atol, rtol)
    _close(tm["loss"], jm["loss"], atol, rtol)
    assert float(tm["weight"]) == float(jm["weight"])
    want = _jflat(jg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        assert g.dtype == flatten(tp)[k].dtype, k
        _grad_close(g.float().numpy(), want[k], dt, k)
    if dt == "f32":
        w = tp["tok_embed"]["w"].detach().requires_grad_()
        with torch.no_grad():
            hidden = TM.forward(tp, tcfg, _t(batch)["tokens"])[0]
        loss, _ = TM.lm_loss({**tp, "tok_embed": {"w": w}}, tcfg, hidden,
                             _t(batch)["labels"])
        head = torch.autograd.grad(loss, [w])[0]
        seen = torch.zeros(w.shape[0], dtype=torch.bool)
        seen[torch.from_numpy(batch["tokens"]).long().reshape(-1)] = True
        g = grads["tok_embed/w"]
        assert torch.equal(g[~seen], head[~seen])
        assert not torch.equal(g[seen], head[seen])


# ------------------------------------------------------------- the trainer

@functools.lru_cache(maxsize=None)
def _jax_run(opt, dt):
    """JAX's tied run: (cfgs, the initial params, the per-step batches, and
    the (state, metrics) after each of 3 steps); cached for the checkpoint
    test, which restores its last state."""
    jcfg, tcfg = _cfgs(dt)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jtx = j_make(opt, 1e-2, rules=JRules.tied())
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))
    js = JT.init_state(jp, jtx)
    batches = _batches(jcfg, 3)
    out = []
    for b in batches:
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        out.append((js, jm))
    return jcfg, tcfg, jp, batches, out


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("opt", ["scale", "scale_fused"])
def test_tied_train_steps_match_jax(opt, dt):
    """Three steps of make_train_step under LabelRules.tied(): metrics,
    params (tok_embed among them, updated by the momentum branch with the
    row norm of its (V, D) storage) and optimizer state against JAX's."""
    jcfg, tcfg, jp, batches, jrun = _jax_run(opt, dt)
    tp = load_flat(_jflat(jp), tcfg, device="cpu")
    ttx = t_make(opt, 1e-2, rules=LabelRules.tied())
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0)
    ts = init_state(tp, ttx)
    f32 = dt == "f32"
    rtol = ({"loss": 1e-5, "grad_norm": 1e-5, "update_norm": 1e-5} if f32
            else {"loss": 1e-3, "grad_norm": 5e-3, "update_norm": 3e-2})
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    old = _jflat(jp)
    for step, (b, (js, jm)) in enumerate(zip(batches, jrun)):
        ts, tm = tstep(ts, _t(b))
        for k, tol in rtol.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=k)
        assert float(tm["weight"]) == float(jm["weight"])
        want = _jflat(js.params)
        for k, w in want.items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
            got = flatten(ts.params)[k].detach().float().numpy()
            tol = ((8 * _ulp(peak[k], NAMES[dt]) + 1e-5 * travel[k].max())
                   if f32 else 3 * _ulp(peak[k], NAMES[dt])
                   + 0.15 * travel[k].max())
            err = np.abs(got - w)
            assert (err <= tol).all(), (step, k, float(err.max()))
        old = want
        got_s, want_s = opt_state_to_flat(ts.opt_state), _jflat(js.opt_state)
        assert set(got_s) == set(want_s)
        for k, w in want_s.items():
            if k == "count" or not w.size:
                continue
            tol = (4e-6 if f32 else 1e-1) * np.abs(w).max()
            assert (np.abs(got_s[k] - w) <= tol).all(), (step, k)
    # the momentum moved onto the tied matrix
    assert ts.opt_state.mu["tok_embed/w"].shape == tp["tok_embed"]["w"].shape
    assert float(ts.opt_state.mu["tok_embed/w"].abs().sum()) > 0


def test_tied_tree_under_untied_rules_raises_as_in_jax():
    jcfg, tcfg, jp, tp = _model("f32")
    for make, params in ((j_make, jp), (t_make, tp)):
        with pytest.raises(ValueError, match="LabelRules.tied"):
            make("scale", 1e-3).init(params)
    # and in the update path, with a state built by the tied rules
    state = t_make("scale", 1e-3, rules=LabelRules.tied()).init(flatten(tp))
    with pytest.raises(ValueError, match="LabelRules.tied"):
        t_make("scale", 1e-3).update(flatten(tp), state, flatten(tp))


# ------------------------------------------------------------ the launcher

def _tiny_arch(arch, smoke=False):
    """JAX's get_arch, patched to the tiny llama."""
    del smoke
    return tiny_cfg(arch, vocab_size=256)


def _tiny_arch_t(arch, smoke=False):
    """The port's get_arch, patched to the same llama."""
    return tconfig.ModelConfig(**dataclasses.asdict(_tiny_arch(arch)))


ARCH = {j_launch: _tiny_arch, t_launch: _tiny_arch_t}


def _args(optimizer):
    return argparse.Namespace(arch="tiny", smoke=False, seq=16, dtype="",
                              tie_embeddings=True, lr=1e-3, steps=3,
                              optimizer=optimizer)


@pytest.mark.parametrize("optimizer", ["scale", "scale_fused", "adam"])
def test_launcher_routes_tied_rules_as_jax_build(optimizer, monkeypatch):
    """--tie-embeddings sets the config's flag, and the optimizer gets
    ``rules=LabelRules.tied()`` exactly when its factory takes ``rules``
    (SCALE yes, Adam no), on both sides."""
    seen = {}
    for mod, rules_cls in ((j_launch, JRules), (t_launch, LabelRules)):
        made = []
        real = mod.make_optimizer
        monkeypatch.setattr(mod, "get_arch", ARCH[mod])
        monkeypatch.setattr(mod, "make_optimizer",
                            lambda *a, _r=real, _m=made, **kw:
                            (_m.append(kw), _r(*a, **kw))[1])
        cfg, _ = mod.build(_args(optimizer))
        assert cfg.tie_embeddings
        (kw,) = made
        if "rules" in kw:
            assert kw["rules"] == rules_cls.tied()
        seen[mod.__name__] = sorted(kw)
    assert seen["repro.launch.train"] == seen["repro_torch.launch.train"]
    assert ("rules" in seen["repro_torch.launch.train"]) == (
        optimizer != "adam")


def _losses(out):
    return [float(m.group(1)) for m in re.finditer(r"^step +\d+ loss (\S+)",
                                                   out, re.M)]


class _JaxBatches:
    """The JAX SyntheticLM's batches, as torch tensors (the port's sampler
    draws other numbers from the same seed)."""

    def __init__(self, cfg, seq_len, global_batch, seed):
        self.ds = JD.make_dataset(cfg, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed)

    def host_batch_at(self, step):
        return _t({k: np.array(v)
                   for k, v in self.ds.host_batch_at(step).items()})


def test_launcher_tie_embeddings_follows_the_jax_launcher(monkeypatch):
    """Both launchers train the tiny tied llama (f32, scale_fused, batch 2
    of 16 tokens, 3 steps) from the same weights and batches (the port's
    init and data are handed JAX's): the printed losses agree."""
    cfg = _tiny_arch("tiny")
    flags = ["--arch", "tiny", "--tie-embeddings", "--optimizer",
             "scale_fused", "--steps", "3", "--batch", "2", "--seq", "16",
             "--log-every", "1", "--seed", "0"]
    outs = []
    for mod in (j_launch, t_launch):
        monkeypatch.setattr(mod, "get_arch", ARCH[mod])
    jp = JM.init_params(jax.random.PRNGKey(0),
                        dataclasses.replace(cfg, tie_embeddings=True))
    monkeypatch.setattr(t_launch, "init_params",
                        lambda c, gen, device: load_flat(_jflat(jp), c,
                                                         device=device))
    monkeypatch.setattr(t_launch, "make_dataset",
                        lambda c, seq_len, global_batch, seed, pack_documents,
                        device: _JaxBatches(_tiny_arch("tiny"), seq_len,
                                            global_batch, seed))
    for main, extra in ((j_launch.main, []),
                        (t_launch.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(flags + extra)
        outs.append(_losses(buf.getvalue()))
    assert len(outs[0]) == len(outs[1]) == 3, outs
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-4, rtol=0)


# ---------------------------------------------------------- the checkpoint

def test_jax_trained_tied_checkpoint_round_trips_through_the_port(tmp_path):
    """JAX's tied bf16 scale_fused state after 3 steps, saved by
    ``repro.checkpoint``, restores into the port bitwise; one port step
    later the port's checkpoint restores through JAX bitwise."""
    jcfg, tcfg, jp, batches, jrun = _jax_run("scale_fused", "bf16")
    js = jrun[-1][0]
    jckpt.save(str(tmp_path / "jax"), 3, js)
    ttx = t_make("scale_fused", 1e-2, rules=LabelRules.tied())
    like = init_state(TM.init_params(tcfg, torch.Generator().manual_seed(1),
                                     device="cpu"), ttx)
    got = ckpt.restore(str(tmp_path / "jax"), 3, like)
    _assert_bitwise(got, js)
    assert "lm_head" not in got.params
    assert got.opt_state.mu["tok_embed/w"].shape == (tcfg.padded_vocab,
                                                     tcfg.d_model)
    state, _ = make_train_step(tcfg, ttx, clip_norm=1.0)(
        got, _t(_batches(jcfg, 4)[-1]))
    assert isinstance(state, TrainState) and int(state.step) == 4
    ckpt.save(str(tmp_path / "port"), 4, state)
    _assert_bitwise(state, jckpt.restore(str(tmp_path / "port"), 4, js))


def test_guarded_tied_state_checkpoint_restores_through_jax(tmp_path):
    """The guarded tied state (the guard's leaves beside the tied tree)
    saved by the port after two guarded steps restores through JAX
    bitwise."""
    jcfg, tcfg = _cfgs("bf16")
    jtx = j_make("scale_fused", 1e-3, rules=JRules.tied())
    jlike = JT.init_state(JM.init_params(jax.random.PRNGKey(0), jcfg), jtx,
                          guard=True)
    ttx = t_make("scale_fused", 1e-3, rules=LabelRules.tied())
    state = init_state(TM.init_params(tcfg, torch.Generator().manual_seed(2),
                                      device="cpu"), ttx, guard=True)
    step = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy())
    for b in _batches(jcfg, 2):
        state, _ = step(state, _t(b))
    ckpt.save(str(tmp_path), 2, state)
    back = jckpt.restore(str(tmp_path), 2, jlike)
    _assert_bitwise(state, back)
    assert int(back.step) == 2
