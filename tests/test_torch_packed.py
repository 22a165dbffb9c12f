"""The port's packed-document training against the JAX package, on the CPU:
first-fit packed ``SyntheticLM`` batches, the segment clause of the three
attention kernels' plain versions, ``segment_ids`` and ``positions``
through the model, the loss, the trainer and ``--pack-documents``.
Mirrors ``tests/test_packed.py`` less its sharded case (the sharded path
is held against JAX in ``tests/test_torch_sharded.py``).

  * the packed layout (``segment_ids``, ``positions``, ``loss_weights``
    and where the labels are -1) is JAX's bitwise for the same (seed,
    step, B, S); the labels are the port's own tokens shifted within each
    document (the candidate tokens come from the port's generator);
  * ``unpack_to_rows`` equals JAX's on the same batch;
  * ``mha_fwd``, ``mha_bwd_dq`` and ``mha_bwd_dkv`` with segments (their
    plain versions, the CPU route) against the Pallas kernels in interpret
    mode: causal, non-causal S != T with separate q and kv ids and a query
    whose id no key has, GQA, a pad-only row, unsorted ids, f32 and bf16;
    and ``dispatch.flash_attention``'s gradients against ``jax.vjp``;
  * ``loss_fn`` and every gradient on a packed batch against JAX's, on
    JAX's params and batch, f32 and bf16, 2 layers; ``make_eval_step``;
  * three ``make_train_step`` steps against the JAX trainer, and
    ``grad_accum=2`` (the mean of the microbatches' means, as JAX);
  * packed against unpacked per document, and no leakage across
    documents, bitwise;
  * ``--pack-documents --device cpu`` through the launcher's ``main``.

Inputs are made with numpy from a seed (or by JAX's pipeline) and handed
to both sides. Tolerances, per element unless said:
  * attention, as ``tests/test_torch_attention.py`` and
    ``tests/test_torch_attention_bwd.py`` hold the clauses without
    segments (the segment clause only selects which pairs are summed):
    out f32 2e-5, bf16 2e-2 + 2e-2*|ref|; lse 1e-4 + 1e-5*|ref| on rows
    with a valid key (rows with none: exactly 0 out and lse below -1e29
    on both sides); gradients against ``max|ref|``, since their entries
    cancel toward zero (ROADMAP.md reference caveat 1): f32 2e-6 *
    max|ref|, bf16 1e-5 * max|ref| + 8e-3 * |ref|, and through the whole
    Function in bf16 1e-2 * max|ref| + 2e-2 * |ref|;
  * the model, trainer and launcher: the tolerances of
    ``tests/test_torch_tied.py`` and ``tests/test_torch_trainer.py`` (the
    packed batch changes which pairs and tokens are summed, not how);
  * packed against unpacked and the leakage test: bitwise (each
    document's tokens sit in the same lanes, and the other documents are
    masked to an exact 0 in both layouts).
"""
import contextlib
import dataclasses
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.common import repro_fused  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.kernels import dispatch as JK  # noqa: E402
from repro.kernels.attention import attention as jattn  # noqa: E402
from repro.launch import train as j_launch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import dispatch as TK  # noqa: E402
from repro_torch.kernels.attention.attention import (  # noqa: E402
    mha_bwd_dkv, mha_bwd_dq, mha_fwd)
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import (init_state, make_eval_step,  # noqa: E402
                                  make_train_step, value_and_grad)
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import _jflat, _ulp  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NAMES = {"f32": "float32", "bf16": "bfloat16"}
KEYS = ("tokens", "labels", "segment_ids", "positions", "loss_weights")
LAYOUT = ("segment_ids", "positions", "loss_weights")


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------------- the batches

def _both(seed, step, B, S, vocab=500):
    jcfg = tiny_cfg("packed", vocab_size=vocab)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    j = JD.make_dataset(jcfg, seq_len=S, global_batch=B, seed=seed,
                        pack_documents=True).global_batch_at(step)
    t = TD.make_dataset(tcfg, S, B, seed=seed, pack_documents=True,
                        device="cpu").global_batch_at(step)
    return {k: np.asarray(v) for k, v in j.items()}, t


@pytest.mark.parametrize("seed,step,B,S", [(3, 5, 4, 64), (0, 0, 16, 256),
                                           (7, 2, 3, 17)])
def test_packed_layout_is_bitwise_jax(seed, step, B, S):
    """segment_ids, positions, loss_weights and the -1 labels are JAX's
    bitwise; the labels are the port's tokens shifted within each
    document, and pad tokens are 0."""
    j, t = _both(seed, step, B, S)
    assert set(t) == set(j) == set(KEYS)
    for k in KEYS:
        assert tuple(t[k].shape) == (B, S) and t[k].dtype == {
            "loss_weights": torch.float32}.get(k, torch.int32), k
    for k in LAYOUT:
        np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    labels, toks = t["labels"].numpy(), t["tokens"].numpy()
    np.testing.assert_array_equal(labels == -1, j["labels"] == -1)
    segs = j["segment_ids"]
    for b in range(B):
        for s in np.unique(segs[b][segs[b] > 0]):
            lanes = np.flatnonzero(segs[b] == s)
            np.testing.assert_array_equal(labels[b, lanes[:-1]],
                                          toks[b, lanes[1:]])
        assert (toks[b][segs[b] == 0] == 0).all()
    again = TD.make_dataset(tconfig.ModelConfig(**dataclasses.asdict(
        tiny_cfg("packed", vocab_size=500))), S, B, seed=seed,
        pack_documents=True, device="cpu").global_batch_at(step)
    assert all(torch.equal(again[k], t[k]) for k in KEYS)


def test_unpack_to_rows_matches_jax():
    _, t = _both(3, 5, 4, 64)
    want = JD.unpack_to_rows({k: v.numpy() for k, v in t.items()})
    got = TD.unpack_to_rows(t)
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == t[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_host_batch_and_rope_positions():
    """Hosts slice every packed key; RoPE takes the (B, S) positions as
    JAX's does."""
    _, t = _both(1, 0, 4, 32)
    ds = TD.make_dataset(tconfig.ModelConfig(**dataclasses.asdict(
        tiny_cfg("packed", vocab_size=500))), 32, 4, seed=1,
        pack_documents=True, device="cpu")
    half = ds.host_batch_at(0, host_id=1, n_hosts=2)
    assert all(torch.equal(half[k], t[k][2:]) for k in KEYS)
    pos = t["positions"]
    x = np.random.default_rng(0).standard_normal((4, 32, 3, 16),
                                                 dtype=np.float32)
    jc, js = JL.rope_tables(jnp.asarray(pos.numpy()), 16, 10000.0)
    tc, ts = TL.rope_tables(pos, 16, 10000.0)
    assert tuple(tc.shape) == (4, 32, 8)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_allclose(
        TL.apply_rope(torch.from_numpy(x), tc, ts).numpy(),
        np.asarray(JL.apply_rope(jnp.asarray(x), jc, js)), atol=1e-5)


# ----------------------------------------------------------- the kernels

# (B, S, T, H, K, hd, causal, ids): "packed" a packed batch's ids for q
# and kv, its row 1 made all pad (id 0); "separate" sorted ids of their
# own, q row 3 given an id no key has; "random" unsorted ids in [0, 3]
SEG_CASES = {
    "causal_packed_gqa_padrow": (2, 40, 40, 4, 2, 32, True, "packed"),
    "noncausal_separate_hd64": (2, 12, 40, 4, 4, 64, False, "separate"),
    "unsorted_ragged_mqa": (2, 33, 33, 4, 1, 32, True, "random"),
}


def _seg_np(kind, B, S, T, seed):
    rng = np.random.default_rng(seed)
    if kind == "separate":
        q = np.sort(rng.integers(1, 4, (B, S)), 1).astype(np.int32)
        kv = np.sort(rng.integers(1, 4, (B, T)), 1).astype(np.int32)
        q[:, 3] = 9
        return q, kv
    if kind == "random":
        ids = rng.integers(0, 4, (B, S)).astype(np.int32)
        return ids, ids
    _, t = _both(seed, 0, B, S)
    ids = t["segment_ids"].numpy()
    ids[1] = 0
    return ids, ids


def _inputs(seed, B, S, T, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, T, K, hd), dtype=np.float32),
            rng.standard_normal((B, S, H, hd), dtype=np.float32))


def _grad_close(got, want, dtype, whole=False):
    want, got = _np(want), _np(got)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    if dtype == "f32":
        tol = 2e-6 * scale
    elif whole:
        tol = 1e-2 * scale + 2e-2 * np.abs(want)
    else:
        tol = 1e-5 * scale + 8e-3 * np.abs(want)
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err <= tol).all(), float(err.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(SEG_CASES))
def test_segment_clause_matches_pallas_interpret(case, dtype):
    """The three wrappers with segments (the plain versions, on CPU
    tensors) against the Pallas kernels in interpret mode; on the CPU they
    launch nothing and count no segment launch."""
    B, S, T, H, K, hd, causal, kind = SEG_CASES[case]
    jd, td = DTYPES[dtype]
    scale = hd ** -0.5
    x = _inputs(hd + K, B, S, T, H, K, hd)
    qs, ks = _seg_np(kind, B, S, T, 2)

    @jax.jit
    def pallas(q, k, v, do, qs, ks):
        kw = dict(scale=scale, causal=causal, interpret=True,
                  segments=(qs, ks))
        out, lse = jattn.mha_fwd(q, k, v, **kw)
        delta = jnp.swapaxes(jnp.sum(do.astype(jnp.float32)
                                     * out.astype(jnp.float32), -1), 1, 2)
        dq = jattn.mha_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = jattn.mha_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return out, lse, delta, dq, dk, dv

    out_j, lse_j, delta, dq_j, dk_j, dv_j = pallas(
        *(jnp.asarray(a).astype(jd) for a in x), jnp.asarray(qs),
        jnp.asarray(ks))
    q, k, v, do = (torch.from_numpy(a).to(td) for a in x)
    segs = (torch.from_numpy(qs), torch.from_numpy(ks))
    kw = dict(scale=scale, causal=causal, segments=segs)
    counts = [(f.launches, f.segment_launches)
              for f in (mha_fwd, mha_bwd_dq, mha_bwd_dkv)]
    out, lse = mha_fwd(q, k, v, **kw)
    atol, rtol = (2e-5, 0.0) if dtype == "f32" else (2e-2, 2e-2)
    np.testing.assert_allclose(_np(out), _np(out_j), atol=atol, rtol=rtol)
    lj = np.asarray(lse_j)
    rows = lj > -1e29
    np.testing.assert_allclose(lse.numpy()[rows], lj[rows], atol=1e-4,
                               rtol=1e-5)
    dead = ~rows.transpose(0, 2, 1)  # (B, S, H): queries with no valid key
    assert (lse.numpy()[~rows] < -1e29).all()
    assert (out.float().numpy()[dead] == 0).all()
    assert (_np(out_j)[dead] == 0).all()
    assert dead.any() == (kind == "separate")  # a pad row sees its own pad
    args = (q, k, v, do, torch.from_numpy(np.array(lse_j)),
            torch.from_numpy(np.array(delta)), None)
    dq = mha_bwd_dq(*args, **kw)
    dk, dv = mha_bwd_dkv(*args, **kw)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.dtype == td
        _grad_close(got, want, dtype)
    assert (dq.float().numpy()[dead] == 0).all()
    assert counts == [(f.launches, f.segment_launches)
                      for f in (mha_fwd, mha_bwd_dq, mha_bwd_dkv)]


@pytest.mark.parametrize("dtype", ["f32"])
def test_flash_attention_with_segments_grads_match_jax_vjp(dtype):
    B, S, T, H, K, hd, causal, kind = SEG_CASES["causal_packed_gqa_padrow"]
    jd, td = DTYPES[dtype]
    x = _inputs(11, B, S, T, H, K, hd)
    qs, ks = _seg_np(kind, B, S, T, 4)
    with repro_fused("interpret"):
        out_j, vjp = jax.vjp(lambda q, k, v: JK.flash_attention(
            q, k, v, scale=0.25, causal=causal,
            segments=(jnp.asarray(qs), jnp.asarray(ks))),
            *(jnp.asarray(a).astype(jd) for a in x[:3]))
        want = vjp(jnp.asarray(x[3]).astype(jd))
    q, k, v = (torch.from_numpy(a).to(td).requires_grad_() for a in x[:3])
    out = TK.flash_attention(q, k, v, scale=0.25, causal=causal,
                             segments=(torch.from_numpy(qs),
                                       torch.from_numpy(ks)))
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    got = torch.autograd.grad(out, [q, k, v], torch.from_numpy(x[3]).to(td))
    _grad_close(out, out_j, dtype, whole=True)
    for g, w in zip(got, want):
        _grad_close(g, w, dtype, whole=True)


def test_segment_operands_are_checked():
    """segments with kv_len, wrong shapes, a dtype other than int32 and
    another device raise, in every wrapper; decode with segment ids
    raises in the model, as JAX's mask_spec does."""
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    ids = torch.ones(2, 8, dtype=torch.int32)
    lse = torch.zeros(2, 4, 8)
    bad = {"mutually exclusive": dict(segments=(ids, ids), kv_len=3,
                                      causal=False),
           r"\(2, 8\)": dict(segments=(ids[:, :5], ids)),
           "int32": dict(segments=(ids.long(), ids)),
           "on meta": dict(segments=(ids, ids.to("meta"))),
           "pair": dict(segments=ids)}
    for match, kw in bad.items():
        kw = {"causal": True, **kw}
        with pytest.raises(ValueError, match=match):
            mha_fwd(q, k, k, scale=1.0, **kw)
        for fn in (mha_bwd_dq, mha_bwd_dkv):
            with pytest.raises(ValueError, match=match):
                fn(q, k, k, q, lse, lse, scale=1.0, **kw)
    cfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_cfg("packed")))
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = {n: t[0] for n, t in
             p["segments"]["seg0_dense"]["attn"].items()}
    cache = {"k": torch.zeros(2, 8, 2, 16), "v": torch.zeros(2, 8, 2, 16)}
    with pytest.raises(ValueError, match="mutually exclusive"):
        TL.apply_attention(layer, cfg, torch.zeros(2, 1, 64),
                           torch.zeros(1, dtype=torch.int32), "decode",
                           cache, torch.tensor(3), segment_ids=ids[:, :1])


# --------------------------------------------------------------- the model

def _model(dt):
    jcfg = tiny_cfg("packed", dtype=NAMES[dt], vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, load_flat(_jflat(jp), tcfg, device="cpu")


def _jbatches(jcfg, n, batch=4, seq=32, seed=3):
    ds = JD.make_dataset(jcfg, seq_len=seq, global_batch=batch, seed=seed,
                         pack_documents=True)
    return [{k: np.array(v) for k, v in ds.global_batch_at(i).items()}
            for i in range(n)]


def _leaf_close(got, want, dt, k):
    if dt == "f32":
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), k
    else:
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 5e-2, (k, rel)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_packed_loss_fn_and_every_gradient_match_jax(dt):
    """loss_fn on JAX's packed batch (positions, segment_ids,
    loss_weights) and every gradient against JAX's; the eval step takes
    the packed batch (its loss is loss_fn's, bitwise); int64 ids give the
    int32 ids' loss (forward casts them once)."""
    jcfg, tcfg, jp, tp = _model(dt)
    batch = _jbatches(jcfg, 1)[0]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jtot, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jbatch), has_aux=True))(jp)
    tot, tm, grads = value_and_grad(tp, tcfg, _t(batch))
    atol, rtol = (1e-4, 0.0) if dt == "f32" else (2e-2, 2e-2)
    np.testing.assert_allclose(float(tot), float(jtot), atol=atol, rtol=rtol)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               atol=atol, rtol=rtol)
    assert float(tm["weight"]) == float(jm["weight"]) == float(
        batch["loss_weights"].sum())
    want = _jflat(jg)
    assert set(grads) == set(want)
    for k, g in grads.items():
        _leaf_close(g.float().numpy(), want[k], dt, k)
    assert float(make_eval_step(tcfg)(tp, _t(batch))["loss"]) == float(
        tm["loss"])
    if dt == "f32":
        b64 = {**_t(batch), "segment_ids": _t(batch)["segment_ids"].long()}
        with torch.no_grad():
            assert float(TM.loss_fn(tp, tcfg, b64)[0]) == float(tot)


def _run_steps(dt, grad_accum, n):
    jcfg, tcfg, jp, tp = _model(dt)
    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    jstep = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0,
                                       grad_accum=grad_accum))
    tstep = make_train_step(tcfg, ttx, clip_norm=1.0, grad_accum=grad_accum)
    js, ts = JT.init_state(jp, jtx), init_state(tp, ttx)
    out = []
    for b in _jbatches(jcfg, n):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, _t(b))
        # the fused write updates the params in place: keep this step's
        out.append((jm, tm, _jflat(js.params),
                    {k: x.detach().float().numpy().copy()
                     for k, x in flatten(ts.params).items()}))
    return jp, out


@pytest.mark.parametrize("dt,grad_accum,n", [("f32", 1, 3), ("bf16", 1, 3),
                                             ("f32", 2, 2)])
def test_packed_train_steps_match_jax(dt, grad_accum, n):
    """make_train_step on packed batches against the JAX trainer: the
    metrics (the loss of grad_accum=2 the mean of the two microbatches'
    means, as JAX's) and every parameter, with
    ``tests/test_torch_trainer.py``'s tolerances."""
    jp, out = _run_steps(dt, grad_accum, n)
    f32 = dt == "f32"
    rtol = ({"loss": 1e-5, "grad_norm": 1e-5, "update_norm": 1e-5} if f32
            else {"loss": 1e-3, "grad_norm": 5e-3, "update_norm": 3e-2})
    peak = {k: np.abs(v) for k, v in _jflat(jp).items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    old = _jflat(jp)
    for step, (jm, tm, want, got_p) in enumerate(out):
        for k, tol in rtol.items():
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol,
                                       err_msg=k)
        assert float(tm["weight"]) == float(jm["weight"])
        for k, w in want.items():
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w),
                                                     np.abs(w - old[k])))
            travel[k] = travel[k] + np.abs(w - old[k])
            got = got_p[k]
            tol = ((8 * _ulp(peak[k], NAMES[dt]) + 1e-5 * travel[k].max())
                   if f32 else 3 * _ulp(peak[k], NAMES[dt])
                   + 0.15 * travel[k].max())
            err = np.abs(got - w)
            assert (err <= tol).all(), (step, k, float(err.max()))
        old = want


# --------------------------------------------- packed against unpacked rows

def _per_token(params, cfg, batch):
    h = TM.forward(params, cfg, batch["tokens"],
                   positions=batch["positions"],
                   segment_ids=batch["segment_ids"])[0]
    return TK.xent_loss(h, params["lm_head"]["w"], batch["labels"],
                        vocab_size=cfg.vocab_size,
                        weights=batch["loss_weights"])


@pytest.fixture(scope="module")
def packed_model():
    cfg = tconfig.ModelConfig(**dataclasses.asdict(tiny_cfg("packed")))
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    batch = TD.make_dataset(cfg, 64, 4, seed=3, pack_documents=True,
                            device="cpu").global_batch_at(5)
    return cfg, params, batch


@torch.no_grad()
def test_packed_vs_unpacked_per_document_bitwise(packed_model):
    """Each document's per-token losses are bitwise those of its
    offset-preserving unpacked row; the loss and every gradient agree
    (the summation trees differ across layouts)."""
    cfg, params, batch = packed_model
    rows = TD.unpack_to_rows(batch)
    per_p = _per_token(params, cfg, batch)
    per_u = _per_token(params, cfg, rows)
    segs = batch["segment_ids"]
    i = 0
    for b in range(segs.shape[0]):
        for s in segs[b].unique():
            if s == 0:
                continue
            m = segs[b] == s
            assert torch.equal(per_p[b][m], per_u[i][m]), (b, int(s))
            i += 1
    assert i == rows["tokens"].shape[0]
    with torch.enable_grad():
        lp, _, gp = value_and_grad(params, cfg, batch)
        lu, _, gu = value_and_grad(params, cfg, rows)
    np.testing.assert_allclose(float(lp), float(lu), rtol=1e-6)
    for k in gp:
        np.testing.assert_allclose(gp[k].numpy(), gu[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@torch.no_grad()
def test_zero_cross_document_attention(packed_model):
    """Perturbing document 1 of a row leaves every other document's
    per-token losses, and every other row, bitwise unchanged."""
    cfg, params, batch = packed_model
    segs = batch["segment_ids"]
    b = next(b for b in range(segs.shape[0]) if segs[b].max() >= 2)
    m1 = segs[b] == 1
    mutant = dict(batch, tokens=batch["tokens"].clone())
    mutant["tokens"][b, m1] = (mutant["tokens"][b, m1] + 7) % cfg.vocab_size
    base = _per_token(params, cfg, batch)
    pert = _per_token(params, cfg, mutant)
    other = segs[b] >= 2
    assert torch.equal(base[b][other], pert[b][other])
    assert not torch.equal(base[b][m1], pert[b][m1])
    rest = [r for r in range(segs.shape[0]) if r != b]
    assert torch.equal(base[rest], pert[rest])


# ------------------------------------------------------------ the launcher

def _tiny_arch(arch, smoke=False):
    del smoke
    return tiny_cfg(arch, vocab_size=256)


def _tiny_arch_t(arch, smoke=False):
    return tconfig.ModelConfig(**dataclasses.asdict(_tiny_arch(arch)))


class _JaxBatches:
    """The JAX SyntheticLM's packed batches, as torch tensors."""

    def __init__(self, cfg, seq_len, global_batch, seed):
        self.ds = JD.make_dataset(cfg, seq_len=seq_len,
                                  global_batch=global_batch, seed=seed,
                                  pack_documents=True)

    def host_batch_at(self, step):
        return _t(self.ds.host_batch_at(step))


def test_launcher_pack_documents_follows_the_jax_launcher(monkeypatch):
    """Both launchers train the tiny llama (f32, scale_fused, batch 2 of
    32 tokens, 3 steps) on packed batches from the same weights and
    batches: the printed losses agree within 2e-4 (4 printed decimals
    and f32 sums in other orders); the port's header says
    pack_documents=True and its tok/s counts the real tokens."""
    flags = ["--arch", "tiny", "--pack-documents", "--optimizer",
             "scale_fused", "--steps", "3", "--batch", "2", "--seq", "32",
             "--log-every", "1", "--seed", "0"]
    for mod, arch in ((j_launch, _tiny_arch), (t_launch, _tiny_arch_t)):
        monkeypatch.setattr(mod, "get_arch", arch)
    jp = JM.init_params(jax.random.PRNGKey(0), _tiny_arch("tiny"))
    monkeypatch.setattr(t_launch, "init_params",
                        lambda c, gen, device: load_flat(_jflat(jp), c,
                                                         device=device))
    seen = {}

    def data(c, seq_len, global_batch, seed, pack_documents, device):
        seen["pack"] = pack_documents
        return _JaxBatches(_tiny_arch("tiny"), seq_len, global_batch, seed)
    monkeypatch.setattr(t_launch, "make_dataset", data)
    outs = []
    for main, extra in ((j_launch.main, []),
                        (t_launch.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(flags + extra)
        outs.append(buf.getvalue())
    losses = [[float(m.group(1)) for m in re.finditer(
        r"^step +\d+ loss (\S+)", o, re.M)] for o in outs]
    assert len(losses[0]) == len(losses[1]) == 3, outs
    np.testing.assert_allclose(losses[1], losses[0], atol=2e-4, rtol=0)
    assert seen["pack"] is True and "pack_documents=True" in outs[1]
    tput = [float(m.group(1).replace(",", "")) for m in re.finditer(
        r"tok/s (\S+)", outs[1])]
    assert len(tput) == 3 and all(t > 0 for t in tput)

