"""The port's LM-head cross-entropy against the JAX package on the same
inputs: the plain versions of the three xent kernels against the Pallas
kernels (interpret mode on the CPU), ``dispatch.xent_loss`` and its
autograd gradients against JAX's ``custom_vjp``, and ``lm_loss``,
``loss_fn`` and ``make_eval_step`` of a two-layer llama. Inputs are made
with numpy from a seed and handed to both sides.

Tolerances, per element:
  * lse, ll, losses and f32 gradients: 2e-5 absolute + 1e-5 relative —
    both sides form exact f32 products of the inputs (bf16 inputs too) and
    sum them in f32 in other orders;
  * dh and dw written as bf16: 1e-5 + 8e-3 relative — each side rounds
    its f32 sum to bf16 once (one ulp, 2**-8 relative) and the f32 sums
    differ in their last bits, which can move the rounding by one ulp;
  * the model's loss (f32 params): 1e-4 absolute after two layers, as in
    tests/test_torch_model.py; bf16 params: 2e-2 + 2e-2 relative, bf16
    matmul outputs rounded at different places on the two sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.kernels import dispatch as JK  # noqa: E402
from repro.kernels.xent import xent as JX  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.kernels import dispatch as TK  # noqa: E402
from repro_torch.kernels.attention.attention import mha_fwd  # noqa: E402
from repro_torch.kernels.xent import ref as TR  # noqa: E402
from repro_torch.kernels.xent import xent as TX  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import make_eval_step  # noqa: E402

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_ATOL, F32_RTOL = 2e-5, 1e-5
BF16_OUT_ATOL, BF16_OUT_RTOL = 1e-5, 8e-3

# (N, D, V, vocab_size, share of -1 labels): N is a multiple of no tile
KERNEL_CASES = {
    "ragged_padvocab": (299, 64, 1024, 1000, 0.2),
    "small": (37, 32, 256, 256, 0.1),
    "all_masked": (50, 64, 384, 300, 1.0),
}


def _np(x):
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, atol=F32_ATOL, rtol=F32_RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _inputs(case, dtype, seed=0):
    """(jax, torch) pairs of h, w, labels, lse, gl from one numpy seed.

    Labels hit valid columns, padded columns (>= vocab_size) and -1."""
    N, D, V, vs, masked = KERNEL_CASES[case]
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D), dtype=np.float32)
    w = rng.standard_normal((D, V), dtype=np.float32) / np.sqrt(D)
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


# ------------------------------------------------ plain kernels against JAX

@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_xent_fwd_plain_matches_jax_kernel(case, dtype):
    (hj, wj, lj, _, _), (ht, wt, lt, _, _), vs = _inputs(case, dtype)
    want_lse, want_ll = JX.xent_fwd(hj, wj, lj, vocab_size=vs, interpret=True)
    lse, ll = TX.xent_fwd(ht, wt, lt, vocab_size=vs)
    assert lse.dtype == ll.dtype == torch.float32
    _close(lse, want_lse)
    _close(ll, want_ll)
    assert (ll[lt < 0] == 0).all() and (ll[lt >= vs] == 0).all()


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(KERNEL_CASES))
def test_xent_bwd_plain_matches_jax_kernels(case, dtype, out):
    (hj, wj, lj, sj, gj), (ht, wt, lt, st, gt), vs = _inputs(case, dtype, 1)
    jo, to = DTYPES[out]
    tol = (F32_ATOL, F32_RTOL) if out == "f32" else (BF16_OUT_ATOL,
                                                      BF16_OUT_RTOL)
    for jfn, tfn, shape in ((JX.xent_bwd_dh, TX.xent_bwd_dh, ht.shape),
                            (JX.xent_bwd_dw, TX.xent_bwd_dw, wt.shape)):
        want = jfn(hj, wj, lj, sj, gj, vocab_size=vs, interpret=True,
                   out_dtype=jo)
        got = tfn(ht, wt, lt, st, gt, vocab_size=vs, out_dtype=to)
        assert got.dtype == to and tuple(got.shape) == tuple(shape)
        _close(got, want, *tol)
    dw = TX.xent_bwd_dw(ht, wt, lt, st, gt, vocab_size=vs)
    assert (dw[:, vs:] == 0).all()  # padded columns get no gradient


def test_plain_kernels_compose_to_autograd_of_losses():
    """lse - ll and the two backward refs are the value and the gradient of
    the differentiable ``ref.losses``, with lse from the forward (labels
    on real columns: ``losses`` reads a padded label's logit at -1e9)."""
    _, (h, w, labels, _, _), vs = _inputs("ragged_padvocab", "f32", 2)
    labels = torch.where(labels < vs, labels, -1)
    h, w = h.double().requires_grad_(), w.double().requires_grad_()
    c = torch.from_numpy(np.random.default_rng(3).random(h.shape[0]))
    loss = TR.losses(h, w, labels, vs)
    gh, gw = torch.autograd.grad((loss * c).sum(), [h, w])
    lse, ll = TR.xent_fwd_ref(h, w, labels, vocab_size=vs)
    _close(torch.where(labels >= 0, lse - ll, 0.0), loss)
    gl = (c * (labels >= 0)).float()
    lse = lse.float()
    _close(TR.xent_bwd_dh_ref(h.float(), w.float(), labels, lse, gl,
                              vocab_size=vs), gh)
    _close(TR.xent_bwd_dw_ref(h.float(), w.float(), labels, lse, gl,
                              vocab_size=vs), gw)


# ------------------------------------------ the autograd Function against JAX

@pytest.mark.parametrize("weights", ["none", "fractional", "zero"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xent_loss_and_grads_match_jax(dtype, weights):
    """Values and (dh, dw) of ``dispatch.xent_loss`` against JAX's
    ``custom_vjp`` under ``jax.grad``, with h (B, S, D)."""
    rng = np.random.default_rng(4)
    B, S, D, V, vs = 3, 41, 64, 1024, 1000
    h = rng.standard_normal((B, S, D), dtype=np.float32)
    w = rng.standard_normal((D, V), dtype=np.float32) / np.sqrt(D)
    labels = rng.integers(-1, vs, (B, S)).astype(np.int32)
    c = rng.random((B, S)).astype(np.float32)  # cotangent of the losses
    wts = None
    if weights == "fractional":
        wts = rng.random((B, S)).astype(np.float32)
    elif weights == "zero":
        wts = (rng.random((B, S)) < 0.5).astype(np.float32)
    jd, td = DTYPES[dtype]

    def jloss(hh, ww):
        out = JK.xent_loss(hh, ww, jnp.asarray(labels), vocab_size=vs,
                           weights=None if wts is None else jnp.asarray(wts))
        return jnp.sum(out * c), out

    (_, want), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h).astype(jd), jnp.asarray(w).astype(jd))
    ht = torch.from_numpy(h).to(td).requires_grad_()
    wt = torch.from_numpy(w).to(td).requires_grad_()
    got = TK.xent_loss(ht, wt, torch.from_numpy(labels), vocab_size=vs,
                       weights=None if wts is None else torch.from_numpy(wts))
    gh, gw = torch.autograd.grad((got * torch.from_numpy(c)).sum(), [ht, wt])
    assert got.dtype == torch.float32 and gh.dtype == td and gw.dtype == td
    _close(got, want)
    tol = (F32_ATOL, F32_RTOL) if dtype == "f32" else (BF16_OUT_ATOL,
                                                       BF16_OUT_RTOL)
    _close(gh, jgh, *tol)
    _close(gw, jgw, *tol)
    if wts is not None:  # zero-weight tokens: no loss, no gradient
        zero = torch.from_numpy(wts) == 0
        assert (got[zero] == 0).all() and (gh[zero] == 0).all()


def test_forward_kernel_choice_and_split_plan():
    """Aligned bf16 rows take the tensor-core forward (``wgmma``); its plan
    cuts llama-1b's loss (N = 4096, V = 32000) into 32 row tiles of 128
    by 4 splits of 32 vocab tiles of 256: 128 blocks, one per SM."""
    h = torch.zeros(64, 2048, dtype=torch.bfloat16)
    w = torch.zeros(2048, 32000, dtype=torch.bfloat16)
    assert TX.mma_layout(h, w)
    assert not TX.mma_layout(h.float(), w.float())
    assert not TX.mma_layout(h, w.T.contiguous().T)       # columns contiguous
    assert not TX.mma_layout(h[:, 1:], w[1:])              # 16-byte misaligned
    assert not TX.mma_layout(h[:, :100], w[:100, :1000].contiguous())  # D % 8
    assert TX.split_plan(4096, 32000) == (4, 32)
    assert TX.split_plan(1, 32000) == (125, 1)  # one tile a block
    assert TX.split_plan(10 ** 6, 50257) == (1, 197)  # row tiles fill the card


@pytest.mark.parametrize("N,ncols", [(1, 32000), (4096, 32000), (4097, 31990),
                                     (300, 1000), (10 ** 6, 50257)])
def test_forward_split_plan(N, ncols):
    """The forward's splits cover every vocab tile of 256 exactly once, in
    contiguous ranges of ``per`` tiles (the last may be shorter, never
    empty); the grid of row tiles of 128 by splits stays within 132 blocks
    unless the row tiles alone are more; the plan is a function of the
    shape alone."""
    splits, per = TX.split_plan(N, ncols)
    tiles = -(-ncols // 256)
    covered = np.zeros(tiles, dtype=np.int64)
    for s in range(splits):
        span = range(s * per, min(tiles, (s + 1) * per))
        assert len(span) >= 1
        covered[span.start:span.stop] += 1
    assert (covered == 1).all()
    row_tiles = -(-N // 128)
    assert row_tiles * splits <= max(132, row_tiles)
    assert TX.split_plan(N, ncols) == (splits, per)


@pytest.mark.parametrize("N,ncols", [(1, 32000), (4096, 32000),
                                     (4097, 31990), (300, 1000),
                                     (16384, 32000), (10 ** 6, 50257)])
def test_backward_chunk_plan(N, ncols):
    """The tensor-core backward's chunks cover the vocab and the tokens
    exactly once, every vocab chunk but the last is whole tiles of 128, and
    G's two bf16 halves fit 64 MiB."""
    rows, cols = TX.chunk_plan(N, ncols)
    col_spans = [(c, min(cols, ncols - c)) for c in range(0, ncols, cols)]
    row_spans = [(r, min(rows, N - r)) for r in range(0, N, rows)]
    for spans, total in ((col_spans, ncols), (row_spans, N)):
        covered = np.zeros(total, dtype=np.int64)
        for start, width in spans:
            assert width >= 1
            covered[start:start + width] += 1
        assert (covered == 1).all()
    assert cols % 128 == 0
    assert all(width % 128 == 0 for _, width in col_spans[:-1])
    assert 2 * min(N, rows) * cols * 2 <= 64 * 2**20
    assert TX.chunk_plan(N, ncols) == (rows, cols)  # a function of the shape
    if N == 4096 and ncols == 32000:  # llama-1b's loss: 8 chunks, the last
        assert (rows, len(col_spans), col_spans[-1][1]) == (4096, 8, 3328)


def test_cpu_backward_leaves_the_launch_counters():
    """On CPU tensors the backward wrappers run their plain versions and
    count no launch, on either route."""
    _, (h, w, labels, lse, gl), vs = _inputs("small", "bf16")
    fns = (TX.xent_bwd_dh, TX.xent_bwd_dw)
    before = [(f.launches, dict(f.route_launches)) for f in fns]
    for f in fns:
        f(h, w, labels, lse, gl, vocab_size=vs, out_dtype=torch.bfloat16)
    assert [(f.launches, dict(f.route_launches)) for f in fns] == before
    assert all(set(f.route_launches) == {"mma", "fma", "mma_t", "fma_t",
                                         "empty"} for f in fns)


def test_cpu_forward_leaves_the_launch_counters():
    """On CPU tensors the forward wrapper runs its plain version and counts
    no launch, on either route."""
    _, (h, w, labels, _, _), vs = _inputs("small", "bf16")
    before = (TX.xent_fwd.launches, dict(TX.xent_fwd.route_launches))
    TX.xent_fwd(h, w, labels, vocab_size=vs)
    assert (TX.xent_fwd.launches, dict(TX.xent_fwd.route_launches)) == before
    assert set(TX.xent_fwd.route_launches) == {"wgmma", "fma", "wgmma_t",
                                               "fma_t", "empty"}


# ------------------------------------- vocabulary shards (``col_offset``)

# (N, D, shards, V of one shard, vocab_size): the padded vocabulary of 4
# shards of 128 ends at 300, so shard 2 is cut at id 300 and shard 3 lies
# past it and has no valid column
SHARD_CASE = (53, 32, 4, 128, 300)


def _shard_inputs(dtype, tied, seed=5):
    """(jax, torch) pairs of h, the whole head w ((D, V) or tied (V, D)),
    labels, lse, gl, and the shards of w with their col_offsets. Labels are
    global ids across every shard, ids past vocab_size and -1."""
    N, D, k, v, vs = SHARD_CASE
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((N, D), dtype=np.float32)
    w = rng.standard_normal((D, k * v), dtype=np.float32) / np.sqrt(D)
    w = np.ascontiguousarray(w.T) if tied else w
    labels = rng.integers(0, k * v, N).astype(np.int32)
    labels[rng.random(N) < 0.2] = -1
    lse = (rng.standard_normal(N) + np.log(vs)).astype(np.float32)
    gl = np.where(labels >= 0, rng.random(N), 0).astype(np.float32)
    jd, td = DTYPES[dtype]
    j = (jnp.asarray(h).astype(jd), jnp.asarray(w).astype(jd),
         jnp.asarray(labels), jnp.asarray(lse), jnp.asarray(gl))
    t = (torch.from_numpy(h).to(td), torch.from_numpy(w).to(td),
         torch.from_numpy(labels), torch.from_numpy(lse),
         torch.from_numpy(gl))
    cut = (lambda x, i: x[i * v:(i + 1) * v]) if tied else (
        lambda x, i: x[:, i * v:(i + 1) * v])
    shards = [(i * v, cut(j[1], i), cut(t[1], i)) for i in range(k)]
    return j, t, shards, vs


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_xent_fwd_col_offset_matches_jax_kernel(tied, dtype):
    """Each shard's (lse, ll) with its col_offset against JAX's Pallas
    kernel (interpret mode): a label another shard owns gives ll 0, and
    the shard past vocab_size gives lse -inf and ll 0 on both sides."""
    (hj, _, lj, _, _), (ht, _, lt, _, _), shards, vs = _shard_inputs(
        dtype, tied)
    for off, wj, wt in shards:
        want_lse, want_ll = JX.xent_fwd(hj, wj, lj, vocab_size=vs,
                                        col_offset=off, interpret=True,
                                        transposed=tied)
        lse, ll = TX.xent_fwd(ht, wt, lt, vocab_size=vs, col_offset=off,
                              transposed=tied)
        _close(lse, want_lse)
        _close(ll, want_ll)
        v = wt.shape[0 if tied else 1]
        mine = (lt >= off) & (lt < min(off + v, vs))
        assert (ll[~mine] == 0).all() and (ll[mine] != 0).all()
        if off >= vs:
            assert torch.isneginf(lse).all()


@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_xent_bwd_col_offset_matches_jax_kernels(tied, dtype, out):
    """Each shard's dH and dW with its col_offset against JAX's kernels;
    the columns (rows, tied) of the shard past vocab_size get no
    gradient, and that shard adds nothing to dH."""
    (hj, _, lj, sj, gj), (ht, _, lt, st, gt), shards, vs = _shard_inputs(
        dtype, tied, 6)
    jo, to = DTYPES[out]
    tol = (F32_ATOL, F32_RTOL) if out == "f32" else (BF16_OUT_ATOL,
                                                      BF16_OUT_RTOL)
    for off, wj, wt in shards:
        for jfn, tfn in ((JX.xent_bwd_dh, TX.xent_bwd_dh),
                         (JX.xent_bwd_dw, TX.xent_bwd_dw)):
            want = jfn(hj, wj, lj, sj, gj, vocab_size=vs, col_offset=off,
                       interpret=True, out_dtype=jo, transposed=tied)
            got = tfn(ht, wt, lt, st, gt, vocab_size=vs, col_offset=off,
                      out_dtype=to, transposed=tied)
            assert got.dtype == to
            _close(got, want, *tol)
            if off >= vs:
                assert (got == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_xent_col_offset_shards_combine_to_the_whole_head(tied, dtype):
    """The shards' (lse, ll) combined as the sharded dispatch does (max,
    then the log of the summed exps; ll summed) equal the whole head's;
    with that global lse the shards' dH sum to the whole head's and their
    dW put together are its dW (f32 sums in another order: the stated
    f32 tolerance)."""
    _, (ht, wt, lt, _, gt), shards, vs = _shard_inputs(dtype, tied, 7)
    parts = [TX.xent_fwd(ht, w, lt, vocab_size=vs, col_offset=off,
                         transposed=tied) for off, _, w in shards]
    lse_k = torch.stack([p[0] for p in parts])
    m = lse_k.max(0).values
    lse = m + torch.log(torch.exp(lse_k - m).sum(0))
    ll = torch.stack([p[1] for p in parts]).sum(0)
    want_lse, want_ll = TX.xent_fwd(ht, wt, lt, vocab_size=vs,
                                    transposed=tied)
    _close(lse, want_lse)
    _close(ll, want_ll)
    kw = dict(vocab_size=vs, transposed=tied)
    dh = sum(TX.xent_bwd_dh(ht, w, lt, want_lse, gt, col_offset=off, **kw)
             for off, _, w in shards)
    dw = torch.cat([TX.xent_bwd_dw(ht, w, lt, want_lse, gt, col_offset=off,
                                   **kw) for off, _, w in shards],
                   0 if tied else 1)
    _close(dh, TX.xent_bwd_dh(ht, wt, lt, want_lse, gt, **kw))
    _close(dw, TX.xent_bwd_dw(ht, wt, lt, want_lse, gt, **kw))


def test_xent_supported_matches_jax():
    for hs, ws, tr in (((4, 8), (8, 16), False), ((2, 4, 8), (8, 16), False),
                       ((4, 8), (16, 8), True), ((4, 8), (9, 16), False),
                       ((2, 2, 4, 8), (8, 16), False), ((0, 8), (8, 16), False)):
        assert TK.xent_supported(hs, ws, tr) == JK.xent_supported(
            hs, ws, "interpret", tr)


def test_unported_clauses_raise():
    """Every clause of the three kernels is ported (``col_offset`` is held
    against JAX below); what is left to raise are malformed arguments: a
    negative or non-integer col_offset on every entry, tied or not, and a
    w in the wrong layout for ``transposed`` (a shape error)."""
    h, w = torch.zeros(4, 8), torch.zeros(8, 16)
    lab, v = torch.zeros(4, dtype=torch.int32), torch.zeros(4)
    for tr, ww in ((False, w), (True, w.T)):
        with pytest.raises(ValueError, match="col_offset"):
            TX.xent_fwd(h, ww, lab, vocab_size=16, col_offset=-16,
                        transposed=tr)
        for fn in (TX.xent_bwd_dh, TX.xent_bwd_dw):
            with pytest.raises(ValueError, match="col_offset"):
                fn(h, ww, lab, v, v, vocab_size=16, col_offset=-3,
                   transposed=tr)
            with pytest.raises(TypeError):
                fn(h, ww, lab, v, v, vocab_size=16, col_offset=3.0,
                   transposed=tr)
    with pytest.raises(ValueError, match=r"w \(V, D\)"):
        TX.xent_fwd(h, w, lab, vocab_size=16, transposed=True)
    with pytest.raises(ValueError, match=r"w \(V, D\)"):
        TK.xent_loss(h, w, lab, vocab_size=16, transposed=True)
    with pytest.raises(ValueError, match="need h"):
        TK.xent_loss(h[None, None], w, lab[None, None], vocab_size=16)


# --------------------------------------------------- the model's loss path

def _tcfg(jcfg):
    return tconfig.ModelConfig(**dataclasses.asdict(jcfg))


def _model(dtype, **kw):
    jcfg = tiny_cfg("xent", dtype={"f32": "float32", "bf16": "bfloat16"}[dtype],
                    vocab_size=250, **kw)  # padded to 256
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    flat = {path_str(p): np.asarray(x.astype(jnp.float32)) for p, x in leaves}
    return jcfg, jparams, _tcfg(jcfg), load_flat(flat, _tcfg(jcfg),
                                                 device="cpu")


def _model_tol(dtype):
    return (1e-4, 0.0) if dtype == "f32" else (2e-2, 2e-2)


@pytest.mark.parametrize("masked", ["some", "all"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_lm_loss_and_grad_match_jax(dtype, masked):
    """Loss, weight and the gradient with respect to (hidden, lm_head.w);
    an all-masked batch gives loss 0, weight 0 and finite (zero)
    gradients."""
    jcfg, jparams, cfg, params = _model(dtype)
    rng = np.random.default_rng(5)
    B, S = 2, 24
    hidden = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (B, S)).astype(np.int32)
    if masked == "all":
        labels[:] = -1
    jd, td = DTYPES[dtype]

    def jloss(hh, ww):
        p = {**jparams, "lm_head": {"w": ww}}
        return JM.lm_loss(p, jcfg, hh, jnp.asarray(labels))

    (jl, jw), (jgh, jgw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(hidden).astype(jd), jparams["lm_head"]["w"])
    w = params["lm_head"]["w"].requires_grad_(True)
    ht = torch.from_numpy(hidden).to(td).requires_grad_()
    loss, weight = TM.lm_loss(params, cfg, ht, torch.from_numpy(labels))
    gh, gw = torch.autograd.grad(loss, [ht, w])
    _close(loss, jl)
    assert float(weight) == float(jw)
    _close(gh, jgh, *(F32_ATOL, F32_RTOL) if dtype == "f32"
           else (BF16_OUT_ATOL, BF16_OUT_RTOL))
    _close(gw, jgw, *(F32_ATOL, F32_RTOL) if dtype == "f32"
           else (BF16_OUT_ATOL, BF16_OUT_RTOL))
    if masked == "all":
        assert float(loss) == 0.0 and float(weight) == 0.0
        assert torch.isfinite(gh.float()).all() and (gw == 0).all()


def test_lm_loss_with_weights_matches_jax():
    jcfg, jparams, cfg, params = _model("f32")
    rng = np.random.default_rng(6)
    hidden = rng.standard_normal((2, 16, cfg.d_model), dtype=np.float32)
    labels = rng.integers(-1, cfg.vocab_size, (2, 16)).astype(np.int32)
    wts = rng.random((2, 16)).astype(np.float32) * (rng.random((2, 16)) < .7)
    jl, jw = JM.lm_loss(jparams, jcfg, jnp.asarray(hidden),
                        jnp.asarray(labels), weights=jnp.asarray(wts))
    tl, tw = TM.lm_loss(params, cfg, torch.from_numpy(hidden),
                        torch.from_numpy(labels), weights=torch.from_numpy(wts))
    _close(tl, jl)
    _close(tw, jw)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_fn_matches_jax(dtype):
    jcfg, jparams, cfg, params = _model(dtype)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    jtot, jm = JM.loss_fn(jparams, jcfg, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
    with torch.no_grad():
        ttot, tm = TM.loss_fn(params, cfg, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(labels)})
    atol, rtol = _model_tol(dtype)
    _close(ttot, jtot, atol, rtol)
    _close(tm["loss"], jm["loss"], atol, rtol)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert float(tm["weight"]) == float(jm["weight"]) == labels.size - 2
    # one document a row (segment ids all 1, positions 0..S-1): the
    # unpacked loss, bitwise on the CPU, as in JAX
    one_doc = {"segment_ids": np.ones((2, 24), np.int32),
               "positions": np.tile(np.arange(24, dtype=np.int32), (2, 1))}
    jseg, _ = JM.loss_fn(jparams, jcfg, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        **{k: jnp.asarray(v) for k, v in one_doc.items()}})
    with torch.no_grad():
        tseg, _ = TM.loss_fn(params, cfg, {
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels),
            **{k: torch.from_numpy(v) for k, v in one_doc.items()}})
    assert float(tseg) == float(ttot)
    _close(tseg, jseg, atol, rtol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_make_eval_step_matches_jax(dtype):
    """On a batch made by the JAX SyntheticLM, carried across as numpy."""
    jcfg, jparams, cfg, params = _model(dtype)
    ds = JD.make_dataset(jcfg, seq_len=32, global_batch=2, seed=3)
    batch = {k: np.array(v) for k, v in ds.global_batch_at(5).items()}
    want = JT.make_eval_step(jcfg)(jparams, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    got = make_eval_step(cfg)(params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    atol, rtol = _model_tol(dtype)
    _close(got["loss"], want["loss"], atol, rtol)
    _close(got["perplexity"], want["perplexity"], atol,
           max(rtol, 1e-4 if dtype == "f32" else 5e-2))
    assert not got["loss"].requires_grad


def test_attention_cpu_route_stays_differentiable():
    """The plain attention keeps its autograd history on the CPU (the card's
    kernel raises under grad instead, see tests/test_torch_gpu.py)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16),
                                                    dtype=np.float32))
               .requires_grad_() for _ in range(3))
    out, _ = mha_fwd(q, k, v, scale=0.25, causal=True)
    gq, gk, gv = torch.autograd.grad(out.square().sum(), [q, k, v])
    assert all(bool(g.abs().sum() > 0) for g in (gq, gk, gv))
