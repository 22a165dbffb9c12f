"""The port's telemetry plane (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU: the layer groups, the record
grammar, coercion and sinks, the step timer and the profile window, the
statistics' keys and values, and the serving records.

The statistics take the same inputs on both sides, made with numpy from a
seed (gradients, pre-step and post-step parameters, a ``PipeState`` whose
first moments are filled in), or, for packed batches, the JAX gradients
of a packed batch carried over through numpy; bf16 values are made in JAX
and carried over exactly. Tolerance of every statistic: 2e-5 relative
(both sides sum f32 squares of the same values, in other orders and
through other reductions: ``torch._foreach_norm`` and the ``norm_sumsq``
plain version against ``jnp.sum``; observed about 1e-7), and exact zeros
where a group has no leaf or no state.
"""
import csv
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import tiny_cfg  # noqa: E402
from repro import obs as JO  # noqa: E402
from repro.core import LabelRules as JRules  # noqa: E402
from repro.core import labels as JL  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import serving as JS  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.core import LabelRules  # noqa: E402
from repro_torch.core import labels as TL  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.kernels.colnorm import colnorm as C  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import load_flat, load_opt_state  # noqa: E402
from repro_torch.training import serving as TS  # noqa: E402
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401
from test_torch_trainer import _jflat  # noqa: E402

STATS_RTOL = 2e-5


# --------------------------------------------------------------- labels

@pytest.mark.parametrize("tied", [False, True])
def test_layer_group_equals_jax_on_every_path(tied):
    cfg = tiny_cfg(tie_embeddings=tied)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    paths = [JL.path_str(p).lstrip(".") for p, _ in
             jax.tree_util.tree_flatten_with_path(shapes)[0]]
    assert ("lm_head/w" in paths) != tied
    got = {p: TL.layer_group(p, tied=tied) for p in paths}
    assert got == {p: JL.layer_group(p, tied=tied) for p in paths}
    assert set(got.values()) == ({"embedding", "hidden", "lm_head"}
                                 if not tied else {"hidden", "lm_head"})
    assert TL.LAYER_GROUPS == JL.LAYER_GROUPS


# ------------------------------------------------------- record grammar

GOOD = {"schema": JO.SCHEMA, "kind": "train_step", "host": 0, "step": 3,
        "t": 1.5, "loss": 2.0, "tag": "x", "fallbacks": {"attention": 2},
        "dims": [1, 2]}
BAD = [
    {"schema": JO.SCHEMA, "kind": "x", "host": 0, "step": 1},          # no t
    {"schema": "other/v9", "kind": "x", "host": 0, "step": 1, "t": 0.0},
    {"schema": JO.SCHEMA, "kind": "", "host": 0, "step": 1, "t": 0.0},
    {"schema": JO.SCHEMA, "kind": "x", "host": "0", "step": 1, "t": 0.0},
    {"schema": JO.SCHEMA, "kind": "x", "host": 0, "step": 1, "t": 0.0,
     "loss": float("nan")},                                         # raw NaN
    {"schema": JO.SCHEMA, "kind": "x", "host": 0, "step": 1, "t": 0.0,
     "deep": {"a": {"b": {"c": 1}}}},                               # too deep
    "not a dict",
]


def test_validate_record_accepts_what_jax_accepts():
    assert TO.SCHEMA == JO.SCHEMA == "repro_metrics/v1"
    JO.validate_record(GOOD)
    TO.validate_record(GOOD)


@pytest.mark.parametrize("bad", BAD)
def test_validate_record_rejects_what_jax_rejects(bad):
    with pytest.raises(ValueError):
        JO.validate_record(bad)
    with pytest.raises(ValueError):
        TO.validate_record(bad)


# --------------------------------------------------- coercion and sinks

@pytest.mark.parametrize("value,want", [
    (torch.tensor(1.5), 1.5),
    (torch.tensor(1.5, dtype=torch.bfloat16), 1.5),
    (torch.tensor([1.0, 2.5], dtype=torch.bfloat16), [1.0, 2.5]),
    (torch.tensor([[1.0], [2.0]]), [[1.0], [2.0]]),
    (torch.tensor(7, dtype=torch.int32), 7),
    (torch.tensor(True), True),
    (torch.tensor(float("nan")), None),
    (torch.tensor(float("-inf"), dtype=torch.bfloat16), None),
    (torch.tensor([1.0, float("inf")]), [1.0, None]),
    ({"a": torch.tensor(float("nan")), "b": np.float32(2.0)},
     {"a": None, "b": 2.0}),
    (np.int64(7), 7),
    (float("nan"), None),
])
def test_jsonable_gives_numbers_or_null_never_strings(value, want):
    got = TO.jsonable(value)
    assert got == want
    assert type(got) is type(want)
    # JAX's falls through np.asarray, which a torch tensor survives on the
    # CPU; on the card it would be its repr string (reference caveat 11)
    if not isinstance(value, torch.Tensor) or value.dtype != torch.bfloat16:
        assert JO.jsonable(value) == want


def test_jsonl_roundtrip_validates_through_both(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with TO.MetricsLogger([TO.JSONLSink(path)], host=0, flush_every=2) as lg:
        lg.log("train_step", 1, loss=torch.tensor(2.5),
               fields={"stats/lm_head/grad_norm": torch.tensor(3.0)})
        lg.log("event", 2, event="rollback", bad=torch.tensor(float("nan")))
    assert TO.validate_jsonl(path) == JO.validate_jsonl(path) == 2
    recs = [json.loads(x) for x in open(path)]
    assert recs[0]["loss"] == 2.5
    assert recs[0]["stats/lm_head/grad_norm"] == 3.0
    assert recs[1]["bad"] is None
    assert all(r["schema"] == TO.SCHEMA and r["host"] == 0 for r in recs)


def test_logger_rejects_shadowed_required_key():
    with TO.MetricsLogger([TO.MemorySink()]) as lg:
        with pytest.raises(ValueError, match="shadow"):
            lg.log("x", 0, fields={"step": 7})


def test_csv_sink_fixed_header(tmp_path):
    path = str(tmp_path / "m.csv")
    with TO.MetricsLogger([TO.CSVSink(path)], host=1) as lg:
        lg.log("train_step", 1, loss=torch.tensor(1.0), extra="a,b")
        lg.log("train_step", 2, loss=2.0, novel=9)  # unknown col dropped
    lines = open(path).read().splitlines()
    header = lines[0].split(",")
    assert header[:5] == ["schema", "kind", "host", "step", "t"]
    assert "extra" in header and "novel" not in header
    assert '"a,b"' in lines[1]
    rows = list(csv.reader(lines))
    assert rows[1][header.index("loss")] == "1.0"
    assert rows[1][header.index("extra")] == "a,b"
    assert len(lines) == 3


def test_memory_sink_background_flush_cadence():
    sink = TO.MemorySink()
    lg = TO.MetricsLogger([sink], flush_every=3)
    for i in range(7):
        lg.log("x", i)
    assert lg.flush()                    # synchronous barrier
    assert [r["step"] for r in sink.records] == list(range(7))
    assert sink.flushes >= 2             # two cadence flushes + barrier
    lg.close()
    lg.log("late", 99)                   # post-close logs are dropped
    assert len(sink.records) == 7


def test_console_host_gating(capsys):
    with TO.MetricsLogger([], host=1) as lg:
        lg.console("hello", step=3)
    assert capsys.readouterr().out == ""
    with TO.MetricsLogger([], host=0) as lg:
        lg.console("hello", step=3)
        lg.console("step    10 loss 1.0", raw=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[h0 s3] hello"
    assert out[1].startswith("step ") and out[1].endswith("host 0")


# ------------------------------------------------------- timing/profile

def test_step_timer_snapshot_resets_as_jax():
    snaps = []
    for timer in (JO.StepTimer(), TO.StepTimer()):
        with timer.section("data"):
            time.sleep(0.01)
        with timer.section("data"):
            pass
        timer.add("ckpt", 0.5)
        snap = timer.snapshot()
        assert snap["time/data_n"] == 2 and snap["time/data_s"] >= 0.01
        assert snap["time/ckpt_s"] == 0.5 and snap["time/ckpt_n"] == 1
        assert snap["time/wall_s"] >= snap["time/data_s"]
        assert "time/data_s" not in timer.snapshot()   # deltas
        snaps.append(sorted(snap))
    assert snaps[0] == snaps[1]


def test_device_memory_is_empty_on_a_cpu_run():
    assert TO.device_memory("cpu") == {}


@pytest.mark.parametrize("spec,want", [
    ("", None), ("5", (5, 5)), ("2:9", (2, 9)), ("0:0", (0, 0))])
def test_profile_window_parse(spec, want, tmp_path):
    for mod in (JO, TO):
        win = mod.ProfileWindow.parse(spec, str(tmp_path))
        if want is None:
            assert win is None
        else:
            assert (win.start, win.stop) == want


@pytest.mark.parametrize("spec", ["a:b", "1:2:3", "9:2", "-1", "1:"])
def test_profile_window_parse_rejects(spec, tmp_path):
    for mod in (JO, TO):
        with pytest.raises(ValueError):
            mod.ProfileWindow.parse(spec, str(tmp_path))


def test_cpu_profile_window_writes_a_trace_naming_the_spans(tmp_path):
    win = TO.ProfileWindow.parse("1:2", str(tmp_path / "prof"), "cpu")
    assert not win.cuda
    x = torch.ones(64, 64)
    for step in range(4):
        started = win.maybe_start(step)
        assert started == (step == 1)
        with TO.trace_span("train_step"):
            with TO.trace_span("obs_stats"):
                x = x @ x / 64
        assert win.maybe_stop(step) == (step == 2)
    win.finalize()
    assert win.done and not win.active
    text = open(win.path).read()
    assert win.path.endswith("trace_steps_1_2.json")
    json.loads(text)
    assert '"train_step"' in text and '"obs_stats"' in text


# --------------------------------------------------------- stats: keys

@pytest.mark.parametrize("prefix", ["stats", "obs/fig4"])
@pytest.mark.parametrize("momentum", [False, True])
@pytest.mark.parametrize("colnorms", [False, True])
@pytest.mark.parametrize("ratios", [False, True])
def test_stats_keys_equal_jax(prefix, momentum, colnorms, ratios):
    kw = dict(every_k=3, momentum=momentum, colnorms=colnorms,
              ratios=ratios, prefix=prefix)
    got = TO.stats_keys(TO.StatsPolicy(**kw))
    assert got == JO.stats_keys(JO.StatsPolicy(**kw))
    assert f"{prefix}/valid" in got


def test_stats_policy_defaults_and_every_k_validation():
    assert TO.StatsPolicy()._asdict() == JO.StatsPolicy()._asdict()
    for bad in (0, -2):
        with pytest.raises(ValueError, match="every_k"):
            TO.make_stats_fn(TO.StatsPolicy(every_k=bad))
        with pytest.raises(ValueError, match="every_k"):
            TO.stats_keys(TO.StatsPolicy(every_k=bad))


def test_split_stats_as_jax():
    pol = TO.StatsPolicy(every_k=2)
    on = {"loss": torch.tensor(1.0), "stats/valid": torch.tensor(1.0),
          "stats/lm_head/grad_norm": torch.tensor(2.0)}
    off = {**on, "stats/valid": torch.tensor(0.0)}
    plain, st = TO.split_stats(on, pol)
    assert set(plain) == {"loss"} and set(st) == {"stats/lm_head/grad_norm"}
    assert TO.split_stats(off, pol) == ({"loss": on["loss"]}, {})
    assert TO.split_stats(on, None) == (on, {})


# ------------------------------------------------------- stats: values

def _jtree(like, flat, dtype=None):
    """A JAX tree shaped as ``like`` from ``{path: np.ndarray}``."""
    return jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(flat[JL.path_str(p).lstrip(".")],
                                 dtype=dtype or x.dtype), like)


def _inputs(dt, tied, packed, seed=0):
    """(jax, port) tuples of grads, old params, new params, opt state, and
    the port's config: the same numbers on both sides."""
    jcfg = tiny_cfg("obs", dtype=dt, tie_embeddings=tied, vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seed)
    old = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    oflat = _jflat(old)
    if packed:
        # the JAX gradient of a packed batch
        batch = {k: jnp.asarray(v) for k, v in j_dataset(
            jcfg, seq_len=32, global_batch=4, seed=seed,
            pack_documents=True).global_batch_at(0).items()}
        assert "segment_ids" in batch

        def loss(p):
            return JM.loss_fn(p, jcfg, batch)[0]
        grads = jax.jit(jax.grad(loss))(old)
    else:
        # gradients of unit scale with a heavy-tailed column spread, so
        # that the column norms are far from equal
        grads = _jtree(old, {k: rng.standard_normal(v.shape).astype(
            np.float32) * np.exp(rng.standard_normal(v.shape[-1:])).astype(
            np.float32) for k, v in oflat.items()})
    new = _jtree(old, {k: v + 1e-2 * rng.standard_normal(v.shape).astype(
        np.float32) for k, v in oflat.items()})
    rules = JRules.tied() if tied else None
    jtx = j_make("scale", 1e-2, rules=rules) if tied else j_make("scale",
                                                                1e-2)
    st = jtx.init(old)
    st = st._replace(mu=jax.tree_util.tree_map(
        lambda m: jnp.asarray(rng.standard_normal(m.shape), m.dtype), st.mu))
    ttx = (t_make("scale", 1e-2, rules=LabelRules.tied()) if tied
           else t_make("scale", 1e-2))
    gflat, nflat = _jflat(grads), _jflat(new)
    tdt = tcfg.torch_dtype
    tg = {k: torch.from_numpy(np.array(v)).to(tdt) for k, v in gflat.items()}
    told = flatten(load_flat(oflat, tcfg, device="cpu"))
    tnew = flatten(load_flat(nflat, tcfg, device="cpu"))
    tst = load_opt_state(_jflat(st), told, ttx, device="cpu")
    return (grads, old, new, st), (tg, told, tnew, tst)


def _check(tm, jm):
    assert set(tm) == set(jm)
    for k, v in jm.items():
        w, g = float(v), float(tm[k])
        assert tm[k].dtype == torch.float32 and tm[k].ndim == 0, k
        if w == 0.0:
            assert g == 0.0, (k, g)
        else:
            np.testing.assert_allclose(g, w, rtol=STATS_RTOL, err_msg=k)


@pytest.mark.parametrize("dt,tied,packed", [
    ("float32", False, False), ("bfloat16", False, False),
    ("float32", True, False), ("bfloat16", True, False),
    ("float32", False, True), ("bfloat16", True, True)])
def test_stats_values_equal_jax(dt, tied, packed):
    (jg, jold, jnew, jst), (tg, told, tnew, tst) = _inputs(dt, tied, packed)
    policy = dict(every_k=3, tied=tied)
    jfn = jax.jit(JO.make_stats_fn(JO.StatsPolicy(**policy)))
    tfn = TO.make_stats_fn(TO.StatsPolicy(**policy))
    n0 = C.norm_sumsq.launches
    for step in (6, 7):
        jm = jfn(jnp.int32(step), jg, jold, jnew, jst)
        tm = tfn(step, tg, told, tnew, tst)
        _check(tm, jm)
    assert C.norm_sumsq.launches == n0   # the CPU takes the plain version
    assert float(tm["stats/valid"]) == 0.0 and all(
        float(v) == 0.0 for v in tm.values())
    tm = tfn(6, tg, told, tnew, tst)
    assert float(tm["stats/valid"]) == 1.0
    # the paper's placement: SCALE's head carries momentum, the embedding
    # (or, tied, nothing) none; groups that exist have gradients
    assert float(tm["stats/lm_head/momentum_norm"]) > 0
    assert float(tm["stats/embedding/momentum_norm"]) == 0.0
    assert (float(tm["stats/embedding/grad_norm"]) == 0.0) == tied
    # the groups' squared norms sum to the whole tree's
    for name, tree in (("grad_norm", tg), ("param_norm", told)):
        total = sum(float(torch.linalg.vector_norm(x.float())) ** 2
                    for x in tree.values())
        parts = sum(float(tm[f"stats/{g}/{name}"]) ** 2
                    for g in TL.LAYER_GROUPS)
        np.testing.assert_allclose(parts, total, rtol=1e-5)
    # update norms handed in by the caller give the same numbers
    un = TO.stats.leaf_update_norms(tnew, told)
    _check(tfn(6, tg, told, tnew, tst, update_norms=un), tm)


def test_stats_median_of_an_even_count_is_the_midpoint():
    """Every group of the tiny llama holds an even count of columns; the
    median is JAX's midpoint of the two middle values, not torch.median's
    lower one, and the head's column norms are the per-token ones."""
    (jg, jold, jnew, jst), (tg, told, tnew, tst) = _inputs("float32", False,
                                                           False)
    tm = TO.make_stats_fn(TO.StatsPolicy(every_k=1))(1, tg, told, tnew, tst)
    cn = np.sqrt((np.asarray(jg["lm_head"]["w"], np.float64) ** 2).sum(0))
    assert cn.size == 256 and cn.size % 2 == 0
    s = np.sort(cn)
    lo, hi = s[cn.size // 2 - 1], s[cn.size // 2]
    assert hi - lo > 1e-3 * hi
    med = float(tm["stats/lm_head/colnorm_med"])
    np.testing.assert_allclose(med, (lo + hi) / 2, rtol=1e-6)
    assert abs(med - lo) > 1e-4 * hi
    np.testing.assert_allclose(float(tm["stats/lm_head/colnorm_max"]), s[-1],
                               rtol=1e-6)
    assert float(torch.median(torch.from_numpy(cn))) == lo
    # NaN anywhere in a group makes its median NaN, as jnp.median's
    x = torch.tensor([1.0, float("nan"), 3.0, 4.0])
    assert torch.isnan(TO.stats._median(x))
    assert float(TO.stats._median(torch.tensor([4.0, 1.0, 3.0]))) == 3.0


def test_stacked_vector_leaves_count_as_matrices():
    """Reference caveat 10: a stacked (L, D) norm scale joins the hidden
    group's column norms, one norm per d over the layer axis, as in JAX."""
    (jg, jold, jnew, jst), (tg, told, tnew, tst) = _inputs("float32", False,
                                                           False)
    keep = "segments/seg0_dense/attn/norm"
    assert tg[keep].shape == (2, 64)
    only = {k: (v if k == keep or "segments" not in k else v * 0)
            for k, v in tg.items()}
    tm = TO.make_stats_fn(TO.StatsPolicy(every_k=1))(1, only, told, tnew,
                                                     tst)
    norms = torch.linalg.vector_norm(tg[keep].float(), dim=0)
    assert float(tm["stats/hidden/colnorm_max"]) == pytest.approx(
        float(norms.max()), rel=1e-6)


# -------------------------------------------------------------- serving

def test_greedy_generate_logger_writes_jax_serve_records():
    jcfg = tiny_cfg("serve", vocab_size=250)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = load_flat(_jflat(jp), tcfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, 250, (2, 8)).astype(
        np.int32)
    recs = {}
    for name, run in (
            ("jax", lambda lg: JS.greedy_generate(jcfg, jp, jnp.asarray(
                prompt), n_steps=4, max_seq=16, logger=lg)),
            ("port", lambda lg: TS.greedy_generate(tcfg, tp, prompt,
                                                   n_steps=4, max_seq=16,
                                                   device="cpu", logger=lg))):
        sink = TO.MemorySink()
        with TO.MetricsLogger([sink]) as lg:
            out = run(lg)
        assert tuple(out.shape) == (2, 4)
        recs[name] = {r["phase"]: r for r in sink.records
                      if r["kind"] == "serve"}
    assert set(recs["port"]) == set(recs["jax"]) == {"prefill", "decode"}
    for phase, r in recs["port"].items():
        assert set(r) == set(recs["jax"][phase]), phase
        JO.validate_record(r)
        TO.validate_record(r)
    assert recs["port"]["prefill"]["prompt_tokens"] == 16
    d = recs["port"]["decode"]
    assert d["decode_steps"] == 3 and d["p99_ms"] >= d["p50_ms"] >= 0
    assert d["compile_ms"] > 0 and d["tokens_per_s"] > 0
    # without a logger: no records and the same tokens
    assert torch.equal(TS.greedy_generate(tcfg, tp, prompt, n_steps=4,
                                          max_seq=16, device="cpu"), out)
