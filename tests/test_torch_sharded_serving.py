"""The port's serving on a ("data", "model") mesh against the JAX
package's single-device serving, on the CPU: dense, MoE, the VLM and
audio, every family whose attention is GQA.

One spawned ``gloo`` job of world 4 runs every mesh check below and sends
its results back; the test process computes the JAX references while the
workers run (the workers import no JAX). Each worker runs torch on one
thread. JAX's own meshes fail under JAX 0.9.0 (ROADMAP.md Queue 3,
caveat 2), so every reference is JAX's unsharded ``greedy_generate`` and
its jitted prefill and decode steps. Both sides take the same weights,
drawn by numpy from a seed per each leaf's init.

The job:
  * ``greedy_generate(..., rules, mesh)`` of the ``SMOKE`` twins of
    deepseek-67b (dense), dbrx-132b (MoE, ``moe_group_size`` as
    ``SMOKE``: the decode's B tokens make one group, which the guard
    keeps whole over "data" 2), llama-3.2-vision-11b (without images, as
    JAX's greedy passes none) and musicgen-medium (audio) on (2, 2) and
    (1, 4), ``max_seq`` 16, a prompt of 3 and 10 new tokens: the decode
    writes cross "model" 4's shard boundaries at 4 and 8 (and its last
    step attends up to 12), and ranks attend with a local fill of 0.
    The logits of the prefill and of every decode step are read where
    ``greedy_generate`` takes their argmax, and the cache's layout after
    the prefill and after every decode step;
  * the VLM with images through ``make_prefill_step`` and
    ``make_decode_step`` on both meshes, fed its own argmax: tokens,
    every step's logits and the final cache;
  * the dense twin on (2, 2) with ``max_seq`` 15, which "model" 2 does
    not divide: the cache's T stays whole and decode takes the batch-only
    ``AttnPlan``;
  * ROADMAP.md Queue 3 item 29: the dense twin's decode on (1, 2) and
    (2, 1) (each pair of ranks a sub-mesh of a (2, 1, 2) or (2, 2, 1)
    mesh), which died in DTensor's bare ``AssertionError`` before.

Without a process group: ``cache_logical_axes`` against JAX's for every
``ARCH_IDS`` entry; ``dispatch.lse_combine`` of two and four T-splits of
a plain ``mha_fwd_ref`` call against the unsharded call; ``check_mesh``
in mode decode; ``dispatch._plan_decode``'s layouts and raises.

Tolerances:
  * logits, f32: ``tests/test_torch_serving.py``'s 1e-4 absolute (the
    ranks sum matrix products and the softmax's partials in other
    orders); the final cache the same;
  * the lse combine against the unsharded plain call: f32 2e-6 of the
    output's largest |value| (a few f32 ulps: each split rescales its
    own partial sum); bf16 2 ** -7 of it (each split's output rounded to
    bf16 once more than the unsharded call's: two bf16 ulps).
"""
import concurrent.futures
import dataclasses
import traceback
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

if not torch.distributed.is_available():
    pytest.skip("needs torch.distributed", allow_module_level=True)

from test_torch_sharded_mamba import _free_port, _jflat, _np  # noqa: E402

WORLD = 4
MESHES = ((2, 2), (1, 4))
DENSE, MOE = "deepseek-67b", "dbrx-132b"
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
ARCHS = (DENSE, MOE, VLM, AUDIO)
B, PROMPT, NEW, MAX_SEQ = 2, 3, 10, 16
WHOLE_T = 15  # max_seq that "model" 2 does not divide
PAIRS = {(1, 2): (2, 1, 2), (2, 1): (2, 2, 1)}  # item 29: pair sub-meshes
ATOL = 1e-4
COMBINE_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


def _cfg_kw(arch):
    """The SMOKE config's fields: plain data both packages'
    ``ModelConfig`` take."""
    from repro_torch.configs import get_arch
    return dataclasses.asdict(get_arch(arch, smoke=True))


def _tcfg(arch):
    from repro_torch.models import config as tconfig
    return tconfig.ModelConfig(**_cfg_kw(arch))


def _weights(arch) -> dict:
    """{path: f32 numpy} drawn by numpy per each leaf's init (normal
    0.02, the router's 0.006, ones, zeros)."""
    from repro_torch.models.model import flatten, model_spec
    rng = np.random.default_rng(7)
    out = {}
    for path, s in flatten(model_spec(_tcfg(arch))).items():
        if s.init in ("ones", "zeros"):
            out[path] = np.full(s.shape, s.init == "ones", np.float32)
        else:
            scale = 0.006 if s.init == "small" else 0.02
            out[path] = (scale * rng.standard_normal(s.shape)).astype(
                np.float32)
    return out


def _inputs(arch) -> dict:
    """The prompt ((B, 3), audio (B, C, 3)) and, for the VLM, f32 image
    embeddings (B, n_image_tokens, D)."""
    kw = _cfg_kw(arch)
    rng = np.random.default_rng(3)
    lead = (B, kw["n_codebooks"]) if kw["n_codebooks"] else (B,)
    out = {"prompt": rng.integers(0, kw["vocab_size"], lead + (PROMPT,),
                                  dtype=np.int32)}
    if kw["n_image_tokens"]:
        out["images"] = (0.5 * rng.standard_normal(
            (B, kw["n_image_tokens"], kw["d_model"]))).astype(np.float32)
    return out


def _duck_mesh(shape):
    return SimpleNamespace(mesh_dim_names=("data", "model"), shape=shape)


# ------------------------------------------------------- JAX references

def _jax_serve(arch, max_seq, images=False) -> dict:
    """JAX's unsharded serving of one SMOKE model: ``greedy_generate``'s
    tokens, and the jitted prefill and decode steps fed the same tokens
    (with the images, fed their own argmax): every step's logits, as f32
    numpy, and the final cache."""
    import jax
    import jax.numpy as jnp
    from repro.models.config import ModelConfig
    from repro.training import serving as JS
    from repro_torch.models.model import unflatten
    jcfg = ModelConfig(**_cfg_kw(arch))
    jp = jax.tree_util.tree_map(jnp.asarray, unflatten(_weights(arch)))
    inp = _inputs(arch)
    prompt = jnp.asarray(inp["prompt"])
    img = jnp.asarray(inp["images"]) if images else None
    prefill = jax.jit(JS.make_prefill_step(jcfg, max_seq))
    decode = jax.jit(JS.make_decode_step(jcfg))
    state, logits = prefill(jp, prompt, img)
    steps = [np.asarray(logits, np.float32)]
    toks = []
    for _ in range(NEW - 1):
        toks.append(jnp.argmax(logits[:, -1], axis=-1).astype(
            jnp.int32)[:, None])
        state, logits = decode(jp, state, toks[-1], img)
        steps.append(np.asarray(logits, np.float32))
    toks.append(jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None])
    out = {"tokens": np.asarray(jnp.concatenate(toks, axis=1)),
           "logits": steps, "cache": _jflat(state.cache)}
    if not images:
        out["greedy"] = np.asarray(JS.greedy_generate(jcfg, jp, prompt, NEW,
                                                      max_seq))
    return out


def _jax_cache_layouts() -> dict:
    """{(arch, mesh, max_seq): {leaf: str(DTensor placements)}} of JAX's
    ``Rules.spec`` of JAX's ``cache_logical_axes`` at the cache's shapes,
    on duck-typed meshes."""
    import jax
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    from repro.models.sharding import Rules as JRules
    from repro_torch.models.model import flatten
    from repro_torch.models.sharding import placements
    out = {}
    cases = [(a, m, MAX_SEQ) for a in ARCHS for m in MESHES]
    cases += [(VLM, m, MAX_SEQ) for m in MESHES]
    cases += [(DENSE, (2, 2), WHOLE_T)] + [(DENSE, m, MAX_SEQ)
                                          for m in PAIRS]
    for arch, m, max_seq in set(cases):
        jcfg = ModelConfig(**_cfg_kw(arch))
        axes = flatten(JM.cache_logical_axes(jcfg))
        shapes = flatten(jax.eval_shape(
            lambda: JM.init_cache(jcfg, B, max_seq)))
        jm = SimpleNamespace(axis_names=("data", "model"),
                             shape=dict(zip(("data", "model"), m)))
        out[(arch, m, max_seq)] = {
            k: str(placements(JRules(jcfg.rule_overrides).spec(
                ax, jm, shapes[k].shape), _duck_mesh(m), len(ax)))
            for k, ax in axes.items()}
    return out


# ------------------------------------------------------------ the workers

def _worker(rank, port, q):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        q.put(("ok", rank, _run_checks()))
    except BaseException:
        q.put(("error", rank, f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_checks() -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import make_host_mesh
    meshes = {m: make_host_mesh(*m, device_type="cpu") for m in MESHES}
    for m, shape in PAIRS.items():
        meshes[m] = init_device_mesh(
            "cpu", shape, mesh_dim_names=("pair", "data", "model"))[
                "data", "model"]
    out = {}
    for m in MESHES:
        for arch in ARCHS:
            out[("greedy", arch, m)] = _greedy(meshes[m], arch, MAX_SEQ)
        out[("images", m)] = _with_images(meshes[m])
    out[("greedy", DENSE, "whole T")] = _greedy(meshes[(2, 2)], DENSE,
                                                WHOLE_T)
    for m in PAIRS:
        out[("greedy", DENSE, m)] = _greedy(meshes[m], DENSE, MAX_SEQ)
    return out


def _placed(mesh, arch):
    from repro_torch.models.model import place_params
    from repro_torch.models.weights import load_flat
    cfg = _tcfg(arch)
    return cfg, place_params(load_flat(_weights(arch), cfg, device="cpu"),
                             cfg, mesh)


def _layouts(cache) -> dict:
    """{leaf: (str(placements), local shape)} of a cache on the mesh."""
    from repro_torch.models.model import flatten
    return {k: (str(tuple(v.placements)), tuple(v.to_local().shape))
            for k, v in flatten(cache).items()}


def _greedy(mesh, arch, max_seq) -> dict:
    """``greedy_generate`` on the mesh: its tokens, the full logits of
    every step (read where it takes their argmax) and the cache's layout
    after the prefill and after each decode step."""
    from repro_torch.models.sharding import Rules
    from repro_torch.training import serving as TS
    cfg, params = _placed(mesh, arch)
    logits, layouts = [], []
    next_token, prefill_step, decode_step = (
        TS._next_token, TS.make_prefill_step, TS.make_decode_step)

    def spy_next(lg):
        logits.append(_np(lg))
        return next_token(lg)

    def spy(make):
        def factory(*args):
            step = make(*args)

            def run(*a):
                state, lg = step(*a)
                layouts.append(_layouts(state.cache))
                return state, lg
            return run
        return factory

    with mock.patch.object(TS, "_next_token", spy_next), \
            mock.patch.object(TS, "make_prefill_step", spy(prefill_step)), \
            mock.patch.object(TS, "make_decode_step", spy(decode_step)):
        toks = TS.greedy_generate(cfg, params, _inputs(arch)["prompt"], NEW,
                                  max_seq, rules=Rules(cfg.rule_overrides),
                                  mesh=mesh, device="cpu")
    return {"tokens": toks.numpy(), "logits": logits, "layouts": layouts}


def _with_images(mesh) -> dict:
    """The VLM's prefill and decode steps with its images on the mesh, fed
    their own argmax: tokens, every step's logits, the cache's layouts
    and its final values."""
    from repro_torch.models.model import flatten
    from repro_torch.models.sharding import Rules
    from repro_torch.training import serving as TS
    cfg, params = _placed(mesh, VLM)
    inp = _inputs(VLM)
    img = torch.from_numpy(inp["images"])
    rules = Rules(cfg.rule_overrides)
    prefill = TS.make_prefill_step(cfg, MAX_SEQ, rules, mesh)
    decode = TS.make_decode_step(cfg, rules, mesh)
    state, lg = prefill(params, torch.from_numpy(inp["prompt"]), img)
    logits, layouts, toks = [_np(lg)], [_layouts(state.cache)], []
    for _ in range(NEW - 1):
        toks.append(TS._next_token(lg))
        state, lg = decode(params, state, toks[-1], img)
        logits.append(_np(lg))
        layouts.append(_layouts(state.cache))
    toks.append(TS._next_token(lg))
    return {"tokens": torch.cat(toks, dim=1).numpy(), "logits": logits,
            "layouts": layouts,
            "cache": {k: _np(v) for k, v in flatten(state.cache).items()}}


# ----------------------------------------------------------- the job

@pytest.fixture(scope="module")
def job():
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # while the workers run; XLA compiles each on its thread
        with concurrent.futures.ThreadPoolExecutor(6) as pool:
            serve = {(a, MAX_SEQ): pool.submit(_jax_serve, a, MAX_SEQ)
                     for a in ARCHS}
            serve[(DENSE, WHOLE_T)] = pool.submit(_jax_serve, DENSE, WHOLE_T)
            serve["images"] = pool.submit(_jax_serve, VLM, MAX_SEQ, True)
            refs = {"serve": {k: f.result() for k, f in serve.items()},
                    "layouts": _jax_cache_layouts()}
        got = {}
        for _ in procs:
            status, rank, res = q.get(timeout=300)
            assert status == "ok", res
            got[rank] = res
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return refs, got


# -------------------------------------------------------------- checks

_IDS = {"ids": lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v}
_CASES = [(a, m) for m in MESHES for a in ARCHS]


def _check_run(r, want, layouts, what):
    """Tokens equal, every step's logits within ATOL, and the cache laid
    out per JAX's ``cache_logical_axes`` after the prefill and every
    decode step, each rank holding its shard."""
    np.testing.assert_array_equal(r["tokens"], want["tokens"], err_msg=what)
    assert len(r["logits"]) == len(want["logits"]) == NEW, what
    for i, (g, w) in enumerate(zip(r["logits"], want["logits"])):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0,
                                   err_msg=f"{what} step {i}")
    assert len(r["layouts"]) == NEW, what
    for i, lay in enumerate(r["layouts"]):
        assert {k: p for k, (p, _) in lay.items()} == layouts, (what, i)


def _local_t(lay, key) -> int:
    return lay[key][1][2]


@pytest.mark.parametrize("arch,mesh", _CASES, **_IDS)
def test_sharded_greedy_generate_matches_jax(job, arch, mesh):
    """``greedy_generate`` on the mesh gives JAX's tokens, the same on
    every rank; the prefill's and every decode step's logits within 1e-4
    of JAX's; audio's tokens keep JAX's (B, n, 1) (caveat 15)."""
    refs, got = job
    want = refs["serve"][(arch, MAX_SEQ)]
    np.testing.assert_array_equal(want["tokens"], want["greedy"])
    for rank, res in got.items():
        _check_run(res[("greedy", arch, mesh)], want,
                   refs["layouts"][(arch, mesh, MAX_SEQ)],
                   f"rank {rank} {arch} on {mesh}")
    if arch == AUDIO:
        assert got[0][("greedy", arch, mesh)]["tokens"].shape == (B, NEW, 1)


@pytest.mark.parametrize("arch,mesh", _CASES, **_IDS)
def test_sharded_cache_is_sequence_sharded(job, arch, mesh):
    """The cache's T lies over "model" as ``cache_logical_axes`` says: each
    rank holds max_seq / |model| positions of every GQA leaf, B / |data|
    rows, after the prefill and after each decode step."""
    _, got = job
    n, m = mesh
    for res in got.values():
        for lay in res[("greedy", arch, mesh)]["layouts"]:
            kv = [k for k in lay if k.endswith("/k") or k.endswith("/v")]
            assert kv
            for k in kv:
                assert lay[k][1][1:3] == (B // n, MAX_SEQ // m), (k, lay[k])


@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_decode_with_images_matches_jax(job, mesh):
    """The VLM with its images through ``make_prefill_step`` and
    ``make_decode_step``: JAX's tokens, every step's logits, and the final
    cache within 1e-4."""
    refs, got = job
    want = refs["serve"]["images"]
    for rank, res in got.items():
        r = res[("images", mesh)]
        _check_run(r, want, refs["layouts"][(VLM, mesh, MAX_SEQ)],
                   f"rank {rank} {mesh}")
        assert set(r["cache"]) == set(want["cache"])
        for k, w in want["cache"].items():
            np.testing.assert_allclose(r["cache"][k], w, atol=ATOL, rtol=0,
                                       err_msg=f"rank {rank} {k}")


def test_sharded_decode_over_a_whole_cache_t(job):
    """max_seq 15 on "model" 2: the divisibility guard keeps the cache's T
    whole (every rank holds all 15 positions of its rows) and decode takes
    the batch-only plan; tokens and logits are JAX's."""
    refs, got = job
    want = refs["serve"][(DENSE, WHOLE_T)]
    layouts = refs["layouts"][(DENSE, (2, 2), WHOLE_T)]
    assert all("Shard(dim=2)" not in p for p in layouts.values())
    for rank, res in got.items():
        r = res[("greedy", DENSE, "whole T")]
        _check_run(r, want, layouts, f"rank {rank}")
        assert _local_t(r["layouts"][-1], "seg0_dense/attn/k") == WHOLE_T


@pytest.mark.parametrize("mesh", list(PAIRS), **_IDS)
def test_dense_decode_on_two_ranks_matches_jax(job, mesh):
    """ROADMAP.md Queue 3 item 29: a dense model's decode on a (1, 2) and a
    (2, 1) mesh passed ``check_mesh`` and died in DTensor's bare
    ``AssertionError`` at the cache write; it now gives JAX's tokens and
    logits."""
    refs, got = job
    for rank, res in got.items():
        _check_run(res[("greedy", DENSE, mesh)],
                   refs["serve"][(DENSE, MAX_SEQ)],
                   refs["layouts"][(DENSE, mesh, MAX_SEQ)],
                   f"rank {rank} {mesh}")


# -------------------------------------------- without a process group

@pytest.mark.parametrize("arch", [
    "deepseek-67b", "qwen2-7b", "granite-3-8b", "mistral-large-123b",
    "mamba2-370m", "llama-3.2-vision-11b", "dbrx-132b", "deepseek-v3-671b",
    "jamba-1.5-large-398b", "musicgen-medium"])
def test_cache_logical_axes_match_jax(arch):
    """``model.cache_logical_axes`` is JAX's, leaf for leaf (GQA, MLA,
    Mamba2 and the hybrid's mixed cache)."""
    from repro.configs import registry as jreg
    from repro.models import model as JM
    from repro_torch.configs import get_arch
    from repro_torch.models import model as TM
    assert TM.cache_logical_axes(get_arch(arch, smoke=True)) == \
        JM.cache_logical_axes(jreg.get_arch(arch, smoke=True))


def _cut(x, n):
    return [t.contiguous() for t in x.chunk(n, dim=1)]


@pytest.mark.parametrize("fill", ["inside", "boundary", "full"])
@pytest.mark.parametrize("splits", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lse_combine_of_t_splits_matches_the_unsharded_call(dtype, splits,
                                                            fill):
    """Each T-split of a plain ``mha_fwd_ref`` decode call (GQA 8 over 2,
    S 1 and 3) at its local fill clamp(kv_len - r T_l, 0, T_l), combined
    by ``lse_combine``, against the unsharded call: ``inside`` fills 5 of
    the first split's 8 keys (every other split has none: out 0, lse
    about -1e30, weight 0), ``boundary`` ends at a split's end, ``full``
    fills every key."""
    from repro_torch.kernels.attention.ref import mha_fwd_ref
    from repro_torch.kernels.dispatch import lse_combine
    dt = getattr(torch, dtype)
    T = 32
    T_l = T // splits
    kv_len = {"inside": 5, "boundary": T_l * (splits // 2), "full": T}[fill]
    g = torch.Generator().manual_seed(splits)
    for S in (1, 3):
        q, k, v = (torch.randn(shape, generator=g).to(dt) for shape in (
            (2, S, 8, 16), (2, T, 2, 16), (2, T, 2, 16)))
        want = mha_fwd_ref(q, k, v, torch.tensor(kv_len), scale=0.25,
                           causal=False)[0].float()
        parts = [mha_fwd_ref(q, kr, vr, torch.tensor(kv_len - r * T_l)
                             .clamp(0, T_l), scale=0.25, causal=False)
                 for r, (kr, vr) in enumerate(zip(_cut(k, splits),
                                                  _cut(v, splits)))]
        got = lse_combine(torch.stack([o for o, _ in parts]),
                          torch.stack([lse for _, lse in parts])).to(dt)
        assert got.dtype == dt and got.shape == want.shape
        err = (got.float() - want).abs().max().item()
        assert err <= COMBINE_TOL[dtype] * want.abs().max().item(), (S, err)


def test_lse_combine_of_one_partial_is_exact():
    """With one "model" rank the combine is exp(0) out / 1: the partial
    itself, bitwise (the (1, 1) mesh's serving equals the unsharded)."""
    from repro_torch.kernels.dispatch import lse_combine
    g = torch.Generator().manual_seed(0)
    out = torch.randn((1, 2, 1, 4, 16), generator=g).to(torch.bfloat16)
    lse = torch.randn((1, 2, 4, 1), generator=g)
    assert torch.equal(lse_combine(out, lse).to(torch.bfloat16), out[0])


@pytest.mark.parametrize("arch", [DENSE, MOE, VLM, AUDIO])
def test_check_mesh_lets_gqa_decode_through(arch):
    """Mode decode on a mesh is ported for every GQA family: ``check_mesh``
    lets dense, MoE, the VLM and audio through."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as TM
    assert TM.check_mesh(get_arch(arch, smoke=True), _duck_mesh((1, 1)),
                         "forward", "decode") is None


@pytest.mark.parametrize("arch,match", [
    ("deepseek-v3-671b", "apply_mla_attention: decode on a mesh"),
    ("mamba2-370m", "the ssm segment's Mamba2"),
    ("jamba-1.5-large-398b", "the hybrid segment's Mamba2")])
def test_check_mesh_still_raises_for_mla_and_mamba2_decode(arch, match):
    """MLA's and Mamba2's decode on a mesh are not ported (ROADMAP.md
    12s-2): ``check_mesh`` raises ``NotImplementedError`` naming the
    segment and sharded serving, before any work."""
    from repro_torch.configs import get_arch
    from repro_torch.models import model as TM
    with pytest.raises(NotImplementedError,
                       match=match + ".*sharded serving"):
        TM.forward(None, get_arch(arch, smoke=True), None, mode="decode",
                   mesh=_duck_mesh((1, 1)))


def _sh(mesh, *spec):
    from repro_torch.models.sharding import NamedSharding, P
    return NamedSharding(mesh, P(*spec))


def test_plan_decode_follows_the_cache_layout():
    """A cache with T over "model" takes ``SeqSplitPlan`` (its batch axes
    and T axes); one whose T the guard left whole takes the batch-only
    ``AttnPlan``."""
    from repro_torch.kernels import dispatch as D
    m = _duck_mesh((2, 2))
    kv = (4, 16, 2, 16)
    plan = D._plan_decode(_sh(m, "data", "model", None, None), kv)
    assert isinstance(plan, D.SeqSplitPlan)
    assert (plan.batch_axes, plan.seq_axes) == (("data",), ("model",))
    plan = D._plan_decode(_sh(m, "data", None, None, None), kv)
    assert isinstance(plan, D.AttnPlan)
    assert (plan.batch_axes, plan.head_axes) == (("data",), ())


@pytest.mark.parametrize("kv_spec,match", [
    (("data", "model", "model", None), "shards its kv heads"),
    (("data", None, None, "model"), "shards its kv heads or head dim"),
    (("data", "model", None, None), "does not divide"),
    (None, "not on a mesh")],
    ids=["kv-heads", "head-dim", "indivisible", "no-mesh"])
def test_plan_decode_raises_naming_the_layout(kv_spec, match):
    """A cache layout the sequence-split plan cannot express raises
    ``NotImplementedError`` naming it, never a bare assertion."""
    from repro_torch.kernels import dispatch as D
    m = _duck_mesh((2, 2))
    kv = (4, 15, 2, 16) if match == "does not divide" else (4, 16, 2, 16)
    with pytest.raises(NotImplementedError, match=match):
        D._plan_decode(None if kv_spec is None else _sh(m, *kv_spec), kv)


def test_decode_attention_is_forward_only():
    """The decode plan has no backward: an operand that requires grad
    raises before any work."""
    from repro_torch.kernels import dispatch as D
    q = torch.zeros((1, 1, 2, 8), requires_grad=True)
    k = torch.zeros((1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="forward only"):
        D.decode_attention(q, k, k, scale=1.0, kv_len=torch.tensor(2))
