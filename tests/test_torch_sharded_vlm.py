"""The port's VLM (llama-3.2-vision-11b) and audio (musicgen-medium) on a
("data", "model") mesh against the JAX package's single-device numbers,
on the CPU.

One spawned ``gloo`` job of world 4 runs every check below and sends its
results back; the test process computes the JAX references while the
workers run (the workers import no JAX). Each worker runs torch on one
thread. JAX's own meshes fail under JAX 0.9.0 (ROADMAP.md Queue 3,
caveat 2), so every reference is JAX's unsharded layer, step or forward.

Checks:
  * the VLM's cross sub-layer (``apply_attention`` with ``kv_source``) on
    DTensors laid out per the rules (x per ("act_batch", "act_seq",
    "act_embed"), the images per ("act_batch", None, "act_embed"), the
    weights per ``attn_spec(cross=True)``) against JAX's cross
    ``apply_attention``, in f32 on (2, 2), (1, 4) and (4, 1): y and the
    gradients of x, of the images and of every leaf of sum(y * r). On
    (2, 2) and (4, 1) each rank runs the kernels' plain versions on its
    (B/n, S, H/m, hd) x (B/n, T, K/m, hd) shard; on (1, 4) the ``SMOKE``
    twin's 2 kv heads do not divide over "model" 4, so the plan is "ref"
    and no rank runs a kernel. One bf16 model with f32 images (ROADMAP.md
    reference caveat 13) on (2, 2) against JAX's kernel in interpret mode;
  * two ``make_train_step(rules=, mesh=)`` steps of both ``SMOKE`` twins
    on (2, 2), ``scale_fused`` and clip 1.0, against JAX's
    ``make_train_step`` without a mesh on the same batches (the VLM's with
    f32 image embeddings, musicgen's (B, C, S) tokens), each step from
    JAX's state before it: the loss, aux, ``grad_norm``, every parameter
    and the optimizer state (musicgen's (C, D, V) heads are one momentum
    leaf, its (C, V, D) embedding a first-group matrix: their column norms
    sum over the axes that shard the reduced dim);
  * prefill on (2, 2): the hidden states and the caches of both, and
    musicgen's (B, C, S, V) logits against JAX's, laid out as JAX's
    three-axis annotation lays them (ROADMAP.md reference caveat 16:
    "act_vocab" on S, V whole);
  * the VLM's forward without images (caveat 14) on (2, 2);
  * ``shard_batch``'s layouts of both batches under a rule override that
    maps "act_seq" to "model" (JAX's ``dryrun.input_specs`` axes). (Both
    models' decode on a mesh: ``tests/test_torch_sharded_serving.py``.)

Tolerances (sums across ranks run in another order than one device's):
  * the layer, f32: ``tests/test_torch_vlm.py``'s 1e-5 of the tensor's
    largest |ref| + 1e-5 relative; bf16 with f32 images: its 2e-2 (each
    side rounds the bf16 q, output and weight gradients at its own
    places);
  * train steps, f32: ``tests/test_torch_sharded.py``'s: params 8 ulps
    of the element's peak + 1e-5 of the leaf's step, the loss, aux and
    ``grad_norm`` 1e-5 relative; the norm scales, which SCALE gives to
    Adam, 1e-2 of their step (both unsharded files' ``VECTOR_REL``: Adam's
    step carries the rounding of a gradient that nearly cancels); the
    optimizer state: the VLM's head momentum 4e-6 of its largest |value|
    (``tests/test_torch_sharded.py``'s), musicgen's 2e-5
    (``tests/test_torch_musicgen.py``'s: 1 - beta times the clipped
    gradient, which carries the gradients' 1e-5), Adam's moments 2e-5;
  * prefill and the no-image forward, f32: 1e-4 absolute
    (``tests/test_torch_serving.py``'s).
"""
import concurrent.futures
import dataclasses
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

if not torch.distributed.is_available():
    pytest.skip("needs torch.distributed", allow_module_level=True)

from test_torch_sharded_mamba import (_free_port, _jax_model,  # noqa: E402
                                      _jflat, _np, _train_check, _ulp,
                                      _vector)

WORLD = 4
MESHES = ((2, 2), (1, 4), (4, 1))
VLM, AUDIO = "llama-3.2-vision-11b", "musicgen-medium"
ARCHS = (VLM, AUDIO)
# cross-layer case -> (model dtype, meshes); the images are f32 in both
LAYER_CASES = {"f32": ("float32", MESHES),
               "bf16-f32_images": ("bfloat16", ((2, 2),))}
LAYER_TOL = {"f32": 1e-5, "bf16-f32_images": 2e-2}
LAYER_BATCH = (4, 32)  # rows, text tokens (the SMOKE twin's 16 images)
TRAIN_BATCH, TRAIN_SEQ, STEPS = 4, 32, 2
PREFILL = (2, 32)
VECTOR_REL = 1e-2  # the Adam leaves' share of their step (docstring)
OPT_MU = {VLM: 4e-6, AUDIO: 2e-5}
OPT_ADAM = 2e-5
SEQ_OVER_MODEL = (("act_seq", ("model",)),)


def _cfg_kw(arch, over=None):
    """The SMOKE config's fields (f32 unless ``over``): plain data both
    packages' ``ModelConfig`` take."""
    from repro_torch.configs import get_arch
    return {**dataclasses.asdict(get_arch(arch, smoke=True)), **(over or {})}


def _tcfg(kw):
    from repro_torch.models import config as tconfig
    return tconfig.ModelConfig(**kw)


def _layer_inputs(case):
    """(config kwargs, the cross sub-layer's leaves, x, images, r) of one
    layer case, as f32 numpy (the leaves rounded to the model's dtype by
    each side)."""
    from repro_torch.models import layers as L
    dtype, _ = LAYER_CASES[case]
    kw = _cfg_kw(VLM, {"dtype": dtype})
    cfg = _tcfg(kw)
    rng = np.random.default_rng(11)
    p = {k: (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) for k, s in L.attn_spec(cfg, cross=True).items()}
    B, S = LAYER_BATCH
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    img = (0.5 * rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model))
           ).astype(np.float32)
    r = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return kw, p, x, img, r


def _batches() -> dict:
    """Each SMOKE model's config and train batches (numpy): the VLM's
    with f32 image embeddings, musicgen's (B, C, S) tokens and labels."""
    rng = np.random.default_rng(5)
    out = {}
    for arch in ARCHS:
        kw = _cfg_kw(arch)
        lead = ((TRAIN_BATCH, kw["n_codebooks"]) if kw["n_codebooks"]
                else (TRAIN_BATCH,))
        batches = []
        for _ in range(STEPS):
            b = {k: rng.integers(0, kw["vocab_size"], lead + (TRAIN_SEQ,),
                                 dtype=np.int32) for k in ("tokens", "labels")}
            if kw["n_image_tokens"]:
                b["image_embeds"] = (0.02 * rng.standard_normal(
                    (TRAIN_BATCH, kw["n_image_tokens"], kw["d_model"]))
                ).astype(np.float32)
            batches.append(b)
        out[arch] = {"cfg": kw, "batches": batches}
    return out


def _prefill_inputs(ref):
    """The first batch's first PREFILL rows and tokens (and images)."""
    B, S = PREFILL
    b = ref["batches"][0]
    return (b["tokens"][:B, ..., :S].copy(),
            None if "image_embeds" not in b else b["image_embeds"][:B].copy())


# ------------------------------------------------------- JAX references

def _jax_layer(case) -> dict:
    """JAX's unsharded cross ``apply_attention`` of one case, as f32 numpy:
    y and the gradients of sum(y * r) by x, the images and every leaf."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.models.config import ModelConfig
    from repro.models.sharding import Rules as JRules
    kw, p, x, img, r = _layer_inputs(case)
    jcfg = ModelConfig(**kw)
    dt = jcfg.jdtype
    S = x.shape[1]

    def loss(p, x, im):
        y, _ = JL.apply_attention(p, jcfg, x, jnp.arange(S), JRules(),
                                  mode="train", kv_source=im, causal=False)
        return jnp.sum(y * r), y

    (_, y), (gp, gx, gi) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            {k: jnp.asarray(v).astype(dt) for k, v in p.items()},
            jnp.asarray(x).astype(dt), jnp.asarray(img))

    def f32(a):
        return np.asarray(a.astype(jnp.float32))
    return {"y": f32(y), "grads": {"x": f32(gx), "images": f32(gi),
                                   **{k: f32(v) for k, v in gp.items()}}}


def _jax_forwards(ref, jp) -> dict:
    """JAX's prefill of one SMOKE model on ``_prefill_inputs`` (hidden
    states, cache; musicgen's logits), and the VLM's train-mode forward
    without images (caveat 14)."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    jcfg = ModelConfig(**ref["cfg"])
    toks, img = _prefill_inputs(ref)
    B, S = PREFILL
    im = None if img is None else jnp.asarray(img)

    def run(p, t):
        h, cache, _ = JM.forward(p, jcfg, t, image_embeds=im, mode="prefill",
                                 cache=JM.init_cache(jcfg, B, S))
        bare = JM.forward(p, jcfg, t)[0] if im is not None else h
        return h, cache, JM.logits_from_hidden(p, jcfg, h), bare

    h, cache, logits, bare = jax.jit(run)(jp, jnp.asarray(toks))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return {"hidden": f32(h), "cache": _jflat(cache), "logits": f32(logits),
            "no_images": f32(bare)}


def _jax_layouts() -> dict:
    """JAX's specs, as tuples, on a duck-typed (2, 2) mesh: each batch
    leaf's per ``launch/dryrun.py``'s ``input_specs`` under the override
    mapping "act_seq" to "model", and the audio logits' per their
    three-axis annotation under the default rules."""
    from types import SimpleNamespace
    from repro.models.config import ModelConfig
    from repro.models.sharding import Rules as JRules
    from test_torch_sharding import jax_input_specs
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 2})
    out = {}
    for arch in ARCHS:
        specs = jax_input_specs(ModelConfig(**_cfg_kw(arch)), TRAIN_BATCH,
                                TRAIN_SEQ, mesh, JRules(SEQ_OVER_MODEL))
        out.update({(arch, k): spec for k, (_, spec) in specs.items()})
    kw = _cfg_kw(AUDIO)
    shape = (PREFILL[0], kw["n_codebooks"], PREFILL[1], kw["vocab_size"])
    out["logits"] = tuple(JRules().spec(("act_batch", "act_seq",
                                         "act_vocab"), mesh, shape))
    return out


# ------------------------------------------------------------ the workers

def _worker(rank, port, inputs, q):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        q.put(("ok", rank, _run_checks(inputs)))
    except BaseException:
        q.put(("error", rank, f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_checks(inputs) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    meshes = {m: make_host_mesh(*m, device_type="cpu") for m in MESHES}
    out = {"layer": {(m, case): _layer_check(meshes[m], case)
                     for case, (_, ms) in LAYER_CASES.items()
                     for m in ms}}
    train, jsteps = inputs.get()
    out["train"] = {arch: _train_check(meshes[(2, 2)], train[arch],
                                       jsteps[arch]) for arch in ARCHS}
    out["forward"] = {arch: _forward_check(meshes[(2, 2)], train[arch])
                      for arch in ARCHS}
    out["batch_layouts"] = _batch_layouts(meshes[(2, 2)], train)
    return out


def _layer_check(mesh, case) -> dict:
    """The cross sub-layer on DTensors: y, every gradient, and the shapes
    of q and k each rank's attention kernels were given."""
    from unittest import mock

    from repro_torch.kernels import dispatch
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import (IMAGE_AXES, Rules, mesh_context,
                                             place)
    rules = Rules()
    kw, p, x, img, r = _layer_inputs(case)
    cfg = _tcfg(kw)
    dt = cfg.torch_dtype
    spec = L.attn_spec(cfg, cross=True)
    pd = {k: place(torch.from_numpy(v).to(dt), rules.sharding(
        spec[k].axes, mesh, v.shape)).detach().requires_grad_()
        for k, v in p.items()}
    xs = rules.sharding(("act_batch", "act_seq", "act_embed"), mesh, x.shape)
    xd = place(torch.from_numpy(x).to(dt), xs).detach().requires_grad_()
    imd = place(torch.from_numpy(img), rules.sharding(
        IMAGE_AXES, mesh, img.shape)).detach().requires_grad_()
    seen = []
    real = dispatch._attention

    def spy(q, k, *args):
        seen.append((tuple(q.shape), tuple(k.shape), str(q.dtype)))
        return real(q, k, *args)

    with mock.patch.object(dispatch, "_attention", spy), mesh_context(mesh):
        y, cache = L.apply_attention(pd, cfg, xd, torch.arange(x.shape[1]),
                                     "train", rules=rules, mesh=mesh,
                                     kv_source=imd)
        total = (y * place(torch.from_numpy(r), xs)).sum()
        grads = torch.autograd.grad(total, [xd, imd, *pd.values()])
    return {"y": _np(y), "dtype": str(y.dtype), "cache": cache,
            "grads": {k: _np(g) for k, g in zip(["x", "images", *pd],
                                                 grads)},
            "grad_dtypes": {k: str(g.dtype) for k, g in
                            zip(["x", "images", *pd], grads)},
            "seen": seen}


def _forward_check(mesh, ref) -> dict:
    """Prefill on the mesh (hidden states, cache, logits and their
    layout) and the VLM's forward without images."""
    from repro_torch.models import init_cache
    from repro_torch.models.model import (flatten, forward,
                                          logits_from_hidden, place_params)
    from repro_torch.models.sharding import Rules, lay_out
    from repro_torch.models.weights import load_flat
    cfg = _tcfg(ref["cfg"])
    rules = Rules()
    params = place_params(load_flat(ref["init"], cfg, device="cpu"), cfg,
                          mesh)
    toks, img = _prefill_inputs(ref)
    B, S = PREFILL
    axes = ("act_batch", None, "act_seq") if toks.ndim == 3 else \
        ("act_batch", "act_seq")
    toks = lay_out(torch.from_numpy(toks), rules.sharding(axes, mesh,
                                                          toks.shape))
    img = None if img is None else torch.from_numpy(img)
    with torch.no_grad():
        h, cache, _ = forward(params, cfg, toks, image_embeds=img,
                              mode="prefill",
                              cache=init_cache(cfg, B, S, device="cpu"),
                              rules=rules, mesh=mesh)
        logits = logits_from_hidden(params, cfg, h, rules)
        bare = (forward(params, cfg, toks, rules=rules, mesh=mesh)[0]
                if img is not None else h)
    return {"hidden": _np(h), "logits": _np(logits),
            "logits_layout": str(tuple(logits.placements)),
            "cache": {k: _np(v) for k, v in flatten(cache).items()},
            "no_images": _np(bare)}


def _batch_layouts(mesh, train) -> dict:
    """``shard_batch``'s placements of each model's first batch under the
    override mapping "act_seq" to "model"."""
    from repro_torch.models.sharding import Rules, shard_batch
    out = {}
    for arch, ref in train.items():
        b = shard_batch({k: torch.from_numpy(v) for k, v in
                         ref["batches"][0].items()}, mesh,
                        Rules(SEQ_OVER_MODEL))
        out.update({(arch, k): str(tuple(v.placements))
                    for k, v in b.items()})
    return out


# ----------------------------------------------------------- the job

@pytest.fixture(scope="module")
def job():
    ctx = torch.multiprocessing.get_context("spawn")
    q, inputs = ctx.Queue(), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, inputs, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        # while the workers run the layer; XLA compiles each on its thread
        train = _batches()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            models = {arch: pool.submit(_jax_model, train[arch])
                      for arch in ARCHS}
            layer_f = {case: pool.submit(_jax_layer, case)
                       for case in LAYER_CASES}
            models = {arch: f.result() for arch, f in models.items()}
            for arch, (_, traj) in models.items():
                train[arch]["init"] = traj[0]["old"]
            jsteps = {arch: m[1] for arch, m in models.items()}
            for _ in procs:
                inputs.put((train, jsteps))
            fwd_f = {arch: pool.submit(_jax_forwards, train[arch], m[0])
                     for arch, m in models.items()}
            refs = {"train": jsteps,
                    "forward": {k: f.result() for k, f in fwd_f.items()},
                    "layer": {k: f.result() for k, f in layer_f.items()},
                    "layouts": _jax_layouts()}
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

def _close(got, want, tol, what):
    """Per element within tol * max|want| + tol * |want|."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert scale > 0 and np.isfinite(got).all(), what
    assert (err <= tol * scale + tol * np.abs(want)).all(), (
        what, float(err.max() / scale))


_IDS = {"ids": lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v}
_LAYERS = [(m, c) for c, (_, ms) in LAYER_CASES.items() for m in ms]


@pytest.mark.parametrize("mesh,case", _LAYERS, **_IDS)
def test_sharded_cross_attention_matches_jax(job, mesh, case):
    """y on every rank and the gradients of x, the images and every leaf
    of sum(y * r), each whole, against JAX's unsharded cross sub-layer: a
    partial counted twice or left out (the images' gradient sums over the
    kv heads' ranks) shows as a factor. In a bf16 model with f32 images y
    and the weights' gradients are bf16 and the images' f32 (caveat 13)."""
    refs, got = job
    want = refs["layer"][case]
    tol = LAYER_TOL[case]
    dt = "torch.float32" if case == "f32" else "torch.bfloat16"
    for rank, res in got.items():
        r = res["layer"][(mesh, case)]
        assert r["cache"] is None and r["dtype"] == dt
        _close(r["y"], want["y"], tol, f"rank {rank} y")
        assert set(r["grads"]) == set(want["grads"]) == {
            "x", "images", "wq", "wk", "wv", "wo"}
        for k, w in want["grads"].items():
            _close(r["grads"][k], w, tol, f"rank {rank} {k}")
            assert r["grad_dtypes"][k] == (
                "torch.float32" if k == "images" else dt), k


@pytest.mark.parametrize("mesh,case", _LAYERS, **_IDS)
def test_sharded_cross_attention_keeps_its_heads_local(job, mesh, case):
    """Each rank's attention kernels take its B/n rows and its H/m query
    heads over K/m kv heads, in f32 when the images are (caveat 13's
    promotion); where the SMOKE twin's 2 kv heads do not divide over
    "model" 4 the plan is "ref" and no kernel runs."""
    _, got = job
    kw = _cfg_kw(VLM)
    B, S = LAYER_BATCH
    H, K, hd, T = (kw["n_heads"], kw["n_kv_heads"], kw["head_dim"],
                   kw["n_image_tokens"])
    n, m = mesh
    for rank, res in got.items():
        seen = res["layer"][(mesh, case)]["seen"]
        if K % m:
            assert seen == [], rank
        else:
            assert seen == [((B // n, S, H // m, hd), (B // n, T, K // m, hd),
                             "torch.float32")], rank


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_steps_match_jax(job, arch, step):
    """The loss, aux and ``grad_norm`` on every rank, every parameter and
    the optimizer state (SCALE's momentum of the head, Adam's moments)
    against JAX's unsharded step from the same state."""
    refs, got = job
    ref = refs["train"][arch][step]
    for rank, res in got.items():
        g = res["train"][arch]["traj"][step]
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], ref[k], rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")
    g = got[0]["train"][arch]["traj"][step]
    assert set(g["params"]) == set(ref["params"])
    for k, w in ref["params"].items():
        old = ref["old"][k]
        dw = np.abs(w - old)
        rel = VECTOR_REL if _vector(k, w) else 1e-5
        tol = 8 * _ulp(np.maximum(np.abs(old), np.maximum(np.abs(w), dw)),
                       "float32") + rel * dw.max()
        err = np.abs(g["params"][k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
    opt = {k: v for k, v in ref["opt"].items() if k != "count" and v.size}
    assert set(opt) == set(g["opt"])
    for k, w in opt.items():
        path = k.split("/", 1)[1]
        scale = OPT_ADAM if _vector(path, ref["params"][path]) else \
            OPT_MU[arch]
        err = np.abs(g["opt"][k] - w)
        assert (err <= scale * np.abs(w).max()).all(), (
            k, float(err.max() / np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_layouts(job, arch):
    """On (2, 2) the leaves lie as their specs say: the cross sub-layer's
    wk (L, D, K*hd) D over "data" and its columns over "model"; musicgen's
    (C, V, D) embedding V over "model" and D over "data", its (C, D, V)
    heads the other way round, C whole."""
    _, got = job
    lay = got[0]["train"][arch]["layouts"]
    if arch == VLM:
        assert lay["segments/seg0_vlm/cross/wk"] == (
            "(Shard(dim=1), Shard(dim=2))")
        assert lay["segments/seg0_vlm/cross/wo"] == (
            "(Shard(dim=2), Shard(dim=1))")
    else:
        assert lay["tok_embed/w"] == "(Shard(dim=2), Shard(dim=1))"
        assert lay["lm_head/w"] == "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_matches_jax(job, arch):
    """The hidden states, every cache leaf and the logits ((B, C, S, V)
    for musicgen) against JAX's prefill; the VLM's with its images."""
    refs, got = job
    want = refs["forward"][arch]
    for rank, res in got.items():
        r = res["forward"][arch]
        for k in ("hidden", "logits"):
            np.testing.assert_allclose(r[k], want[k], atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {k}")
        assert set(r["cache"]) == set(want["cache"])
        for k, w in want["cache"].items():
            np.testing.assert_allclose(r["cache"][k], w, atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {k}")


def test_sharded_audio_logits_lay_seq_over_model(job):
    """musicgen's (B, C, S, V) logits take JAX's three-axis annotation on
    their first three dims (caveat 16): B over "data", S (where
    "act_vocab" lands) over "model", V whole."""
    refs, got = job
    assert refs["layouts"]["logits"] == ("data", None, "model")
    for res in got.values():
        assert res["forward"][AUDIO]["logits_layout"] == (
            "(Shard(dim=0), Shard(dim=2))")


def test_sharded_vlm_without_images_matches_jax(job):
    """The VLM's forward with no images (caveat 14: the cross sub-layers
    run causal self-attention over the text) on the mesh against JAX's."""
    refs, got = job
    for rank, res in got.items():
        np.testing.assert_allclose(res["forward"][VLM]["no_images"],
                                   refs["forward"][VLM]["no_images"],
                                   atol=1e-4, rtol=0, err_msg=f"rank {rank}")


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_batch_lays_leaves_out_as_jax_under_an_override(job, arch):
    """With "act_seq" over "model", ``shard_batch`` splits the text (B, S)
    leaves' S, an audio batch's S (not its codebook axis) and never the
    images' T, as JAX's ``input_specs`` axes do."""
    from types import SimpleNamespace

    from repro_torch.models.sharding import placements
    refs, got = job
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    keys = [k for k in refs["layouts"] if k[0] == arch]
    assert keys
    for res in got.values():
        for key in keys:
            spec = refs["layouts"][key]
            want = str(placements(spec, mesh, len(spec)))
            assert res["batch_layouts"][key] == want, key
    if arch == AUDIO:
        assert refs["layouts"][(AUDIO, "tokens")] == ("data", None, "model")
    else:
        assert refs["layouts"][(VLM, "image_embeds")] == ("data", None, None)


def test_batch_axes_follow_the_leaf():
    """``batch_axes`` keys JAX's input layouts by leaf name and rank: the
    packed-document leaves too take ("act_batch", "act_seq")."""
    from repro_torch.models.sharding import batch_axes
    assert batch_axes("tokens", 2) == ("act_batch", "act_seq")
    for k in ("positions", "segment_ids", "loss_weights"):
        assert batch_axes(k, 2) == ("act_batch", "act_seq")
    assert batch_axes("labels", 3) == ("act_batch", None, "act_seq")
    assert batch_axes("image_embeds", 3) == ("act_batch", None, "act_embed")
