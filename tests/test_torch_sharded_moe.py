"""The port's expert-parallel MoE and MLA on a ("data", "model") mesh
against the JAX package's single-device numbers, on the CPU.

One spawned ``gloo`` job of world 4 runs every check below and sends its
results back; the test process computes the JAX references while the
workers run (the workers import no JAX: the JAX imports of this module
sit inside the functions that run here only). Each worker runs torch on
one thread. JAX's own meshes fail under JAX 0.9.0 (ROADMAP.md Queue 3,
caveat 2), so every reference is JAX's unsharded layer or step.

Checks, on meshes (2, 2) and (1, 4):
  * ``apply_moe`` on DTensors laid out per the rules (x over "data", the
    experts over "model", the expert leaves' and the router's embed dim
    over "data") against JAX's ``apply_moe``, in f32: y, aux and the
    gradients of x, the router, the experts and the shared experts of
    sum(y * r) + c * aux. Cases: dbrx-132b's ``SMOKE`` layer (E 4, top-2)
    with 4 groups split over "data"; deepseek-v3's (E 8, top-2, a shared
    expert); E 6, which (1, 4) cannot split (the experts stay whole and no
    combine sum runs); one group on data 2 (every rank routes all tokens
    and cuts its rows back out); a batch of one row that "data" cannot
    split but its 4 groups can (each rank takes its groups); and the aux
    weighted 1.0, where counting its gradient once per "model" rank would
    show in the router's gradient. Each rank's expert slices and its
    (G_l, E/M, C, D) buffer are E/M wide: nothing is gathered over
    "model";
  * two ``make_train_step(rules=, mesh=)`` steps of dbrx-132b's and
    deepseek-v3's ``SMOKE`` (MoE; MLA and MoE) on (2, 2), ``scale_fused``
    and clip 1.0, against JAX's ``make_train_step`` without a mesh from
    the same weights (JAX's init) and batches: the loss, aux, ``grad_norm``, every
    parameter (the 4-D expert leaves, whose column sums of squares run
    over their data-sharded embed dim, included) and the momentum. Both
    configs take ``moe_group_size`` 32, so a step's 128 tokens form 4
    groups split over "data". MLA's q_full, k_full and vv reach the
    attention laid out (batch over "data", heads over "model");
  * deepseek-v3's ``SMOKE`` forward in mode prefill on (2, 2): the hidden
    states and the latent cache against JAX's; and mode decode on the
    mesh raises before any work (sharded serving).

Tolerances (sums across ranks run in another order than one device's):
  * the layer, f32 (``tests/test_torch_moe.py``'s, whose inputs these
    copy: dyadic activations and router weights, so both sides route
    alike): y and aux 1e-5 absolute + 1e-5 relative, each gradient 1e-5
    of its leaf's largest |ref| + 1e-5 relative;
  * train steps, f32: ``tests/test_torch_sharded.py``'s (the unsharded
    trainer parity's): params 8 ulps of the element's peak + 1e-5 of the
    leaf's travel, momentum 4e-6 of the leaf's max, loss, aux and
    ``grad_norm`` 1e-5 relative;
  * prefill, f32: ``tests/test_torch_mla.py``'s 1e-4 absolute for the
    hidden states and the cache.
"""
import concurrent.futures
import dataclasses
import socket
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

if not torch.distributed.is_available():
    pytest.skip("needs torch.distributed", allow_module_level=True)

WORLD = 4
MESHES = ((2, 2), (1, 4))
ARCHS = ("dbrx-132b", "deepseek-v3-671b")
# case -> (arch of the SMOKE layer, config overrides, (B, S), aux weight c)
MOE_CASES = {
    "dbrx": ("dbrx-132b", {"moe_group_size": 32}, (4, 32), 0.01),
    "deepseek": ("deepseek-v3-671b", {"moe_group_size": 32}, (4, 32),
                 0.01),
    "e6": ("dbrx-132b", {"n_experts": 6, "moe_group_size": 32}, (4, 32),
           0.01),
    "g1": ("dbrx-132b", {}, (2, 32), 0.01),
    "b1": ("dbrx-132b", {"moe_group_size": 32}, (1, 128), 0.01),
    "aux": ("dbrx-132b", {"moe_group_size": 32}, (4, 32), 1.0),
}
TRAIN_BATCH, TRAIN_SEQ, STEPS = 4, 32, 2
TRAIN_GROUP = 32   # moe_group_size of the train steps: 4 groups of 32
PREFILL = (2, 16)  # deepseek-v3 SMOKE's prefill batch
_MANT = {"float32": 23, "bfloat16": 7}


def _cfg_kw(arch, over):
    """The SMOKE config's fields (f32) with ``over``: plain data both
    packages' ``ModelConfig`` take."""
    from repro_torch.configs import get_arch
    return {**dataclasses.asdict(get_arch(arch, smoke=True)), **over}


def _tcfg(kw):
    from repro_torch.models import config as tconfig
    return tconfig.ModelConfig(**kw)


def _moe_inputs(case):
    """(config kwargs, params, x, r, c) of one layer case, as numpy: x and
    the router dyadic (small integers over powers of two), so the router
    logits are exact on both sides and both route alike."""
    arch, over, (B, S), c = MOE_CASES[case]
    kw = _cfg_kw(arch, over)
    D, E, Fd = kw["d_model"], kw["n_experts"], kw["moe_d_ff"]
    rng = np.random.default_rng(41 + list(MOE_CASES).index(case))
    f32 = np.float32
    p = {"router": (np.round(rng.standard_normal((D, E)) * 8) / 256
                    ).astype(f32),
         "w_gate": (rng.standard_normal((E, D, Fd)) / np.sqrt(D)).astype(f32),
         "w_up": (rng.standard_normal((E, D, Fd)) / np.sqrt(D)).astype(f32),
         "w_down": (rng.standard_normal((E, Fd, D)) / np.sqrt(Fd)
                    ).astype(f32)}
    if kw["n_shared_experts"]:
        Fs = Fd * kw["n_shared_experts"]
        p.update(shared_gate=(rng.standard_normal((D, Fs)) / np.sqrt(D)
                              ).astype(f32),
                 shared_up=(rng.standard_normal((D, Fs)) / np.sqrt(D)
                            ).astype(f32),
                 shared_down=(rng.standard_normal((Fs, D)) / np.sqrt(Fs)
                              ).astype(f32))
    x = (np.round(rng.standard_normal((B, S, D)) * 4) / 4).astype(f32)
    r = rng.standard_normal((B, S, D)).astype(f32)
    return kw, p, x, r, c


# ------------------------------------------------------- JAX references

def _train_inputs() -> tuple:
    """Each SMOKE model's JAX weights and batches, as numpy (the train
    steps' inputs on both sides), and the JAX weights as they are."""
    import jax
    import jax.numpy as jnp
    from repro.core.labels import path_str
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    out, trees = {}, {}
    rng = np.random.default_rng(3)
    for arch in ARCHS:
        kw = _cfg_kw(arch, {"moe_group_size": TRAIN_GROUP})
        jcfg = ModelConfig(**kw)
        jp = trees[arch] = jax.jit(lambda key: JM.init_params(key, jcfg))(
            jax.random.PRNGKey(0))
        leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
        out[arch] = {
            "cfg": kw,
            "init": {path_str(p).lstrip("."): np.asarray(
                x.astype(jnp.float32)) for p, x in leaves},
            "batches": [{k: rng.integers(0, kw["vocab_size"],
                                         (TRAIN_BATCH, TRAIN_SEQ),
                                         dtype=np.int32)
                         for k in ("tokens", "labels")}
                        for _ in range(STEPS)]}
    return out, trees


def _jax_refs(train: dict, trees: dict) -> dict:
    """Every JAX number the checks compare with, as numpy; ``train`` and
    ``trees`` ``_train_inputs``'."""
    import jax
    import jax.numpy as jnp
    from repro.core import make_optimizer as j_make
    from repro.core.labels import path_str
    from repro.models import layers as JL
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    from repro.models.sharding import Rules as JRules
    from repro.training import trainer as JT

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    def jflat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {path_str(p).lstrip("."): (np.asarray(x) if x.dtype
                                          == jnp.int32 else f32(x))
                for p, x in leaves}

    def moe(case):
        kw, p, x, r, c = _moe_inputs(case)
        jcfg = ModelConfig(**kw)

        def loss(p, x):
            y, aux = JL.apply_moe(p, jcfg, x, JRules())
            return jnp.sum(y * r) + c * aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
        return {"y": f32(y), "aux": f32(aux),
                "grads": {"x": f32(gx), **{k: f32(v) for k, v in
                                           gp.items()}}}

    def steps(arch):
        t = train[arch]
        jcfg = ModelConfig(**t["cfg"])
        tx = j_make("scale_fused", 1e-2)
        step = jax.jit(JT.make_train_step(jcfg, tx, clip_norm=1.0))
        js = JT.init_state(trees[arch], tx)
        traj = []
        for b in t["batches"]:
            old = jflat(js.params)
            js, jm = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            traj.append({"old": old, "params": jflat(js.params),
                         "opt": jflat(js.opt_state),
                         **{k: float(jm[k]) for k in ("loss", "aux",
                                                      "grad_norm")}})
        return traj

    def prefill():
        arch = "deepseek-v3-671b"
        jcfg = ModelConfig(**train[arch]["cfg"])
        B, S = PREFILL
        toks = train[arch]["batches"][0]["tokens"][:B, :S]
        h, cache, _ = jax.jit(lambda p, t: JM.forward(
            p, jcfg, t, mode="prefill", cache=JM.init_cache(jcfg, B, S)))(
                trees[arch], jnp.asarray(toks))
        return {"hidden": f32(h), "cache": jflat(cache)}

    # XLA compiles each on its own thread
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        train_f = {arch: pool.submit(steps, arch) for arch in ARCHS}
        prefill_f = pool.submit(prefill)
        moe_f = {case: pool.submit(moe, case) for case in MOE_CASES}
        return {"moe": {k: f.result() for k, f in moe_f.items()},
                "train": {k: f.result() for k, f in train_f.items()},
                "prefill": prefill_f.result()}


# ------------------------------------------------------------ the workers

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, inputs, q):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res = _run_checks(inputs)
        q.put(("ok", rank, res))
    except BaseException:
        q.put(("error", rank, f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_checks(inputs) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    meshes = {m: make_host_mesh(*m, device_type="cpu") for m in MESHES}
    out = {"moe": {(m, case): _moe_check(mesh, case)
                   for m, mesh in meshes.items() for case in MOE_CASES}}
    train = inputs.get()  # the JAX weights, made while the layer ran
    out["train"] = {arch: _train_check(meshes[(2, 2)], train[arch])
                    for arch in ARCHS}
    out["prefill"] = _prefill_check(meshes[(2, 2)],
                                    train["deepseek-v3-671b"])
    return out


def _np(x):
    # a copy: a replicated DTensor's full value is its live local tensor
    from repro_torch.models.sharding import full_value
    return full_value(x).detach().float().numpy().copy()


def _shapes_of(fn):
    """fn wrapped to record the shape of every op output it makes (its
    forward) and of its arguments' expert slices."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = {"outputs": set(), "slices": []}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    seen["outputs"].add(tuple(t.shape))
            return out

    def wrapped(p, cfg, xg, experts=None, reduce=None, **kw):
        seen["slices"].append({k: tuple(p[k].shape)
                               for k in ("w_gate", "w_up", "w_down")})
        seen["xg"] = tuple(xg.shape)
        seen["experts"] = experts
        with Record():
            return fn(p, cfg, xg, experts, reduce, **kw)
    return wrapped, seen


def _moe_check(mesh, case) -> dict:
    from unittest import mock

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L
    from repro_torch.models.sharding import Rules, place
    rules = Rules()
    kw, p, x, r, c = _moe_inputs(case)
    cfg = _tcfg(kw)
    spec = L.moe_spec(cfg)
    pd = {k: place(torch.from_numpy(v), rules.sharding(
        spec[k].axes, mesh, v.shape)).detach().requires_grad_()
        for k, v in p.items()}
    xs = rules.sharding(("act_batch", "act_seq", "act_embed"), mesh, x.shape)
    xd = place(torch.from_numpy(x), xs).detach().requires_grad_()
    wrapped, seen = _shapes_of(L.moe_local)
    with mock.patch.object(L, "moe_local", wrapped), implicit_replication():
        y, aux = L.apply_moe(pd, cfg, xd, rules=rules, mesh=mesh)
        total = (y * place(torch.from_numpy(r), xs)).sum() + c * aux
        grads = torch.autograd.grad(total, [xd, *pd.values()])
    return {"y": _np(y), "aux": _np(aux),
            "grads": {k: _np(g) for k, g in zip(["x", *pd], grads)},
            "placements": {k: str(tuple(v.placements))
                           for k, v in pd.items()},
            "seen": seen}


def _train_check(mesh, ref) -> dict:
    from unittest import mock

    from repro_torch.core import make_optimizer
    from repro_torch.kernels import dispatch
    from repro_torch.models.model import flatten, place_params
    from repro_torch.models.sharding import Rules
    from repro_torch.models.weights import load_flat
    from repro_torch.training import init_state, make_train_step
    cfg = _tcfg(ref["cfg"])
    params = place_params(load_flat(ref["init"], cfg, device="cpu"), cfg,
                          mesh)
    tx = make_optimizer("scale_fused", 1e-2)
    step = make_train_step(cfg, tx, clip_norm=1.0, rules=Rules(), mesh=mesh)
    state = init_state(params, tx)
    attn = []
    real = dispatch.flash_attention

    def seen_attention(q, k, v, **kw):
        attn.append(tuple(str(tuple(t.placements)) for t in (q, k, v)))
        return real(q, k, v, **kw)

    traj = []
    with mock.patch.object(dispatch, "flash_attention", seen_attention):
        for b in ref["batches"]:
            state, m = step(state, {k: torch.from_numpy(x) for k, x in
                                    b.items()})
            traj.append({**{k: float(m[k]) for k in ("loss", "aux",
                                                     "grad_norm")},
                         "params": {k: _np(p) for k, p in
                                    flatten(state.params).items()},
                         "mu": {k: _np(x) for k, x in
                                state.opt_state.mu.items() if x.numel()}})
    return {"traj": traj, "attention": sorted(set(attn)),
            "layouts": {k: str(tuple(p.placements)) for k, p in
                        flatten(state.params).items()}}


def _prefill_check(mesh, ref) -> dict:
    from repro_torch.models import init_cache
    from repro_torch.models.model import flatten, forward, place_params
    from repro_torch.models.sharding import Rules, lay_out
    from repro_torch.models.weights import load_flat
    cfg = _tcfg(ref["cfg"])
    rules = Rules()
    params = place_params(load_flat(ref["init"], cfg, device="cpu"), cfg,
                          mesh)
    B, S = PREFILL
    toks = torch.from_numpy(ref["batches"][0]["tokens"][:B, :S].copy())
    toks = lay_out(toks, rules.sharding(("act_batch", "act_seq"), mesh,
                                        toks.shape))
    with torch.no_grad():
        h, cache, _ = forward(params, cfg, toks, mode="prefill",
                              cache=init_cache(cfg, B, S, device="cpu"),
                              rules=rules, mesh=mesh)
    try:
        forward(params, cfg, toks[:, :1], mode="decode",
                cache=init_cache(cfg, B, S, device="cpu"),
                cache_index=torch.tensor(S - 1), rules=rules, mesh=mesh)
        decode = None
    except NotImplementedError as e:
        decode = str(e)
    return {"hidden": _np(h),
            "cache": {k: _np(v) for k, v in flatten(cache).items()},
            "decode": decode}


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
        # while the workers run
        train, trees = _train_inputs()
        for _ in procs:
            inputs.put(train)
        refs = _jax_refs(train, trees)
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

def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


_IDS = {"ids": lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_moe_forward_matches_jax(job, mesh, case):
    """y and aux of every rank against JAX's unsharded layer."""
    refs, got = job
    want = refs["moe"][case]
    for rank, res in got.items():
        r = res["moe"][(mesh, case)]
        np.testing.assert_allclose(r["y"], want["y"], atol=1e-5, rtol=1e-5,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(r["aux"], want["aux"], rtol=1e-5,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_moe_gradients_match_jax(job, mesh, case):
    """The gradients of x, the router, the experts and the shared experts
    of sum(y * r) + c * aux, each leaf whole, against JAX's."""
    refs, got = job
    want = refs["moe"][case]["grads"]
    r = got[0]["moe"][(mesh, case)]
    assert set(r["grads"]) == set(want)
    for k, w in want.items():
        scale = np.abs(w).max()
        err = np.abs(r["grads"][k] - w)
        assert scale > 0 and (err <= 1e-5 * scale + 1e-5 * np.abs(w)).all(), (
            k, float(err.max() / scale))


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_moe_keeps_its_experts_local(job, mesh, case):
    """Each rank runs E/M experts on its own (G_l, E/M, C, D) buffer,
    where the rules split E over "model" (M ranks), and all E where they
    cannot (E 6 on model 4); no op of the route makes an E-wide expert
    buffer or leaf then. The groups: G over "data" where G divides, whole
    where it does not (one group on data 2)."""
    from repro_torch.models.layers import moe_groups
    _, got = job
    kw = _cfg_kw(MOE_CASES[case][0], MOE_CASES[case][1])
    E, D, Fd = kw["n_experts"], kw["d_model"], kw["moe_d_ff"]
    B, S = MOE_CASES[case][2]
    G, Tg, C = moe_groups(_tcfg(kw), B * S)
    M = mesh[1] if E % mesh[1] == 0 else 1
    El = E // M
    Gl = G // mesh[0] if G % mesh[0] == 0 else G
    assert (case == "e6" and mesh == (1, 4)) == (M == 1)
    assert (case == "g1") == (G == 1)
    # E-wide: the expert leaves, the buffers, the masks (G_l, Tg, E, C)
    wide = {(E, D, Fd), (E, Fd, D), (Gl, E, C, D), (Gl, E, C, Fd),
            (E, Gl * C, D), (E, Gl * C, Fd), (Gl, Tg, E, C)}
    for rank, res in got.items():
        seen = res["moe"][(mesh, case)]["seen"]
        assert seen["xg"] == (Gl, Tg, D)
        r = rank % mesh[1] if M > 1 else 0
        assert tuple(seen["experts"]) == (r * El, (r + 1) * El)
        assert seen["slices"] == [{"w_gate": (El, D, Fd),
                                   "w_up": (El, D, Fd),
                                   "w_down": (El, Fd, D)}]
        out = seen["outputs"]
        assert (Gl, El, C, D) in out and (Gl, El, C, Fd) in out
        if El < E:
            assert not wide & out, sorted(wide & out)


def test_sharded_apply_moe_lays_the_experts_out_per_the_rules(job):
    """The expert leaves over ("experts" -> model, "embed" -> data), the
    router's embed dim over "data", the shared experts as an MLP."""
    _, got = job
    lay = got[0]["moe"][((2, 2), "deepseek")]["placements"]
    assert lay["w_gate"] == "(Shard(dim=1), Shard(dim=0))"
    assert lay["w_down"] == "(Shard(dim=2), Shard(dim=0))"
    assert lay["router"] == "(Shard(dim=0), Replicate())"
    assert lay["shared_gate"] == "(Shard(dim=0), Shard(dim=1))"
    assert lay["shared_down"] == "(Shard(dim=1), Shard(dim=0))"


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_train_steps_match_jax(job, arch, step):
    """The loss, aux and ``grad_norm`` on every rank, every parameter and
    the momentum against JAX's unsharded steps."""
    refs, got = job
    ref = refs["train"][arch]
    for rank, res in got.items():
        g = res["train"][arch]["traj"][step]
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(g[k], ref[step][k], rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")
    g = got[0]["train"][arch]["traj"][step]
    peak = {k: np.abs(v) for k, v in ref[0]["old"].items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    for s in range(step + 1):
        for k, w in ref[s]["params"].items():
            dw = np.abs(w - ref[s]["old"][k])
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w), dw))
            travel[k] = travel[k] + dw
    assert set(g["params"]) == set(ref[step]["params"])
    for k, w in ref[step]["params"].items():
        tol = 8 * _ulp(peak[k], "float32") + 1e-5 * travel[k].max()
        err = np.abs(g["params"][k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
    mus = {k[3:]: v for k, v in ref[step]["opt"].items()
           if k.startswith("mu/") and v.size}
    assert set(mus) == set(g["mu"])
    for k, w in mus.items():
        err = np.abs(g["mu"][k] - w)
        assert (err <= 4e-6 * np.abs(w).max()).all(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_moe_train_step_layouts(job, arch):
    """On (2, 2) the 4-D expert leaves (L, E, D, F) lie E over "model"
    and D over "data"; the attention's operands batch over "data" and
    heads over "model" (MLA's q_full, k_full and vv as JAX lays them)."""
    _, got = job
    r = got[0]["train"][arch]
    seg = "seg0_moe" if arch == "dbrx-132b" else "seg1_moe"
    assert r["layouts"][f"segments/{seg}/ffn/w_gate"] == (
        "(Shard(dim=2), Shard(dim=1))")
    assert r["layouts"][f"segments/{seg}/ffn/w_down"] == (
        "(Shard(dim=3), Shard(dim=1))")
    assert r["attention"] == [("(Shard(dim=0), Shard(dim=2))",) * 3]
    if arch == "deepseek-v3-671b":
        assert r["layouts"][f"segments/{seg}/attn/wkv_b"] == (
            "(Replicate(), Shard(dim=2))")


def test_sharded_mla_prefill_matches_jax(job):
    refs, got = job
    want = refs["prefill"]
    r = got[0]["prefill"]
    np.testing.assert_allclose(r["hidden"], want["hidden"], atol=1e-4,
                               rtol=0)
    assert set(r["cache"]) == set(want["cache"])
    for k, w in want["cache"].items():
        np.testing.assert_allclose(r["cache"][k], w, atol=1e-4, rtol=0,
                                   err_msg=k)


def test_sharded_mla_decode_raises_naming_sharded_serving(job):
    _, got = job
    for res in got.values():
        msg = res["prefill"]["decode"]
        assert msg is not None and "sharded serving" in msg, msg
