"""The port's head-sharded Mamba2 and the hybrid on a ("data", "model")
mesh against the JAX package's single-device numbers, on the CPU.

One spawned ``gloo`` job of world 4 runs every check below and sends its
results back; the test process computes the JAX references while the
workers run (the workers import no JAX: the JAX imports of this module
sit inside the functions that run here only). Each worker runs torch on
one thread. JAX's own meshes fail under JAX 0.9.0 (ROADMAP.md Queue 3,
caveat 2), so every reference is JAX's unsharded layer, step or forward.

Checks:
  * ``apply_mamba`` on DTensors laid out per the rules (x's rows over
    "data", the leaves per ``mamba_spec``: in_proj ("embed" -> data,
    "ssm_inner" -> model), conv_w, conv_b, gate_norm and out_proj over
    "ssm_inner", A_log, D and dt_bias replicated) against JAX's
    ``apply_mamba``, in f32, on meshes (2, 2), (1, 4) and (4, 1): y and
    the gradients of x and of every leaf of sum(y * r) in mode train;
    y and the cache (conv, ssm) in mode prefill. Cases: mamba2-370m's
    ``SMOKE`` layer (nh 8, hd 32, N 16, chunk 16) on 4 x 64 tokens;
    ``ssm_ngroups`` 2 (on (1, 4) two ranks share each group); d_model 96
    (nh 6, in_proj 422 wide: neither divides over "model" 4, so the heads
    stay whole there and no head sum runs; on (2, 2) each rank holds 3
    heads of the one group); and one batch row that "data" cannot split.
    Each rank's SSD input is nh/M heads wide where nh divides over the M
    ranks of "model", all nh where it does not. x with its sequence over
    "model" (a rule override), or a plain x, raises naming the layout;
  * two ``make_train_step(rules=, mesh=)`` steps of mamba2-370m's and
    jamba-1.5-large-398b's ``SMOKE`` (Mamba2; the hybrid: attention, MLP,
    Mamba2 and MoE) on (2, 2), ``scale_fused`` and clip 1.0, against
    JAX's ``make_train_step`` without a mesh on the same batches, each
    step from JAX's state before it (the first from JAX's init, the second
    from JAX's first step's params and optimizer state laid out on the
    mesh), as ``tests/test_torch_jamba_smoke.py`` runs the unsharded
    twin: the loss, aux, ``grad_norm``, every parameter and the optimizer
    state;
  * mamba2-370m's ``SMOKE`` gradients on (2, 2) under remat "full" and
    "dots" equal those without remat, bitwise (the recomputed forward
    replays the collectives in the same order on every rank);
  * both ``SMOKE`` models' forward in mode prefill on (2, 2): the hidden
    states and the cache against JAX's, the Mamba2 cache laid out per
    JAX's ``cache_axes``; and mode decode on the mesh raises before any
    work, naming sharded serving.

Tolerances (sums across ranks run in another order than one device's):
  * the layer, f32: ``tests/test_torch_mamba.py``'s ``TOL``, 1e-5 of the
    tensor's largest |ref| + 1e-5 relative, for y and every gradient;
  * train steps, f32: ``tests/test_torch_sharded.py``'s (the unsharded
    trainer parity's): params 8 ulps of the element's peak + 1e-5 of the
    leaf's step, SCALE's momentum 4e-6 of the leaf's max, loss, aux and
    ``grad_norm`` 1e-5 relative. The leaves SCALE gives to Adam take the
    bounds the unsharded files of these models hold them to, for the
    reason given there (Adam's step, lr * g / (|g| + eps), carries the
    rounding of a gradient that nearly cancels; the unsharded port itself
    is 1.4x past 4e-6 on jamba's Adam moments after one step from the
    same init): params ``tests/test_torch_mamba.py``'s 2e-4 of the step
    for mamba2-370m's conv_w, conv_b, A_log, D and dt_bias and
    ``tests/test_torch_jamba_smoke.py``'s ``VECTOR_REL`` 1e-2 of it for
    every Adam leaf of jamba's; Adam's moments 2e-5 of the leaf's max
    (``tests/test_torch_jamba_smoke.py``'s);
  * prefill, f32: 1e-4 absolute for the hidden states, y and the cache
    (``tests/test_torch_mamba.py``'s for the models), the layer's too: its
    final SSM state sums all S positions under a cumsum of dt * A over
    them, which the port and JAX round in other orders (at the 256 of
    one row the unsharded port is 3.05e-5 of the largest |ref| off
    JAX's state).
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
MESHES = ((2, 2), (1, 4), (4, 1))
ARCHS = ("mamba2-370m", "jamba-1.5-large-398b")
# case -> (config overrides of mamba2-370m's SMOKE, (B, S))
LAYER_CASES = {
    "smoke": ({}, (4, 64)),
    "g2": ({"ssm_ngroups": 2}, (4, 64)),
    "whole": ({"d_model": 96}, (4, 64)),
    "b1": ({}, (1, 256)),
}
TRAIN_BATCH, TRAIN_SEQ, STEPS = 4, 32, 2
PREFILL = (2, 32)  # batch, prompt: two chunks of 16
TOL = 1e-5
# the Adam leaves' share of their travel in a train step, as the unsharded
# files hold them (docstring): mamba2-370m's by name, jamba's all
ADAM_SSM = ("conv_w", "conv_b", "A_log", "D", "dt_bias")
ADAM_REL = {"mamba2-370m": 2e-4, "jamba-1.5-large-398b": 1e-2}
# the optimizer state's share of each leaf's largest |value|: SCALE's
# momentum (tests/test_torch_sharded.py's), Adam's moments
# (tests/test_torch_jamba_smoke.py's)
OPT_MU, OPT_ADAM = 4e-6, 2e-5
_MANT = {"float32": 23, "bfloat16": 7}


def _cfg_kw(arch, over=None):
    """The SMOKE config's fields (f32) with ``over``: plain data both
    packages' ``ModelConfig`` take."""
    from repro_torch.configs import get_arch
    return {**dataclasses.asdict(get_arch(arch, smoke=True)), **(over or {})}


def _tcfg(kw):
    from repro_torch.models import config as tconfig
    return tconfig.ModelConfig(**kw)


def _layer_inputs(case):
    """(config kwargs, leaves, x, r) of one layer case, as f32 numpy:
    random leaves of ``mamba_spec``'s shapes, A_log and dt_bias by their
    init rules (``tests/test_torch_mamba.py``'s ``_layer_case``)."""
    from repro_torch.models import layers as L
    over, (B, S) = LAYER_CASES[case]
    kw = _cfg_kw("mamba2-370m", over)
    rng = np.random.default_rng(7 + list(LAYER_CASES).index(case))
    p = {}
    for k, s in L.mamba_spec(_tcfg(kw)).items():
        if s.init == "alog":
            v = np.log(rng.uniform(1.0, 16.0, s.shape))
        elif s.init == "dtbias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), s.shape))
            v = dt + np.log(-np.expm1(-dt))
        elif s.init == "ones":
            v = 1.0 + 0.1 * rng.standard_normal(s.shape)
        elif s.init == "zeros":
            v = 0.1 * rng.standard_normal(s.shape)
        elif k == "conv_w":
            v = 0.5 * rng.standard_normal(s.shape)
        else:
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        p[k] = v.astype(np.float32)
    x = rng.standard_normal((B, S, kw["d_model"])).astype(np.float32)
    r = rng.standard_normal((B, S, kw["d_model"])).astype(np.float32)
    return kw, p, x, r


# ------------------------------------------------------- JAX references

def _train_batches() -> dict:
    """Each SMOKE model's config and batches (numpy): the train steps'
    inputs on both sides, with the weights ``_jax_model`` adds."""
    rng = np.random.default_rng(5)
    out = {}
    for arch in ARCHS:
        kw = _cfg_kw(arch)
        out[arch] = {"cfg": kw, "batches": [
            {k: rng.integers(0, kw["vocab_size"], (TRAIN_BATCH, TRAIN_SEQ),
                             dtype=np.int32) for k in ("tokens", "labels")}
            for _ in range(STEPS)]}
    return out


def _jflat(tree):
    import jax
    import jax.numpy as jnp
    from repro.core.labels import path_str
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p).lstrip("."): np.asarray(
        x if x.dtype == jnp.int32 else x.astype(jnp.float32))
        for p, x in leaves}


def _jax_model(train: dict) -> tuple:
    """JAX's side of one SMOKE model's train steps: its init (JAX's
    ``init_params``), then its unsharded ``scale_fused`` steps, per step
    the params before and after it, the optimizer state after it and the
    metrics, as numpy. -> (the JAX weights, the steps)."""
    import jax
    import jax.numpy as jnp
    from repro.core import make_optimizer as j_make
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    from repro.training import trainer as JT
    jcfg = ModelConfig(**train["cfg"])
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(
        jax.random.PRNGKey(0))
    tx = j_make("scale_fused", 1e-2)
    step = jax.jit(JT.make_train_step(jcfg, tx, clip_norm=1.0))
    js = JT.init_state(jp, tx)
    traj = []
    for b in train["batches"]:
        old = _jflat(js.params)
        js, jm = step(js, {k: jnp.asarray(v) for k, v in b.items()})
        traj.append({"old": old, "params": _jflat(js.params),
                     "opt": _jflat(js.opt_state),
                     **{k: float(jm[k]) for k in ("loss", "aux",
                                                  "grad_norm")}})
    return jp, traj


def _jax_prefill(train: dict, jp) -> dict:
    """JAX's forward of one SMOKE model in mode prefill on the first
    batch's first PREFILL tokens: the hidden states and the cache."""
    import jax
    import jax.numpy as jnp
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    jcfg = ModelConfig(**train["cfg"])
    B, S = PREFILL
    toks = train["batches"][0]["tokens"][:B, :S]
    h, cache, _ = jax.jit(lambda p, t: JM.forward(
        p, jcfg, t, mode="prefill", cache=JM.init_cache(jcfg, B, S)))(
            jp, jnp.asarray(toks))
    return {"hidden": np.asarray(h.astype(jnp.float32)),
            "cache": _jflat(cache)}


def _jax_layer(case) -> dict:
    """JAX's unsharded layer of one case, as numpy: y and the gradients
    of sum(y * r) in mode train, y and the cache in mode prefill."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL
    from repro.models.config import ModelConfig
    from repro.models.sharding import Rules as JRules

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))
    kw, p, x, r = _layer_inputs(case)
    jcfg = ModelConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p.items()}

    def loss(p, x):
        y, _ = JL.apply_mamba(p, jcfg, x, JRules(), mode="train")
        return jnp.sum(y * r), y

    def both(p, x):   # one compile for the two modes
        return (jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x),
                JL.apply_mamba(p, jcfg, x, JRules(), mode="prefill"))

    ((_, y), (gp, gx)), (yp, cache) = jax.jit(both)(jp, jnp.asarray(x))
    return {"y": f32(y), "grads": {"x": f32(gx), **{
        k: f32(v) for k, v in gp.items()}},
        "prefill": {"y": f32(yp), **{k: f32(v) for k, v in cache.items()}}}


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
    out = {"layer": {(m, case): _layer_check(mesh, case)
                     for m, mesh in meshes.items() for case in LAYER_CASES},
           "refused": _refused_layouts(meshes[(2, 2)])}
    # the JAX weights and steps, made while the layer ran
    train, jsteps = inputs.get()
    out["train"] = {arch: _train_check(meshes[(2, 2)], train[arch],
                                       jsteps[arch]) for arch in ARCHS}
    out["remat"] = _remat_check(meshes[(2, 2)], train["mamba2-370m"])
    out["prefill"] = {arch: _prefill_check(meshes[(2, 2)], train[arch])
                      for arch in ARCHS}
    return out


def _np(x):
    # a copy: a replicated DTensor's full value is its live local tensor
    from repro_torch.models.sharding import full_value
    return full_value(x).detach().float().numpy().copy()


def _layer_check(mesh, case) -> dict:
    """The layer on DTensors in mode train (y and every gradient) and in
    mode prefill (y and the cache), with the heads each rank's
    ``mamba_local`` and SSD were given."""
    from unittest import mock

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import layers as L
    from repro_torch.models.sharding import Rules, place
    rules = Rules()
    kw, p, x, r = _layer_inputs(case)
    cfg = _tcfg(kw)
    spec = L.mamba_spec(cfg)
    pd = {k: place(torch.from_numpy(v), rules.sharding(
        spec[k].axes, mesh, v.shape)).detach().requires_grad_()
        for k, v in p.items()}
    xs = rules.sharding(("act_batch", "act_seq", "act_embed"), mesh, x.shape)
    xd = place(torch.from_numpy(x), xs).detach().requires_grad_()
    seen = {"heads": [], "ssd": []}
    local, ssd = L.mamba_local, L._ssd_chunked

    def seen_local(p, cfg, x, mode="train", cache=None, heads=None,
                   reduce=L.MAMBA_LOCAL):
        seen["heads"].append(heads)
        return local(p, cfg, x, mode, cache, heads, reduce)

    def seen_ssd(xh, dt, A, Bm, Cm, chunk):
        seen["ssd"].append(tuple(xh.shape))
        return ssd(xh, dt, A, Bm, Cm, chunk)

    with mock.patch.object(L, "mamba_local", seen_local), \
            mock.patch.object(L, "_ssd_chunked", seen_ssd), \
            implicit_replication():
        y, cache = L.apply_mamba(pd, cfg, xd, rules=rules, mesh=mesh)
        total = (y * place(torch.from_numpy(r), xs)).sum()
        grads = torch.autograd.grad(total, [xd, *pd.values()])
        with torch.no_grad():
            yp, pre = L.apply_mamba(pd, cfg, xd, "prefill", rules=rules,
                                    mesh=mesh)
    return {"y": _np(y), "cache": cache,
            "grads": {k: _np(g) for k, g in zip(["x", *pd], grads)},
            "prefill": {"y": _np(yp), **{k: _np(v) for k, v in pre.items()}},
            "placements": {k: str(tuple(v.placements))
                           for k, v in pd.items()},
            "seen": seen}


def _refused_layouts(mesh) -> dict:
    """The messages ``apply_mamba`` raises on a mesh for x with its
    sequence over "model" (a rule override) and for a plain x."""
    from repro_torch.models import layers as L
    from repro_torch.models.sharding import Rules, place
    kw, p, x, _ = _layer_inputs("smoke")
    cfg = _tcfg(kw)
    out = {}
    for name, rules, lay in (
            ("seq", Rules((("act_seq", ("model",)),)), True),
            ("plain", Rules(), False)):
        xt = torch.from_numpy(x)
        if lay:
            xt = place(xt, rules.sharding(("act_batch", "act_seq",
                                           "act_embed"), mesh, x.shape))
        try:
            L.apply_mamba({k: torch.from_numpy(v) for k, v in p.items()},
                          cfg, xt, rules=rules, mesh=mesh)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _jax_state(mesh, cfg, tx, jstep, step: int):
    """The sharded train state at JAX's params and optimizer state after
    its step ``step`` (``jstep``), each leaf laid out as its parameter."""
    from repro_torch.core.pipeline import HostCount
    from repro_torch.models.model import place_params
    from repro_torch.models.sharding import is_dtensor, place, spec_of
    from repro_torch.models.weights import load_flat
    from repro_torch.training import TrainState
    params = place_params(load_flat(jstep["params"], cfg, device="cpu"), cfg,
                          mesh)
    like = tx.init(params)

    def lay(part):
        out = {}
        for k, x in getattr(like, part).items():
            a = torch.from_numpy(jstep["opt"][f"{part}/{k}"].copy()).to(
                x.dtype)
            out[k] = place(a, spec_of(x), copy=True) if is_dtensor(x) else a
        return out
    count = torch.tensor(step, dtype=torch.int32)
    opt = like._replace(count=count, mu=lay("mu"), nu=lay("nu"),
                        host_count=HostCount(step))
    return TrainState(count.clone(), params, opt, host_step=HostCount(step))


def _train_check(mesh, ref, jsteps) -> dict:
    """``STEPS`` sharded steps, each from JAX's state before it (the first
    from the same init, the next from JAX's last step's params and
    optimizer state), as ``tests/test_torch_jamba_smoke.py`` runs them."""
    from repro_torch.core import make_optimizer
    from repro_torch.models.model import flatten, place_params
    from repro_torch.models.sharding import Rules
    from repro_torch.models.weights import _state_leaves, load_flat
    from repro_torch.training import init_state, make_train_step
    cfg = _tcfg(ref["cfg"])
    params = place_params(load_flat(ref["init"], cfg, device="cpu"), cfg,
                          mesh)
    tx = make_optimizer("scale_fused", 1e-2)
    step = make_train_step(cfg, tx, clip_norm=1.0, rules=Rules(), mesh=mesh)
    state = init_state(params, tx)
    traj = []
    for i, b in enumerate(ref["batches"]):
        if i:
            state = _jax_state(mesh, cfg, tx, jsteps[i - 1], i)
        state, m = step(state, {k: torch.from_numpy(x) for k, x in
                                b.items()})
        traj.append({**{k: float(m[k]) for k in ("loss", "aux",
                                                 "grad_norm")},
                     "params": {k: _np(p) for k, p in
                                flatten(state.params).items()},
                     "opt": {k: _np(x) for k, x in
                             _state_leaves(state.opt_state).items()
                             if k != "count" and x.numel()}})
    return {"traj": traj,
            "layouts": {k: str(tuple(p.placements)) for k, p in
                        flatten(state.params).items()}}


def _remat_check(mesh, ref) -> dict:
    """mamba2-370m's SMOKE loss and gradients on the mesh under each remat
    policy, from the JAX weights and the first batch."""
    from repro_torch.models.model import flatten, loss_fn, place_params
    from repro_torch.models.model import unflatten
    from repro_torch.models.sharding import Rules, mesh_context, shard_batch
    from repro_torch.models.weights import load_flat
    rules = Rules()
    base = _tcfg(ref["cfg"])
    params = place_params(load_flat(ref["init"], base, device="cpu"), base,
                          mesh)
    batch = shard_batch({k: torch.from_numpy(v) for k, v in
                         ref["batches"][0].items()}, mesh, rules)
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        leaves = {k: p.detach().requires_grad_() for k, p in
                  flatten(params).items()}
        with mesh_context(mesh):
            total, _ = loss_fn(unflatten(leaves), cfg, batch, rules=rules,
                               mesh=mesh)
            grads = torch.autograd.grad(total, list(leaves.values()))
        out[remat] = {"loss": _np(total),
                      "grads": {k: _np(g) for k, g in zip(leaves, grads)}}
    return out


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
    flat = flatten(cache)
    return {"hidden": _np(h),
            "cache": {k: _np(v) for k, v in flat.items()},
            "layouts": {k: str(tuple(v.placements)) for k, v in
                        flat.items() if "mamba" in k},
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
        # while the workers run; XLA compiles each on its own thread
        train = _train_batches()
        with concurrent.futures.ThreadPoolExecutor(8) as pool:
            # the steps first: the workers wait for them
            models = {arch: pool.submit(_jax_model, train[arch])
                      for arch in ARCHS}
            models = {arch: f.result() for arch, f in models.items()}
            for arch, (_, traj) in models.items():
                train[arch]["init"] = traj[0]["old"]
            jsteps = {arch: m[1] for arch, m in models.items()}
            for _ in procs:
                inputs.put((train, jsteps))
            prefill_f = {arch: pool.submit(_jax_prefill, train[arch], m[0])
                         for arch, m in models.items()}
            layer_f = {case: pool.submit(_jax_layer, case)
                       for case in LAYER_CASES}
            refs = {"train": jsteps,
                    "prefill": {k: f.result() for k, f in prefill_f.items()},
                    "layer": {k: f.result() for k, f in layer_f.items()}}
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


def _close(got, want, what):
    """Per element within TOL * max|want| + TOL * |want|."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert scale > 0 and (err <= TOL * scale + TOL * np.abs(want)).all(), (
        what, float(err.max() / scale))


def _vector(path, w) -> bool:
    """Whether SCALE's pipeline gives the leaf to Adam ("vector")."""
    from repro_torch.core.labels import LabelRules
    return LabelRules().classify(path, w.ndim) == "vector"


def _adam(arch, path, w) -> bool:
    """Whether the leaf takes its model's Adam bound (``ADAM_REL``)."""
    if arch == "mamba2-370m":
        return path.rsplit("/", 1)[-1] in ADAM_SSM
    return _vector(path, w)


_IDS = {"ids": lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v}


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_mamba_forward_matches_jax(job, mesh, case):
    """y of every rank against JAX's unsharded layer; train mode returns
    no cache."""
    refs, got = job
    for rank, res in got.items():
        r = res["layer"][(mesh, case)]
        assert r["cache"] is None
        _close(r["y"], refs["layer"][case]["y"], f"rank {rank} y")


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_mamba_gradients_match_jax(job, mesh, case):
    """The gradients of x and of every leaf of sum(y * r), each whole,
    against JAX's: a partial counted twice or left out (the replicated
    A_log, D and dt_bias, the shared B and C columns) shows as a factor."""
    refs, got = job
    want = refs["layer"][case]["grads"]
    for rank, res in got.items():
        g = res["layer"][(mesh, case)]["grads"]
        assert set(g) == set(want) == {"x", "in_proj", "conv_w", "conv_b",
                                       "A_log", "D", "dt_bias", "gate_norm",
                                       "out_proj"}
        for k, w in want.items():
            _close(g[k], w, f"rank {rank} {k}")


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_mamba_prefill_matches_jax(job, mesh, case):
    """Mode prefill: y, the conv window's last inputs (every channel,
    each group's B and C from the rank that owns it) and the final SSM
    state of every head."""
    refs, got = job
    want = refs["layer"][case]["prefill"]
    for rank, res in got.items():
        r = res["layer"][(mesh, case)]["prefill"]
        assert set(r) == set(want) == {"y", "conv", "ssm"}
        for k, w in want.items():
            np.testing.assert_allclose(r[k], w, atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {k}")


@pytest.mark.parametrize("case", list(LAYER_CASES))
@pytest.mark.parametrize("mesh", MESHES, **_IDS)
def test_sharded_apply_mamba_keeps_its_heads_local(job, mesh, case):
    """Each rank runs nh/M heads through its SSD, its own block of them,
    where nh divides over the M ranks of "model", and all nh where it does
    not (d_model 96 on model 4; model 1); its rows are B over "data" where
    B divides."""
    _, got = job
    kw = _cfg_kw("mamba2-370m", LAYER_CASES[case][0])
    cfg = _tcfg(kw)
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    B, S = LAYER_CASES[case][1]
    M = mesh[1] if nh % mesh[1] == 0 else 1
    assert (case == "whole" and mesh == (1, 4)) == (M == 1 < mesh[1])
    Bl = B // mesh[0] if B % mesh[0] == 0 else B
    for rank, res in got.items():
        seen = res["layer"][(mesh, case)]["seen"]
        h = rank % mesh[1] if M > 1 else 0
        heads = (h * nh // M, (h + 1) * nh // M)
        assert seen["heads"] == [heads, heads]
        assert seen["ssd"] == [(Bl, S, nh // M, hd)] * 2


def test_sharded_apply_mamba_lays_the_leaves_out_per_the_rules(job):
    """in_proj over ("embed" -> data, "ssm_inner" -> model); conv_w,
    conv_b, gate_norm and out_proj over "ssm_inner"; A_log, D and dt_bias
    replicated. d_model 96's in_proj (422 wide) stays whole over model 4."""
    _, got = job
    lay = got[0]["layer"][((2, 2), "smoke")]["placements"]
    assert lay["in_proj"] == "(Shard(dim=0), Shard(dim=1))"
    assert lay["conv_w"] == "(Replicate(), Shard(dim=1))"
    assert lay["conv_b"] == lay["gate_norm"] == "(Replicate(), Shard(dim=0))"
    assert lay["out_proj"] == "(Shard(dim=1), Shard(dim=0))"
    for k in ("A_log", "D", "dt_bias"):
        assert lay[k] == "(Replicate(), Replicate())"
    whole = got[0]["layer"][((1, 4), "whole")]["placements"]
    assert whole["in_proj"] == "(Shard(dim=0), Replicate())"
    assert whole["conv_w"] == "(Replicate(), Shard(dim=1))"


@pytest.mark.parametrize("what,match", [
    ("seq", r"x laid out \(\('data',\), \('model',\), \(\)\)"),
    ("plain", "x is a plain tensor")])
def test_sharded_apply_mamba_raises_on_a_layout_it_cannot_take(job, what,
                                                               match):
    """x with its sequence over "model" (a rule override) and a plain x
    on a mesh raise ``NotImplementedError`` naming the layout, on every
    rank."""
    import re
    _, got = job
    for res in got.values():
        msg = res["refused"][what]
        assert msg is not None and re.search(match, msg), msg


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mamba_train_steps_match_jax(job, arch, step):
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
        rel = ADAM_REL[arch] if _adam(arch, k, w) else 1e-5
        tol = 8 * _ulp(np.maximum(np.abs(old), np.maximum(np.abs(w), dw)),
                       "float32") + rel * dw.max()
        err = np.abs(g["params"][k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
    opt = {k: v for k, v in ref["opt"].items() if k != "count" and v.size}
    assert set(opt) == set(g["opt"])
    for k, w in opt.items():
        path = k.split("/", 1)[1]
        scale = OPT_ADAM if _vector(path, ref["params"][path]) else OPT_MU
        err = np.abs(g["opt"][k] - w)
        assert (err <= scale * np.abs(w).max()).all(), (
            k, float(err.max() / np.abs(w).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mamba_train_step_layouts(job, arch):
    """On (2, 2) the stacked Mamba2 leaves lie as ``mamba_spec`` says
    under a leading layer dim: in_proj (L, D, 2 din + 2 G N + nh) D over
    "data" and its columns over "model", out_proj the other way round;
    the hybrid's experts E over "model" and D over "data"."""
    _, got = job
    lay = got[0]["train"][arch]["layouts"]
    seg, sub = (("seg0_ssm", "mamba") if arch == "mamba2-370m"
                else ("seg0_hybrid", "mamba1"))
    m = f"segments/{seg}/{sub}"
    assert lay[f"{m}/in_proj"] == "(Shard(dim=1), Shard(dim=2))"
    assert lay[f"{m}/out_proj"] == "(Shard(dim=2), Shard(dim=1))"
    assert lay[f"{m}/A_log"] == "(Replicate(), Replicate())"
    if arch != "mamba2-370m":
        assert lay[f"segments/{seg}/ffn1/w_gate"] == (
            "(Shard(dim=2), Shard(dim=1))")


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_sharded_mamba_remat_policies_match_none(job, remat):
    """Under remat "full" and "dots" the loss and every gradient on every
    rank equal those without remat, bitwise."""
    _, got = job
    for rank, res in got.items():
        r, none = res["remat"][remat], res["remat"]["none"]
        assert np.array_equal(r["loss"], none["loss"]), rank
        for k, g in none["grads"].items():
            assert np.array_equal(r["grads"][k], g), (rank, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mamba_prefill_matches_jax(job, arch):
    """The hidden states and every cache leaf (the hybrid's attention k/v
    and its Mamba2 conv and SSM states) against JAX's; the Mamba2 cache
    laid out per JAX's ``cache_axes``: (L, B, dconv-1, conv_dim) with B
    over "data" and conv_dim over "model", (L, B, nh, N, hd) with B over
    "data"."""
    refs, got = job
    want = refs["prefill"][arch]
    for rank, res in got.items():
        r = res["prefill"][arch]
        np.testing.assert_allclose(r["hidden"], want["hidden"], atol=1e-4,
                                   rtol=0, err_msg=f"rank {rank}")
        assert set(r["cache"]) == set(want["cache"])
        for k, w in want["cache"].items():
            np.testing.assert_allclose(r["cache"][k], w, atol=1e-4, rtol=0,
                                       err_msg=f"rank {rank} {k}")
        assert r["layouts"] and all(
            v == ("(Shard(dim=1), Shard(dim=3))" if k.endswith("conv")
                  else "(Shard(dim=1), Replicate())")
            for k, v in r["layouts"].items()), r["layouts"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mamba_decode_raises_naming_sharded_serving(job, arch):
    _, got = job
    for res in got.values():
        msg = res["prefill"][arch]["decode"]
        assert msg is not None and "sharded serving" in msg, msg
