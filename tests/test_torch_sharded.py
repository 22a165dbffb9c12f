"""The port's sharded training on ``torch.distributed`` against the JAX
package's single-device numbers, on the CPU.

One spawned ``gloo`` job of world 4 runs every check below and sends its
results back; the test process hands the workers the JAX model's weights
and batches as numpy, computes the JAX references while they run, and
compares (the workers import no JAX: the JAX imports of this module sit
inside the functions that run here only). Each worker runs torch on one
thread.

Checks, on (data, model) meshes (2, 2) and (1, 4):
  * the optimizer entry points (``normalize``, ``norm_update``,
    ``momentum_norm``, ``momentum_norm_update``) on leaves laid out
    P("data", "model") (2-D) and P(None, "data", "model") (stacked 3-D),
    col, row and larger, f32 and bf16, against JAX's ``dispatch`` on the
    whole leaf (Pallas in interpret mode): the sums of squares cross
    ranks along the rows (col) or the columns (row);
  * ``xent_loss`` with tokens over "data" and the vocabulary over
    "model" (each shard with its ``col_offset``; w's embed dim gathered),
    untied and tied, value and (dh, dw), against JAX's unsharded
    ``xent_loss``; and the layout JAX routes to "ref" (tokens and
    vocabulary both over "model"), which takes the plain versions on the
    DTensors here;
  * ``flash_attention`` with batch over "data" and heads over "model",
    value and (dq, dk, dv);
  * two ``make_train_step(rules=, mesh=)`` steps of a tiny llama with
    ``scale_fused`` and clip 1.0 on (2, 2), against JAX's
    ``make_train_step`` without a mesh from the same weights and batches:
    the loss, ``grad_norm``, every parameter and the momentum;
  * ``save`` of that sharded state (rank 0 writes the full tensors),
    restored bitwise into an unsharded port state and into the sharded
    layout; and the launcher under the mesh (``--ckpt-dir``, guard on):
    one ``metrics.0.jsonl``, a committed checkpoint that restores into
    the unsharded port.

Tolerances (sums across ranks run in another order: f32 is close, not
bitwise):
  * optimizer, f32: 2e-6 relative + 2e-7 absolute, as the single-device
    dispatch parity (tests/test_torch_scale.py); bf16 outputs: one bf16
    ulp, 2**-7 relative, at the scale of the leaf (2**-7 of max |ref|
    absolute) — a rounding the f32 differences flip;
  * xent and attention, f32: 2e-5 absolute + 1e-5 relative (the
    unsharded parity tests' bounds); xent bf16: 1e-5 absolute + 8e-3
    relative on the bf16 gradients (one rounding each side);
  * train steps, f32: the unsharded trainer parity's bounds
    (tests/test_torch_trainer.py): params 8 ulps of the element's peak +
    1e-5 of the leaf's travel, momentum 4e-6 of the leaf's max, loss and
    ``grad_norm`` 1e-5 relative;
  * checkpoints: bitwise.
"""
import dataclasses
import os
import socket
import tempfile
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

if not torch.distributed.is_available():
    pytest.skip("needs torch.distributed", allow_module_level=True)

WORLD = 4
MESHES = ((2, 2), (1, 4))
OPT_OPS = ("normalize", "norm_update", "momentum_norm",
           "momentum_norm_update")
OPT_KINDS = ("col", "row", "larger")
OPT_SHAPES = {2: (40, 24), 3: (2, 24, 40)}
XENT = dict(B=4, S=8, D=32, V=256, vocab_size=250)
ATTN = dict(B=4, S=16, H=4, K=2, hd=16)
TINY = dict(name="sharded", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=250,
            dtype="float32", attn_kv_block=16, attn_q_block=16,
            loss_chunk=16)
STEPS = 2
_MANT = {"float32": 23, "bfloat16": 7}


def _opt_cases():
    return [(op, kind, dt, nd) for op in OPT_OPS for kind in OPT_KINDS
            for dt in ("f32", "bf16") for nd in (2, 3)]


def _xent_cases():
    # (mesh, tied, dtype, layout): "plan" is the rules' layout, "ref" JAX's
    # ref route (tokens and vocabulary on one axis)
    return ([((2, 2), t, d, "plan") for t in (False, True)
             for d in ("f32", "bf16")]
            + [((1, 4), t, "f32", "plan") for t in (False, True)]
            + [((2, 2), False, "f32", "ref")])


# --------------------------------------------------------------- inputs

def _opt_inputs(nd):
    rng = np.random.default_rng(11 + nd)
    return [rng.standard_normal(OPT_SHAPES[nd]).astype(np.float32)
            for _ in range(3)]  # g, theta, m


def _xent_inputs(tied):
    B, S, D, V, vs = (XENT[k] for k in ("B", "S", "D", "V", "vocab_size"))
    rng = np.random.default_rng(21)
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(-1, vs, (B, S)).astype(np.int32)
    c = rng.random((B, S)).astype(np.float32)
    return h, (np.ascontiguousarray(w.T) if tied else w), labels, c


def _attn_inputs():
    B, S, H, K, hd = (ATTN[k] for k in ("B", "S", "H", "K", "hd"))
    rng = np.random.default_rng(31)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, H, hd)).astype(np.float32))


# ------------------------------------------------------- JAX references

def _jax_train_inputs() -> dict:
    """The tiny JAX llama's weights and batches, as numpy: the train
    step's inputs on both sides."""
    import jax
    import jax.numpy as jnp
    from repro.core.labels import path_str
    from repro.data import make_dataset as j_dataset
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    jcfg = ModelConfig(**TINY)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jp)
    ds = j_dataset(jcfg, seq_len=32, global_batch=4, seed=3)
    return {"init": {path_str(p).lstrip("."): np.asarray(
                x.astype(jnp.float32)) for p, x in leaves},
            "batches": [{k: np.array(x) for k, x in
                         ds.global_batch_at(i).items()}
                        for i in range(STEPS)],
            "cfg": dataclasses.asdict(jcfg)}


def _jax_refs(train: dict) -> dict:
    """Every JAX number the checks compare with, as numpy; ``train`` the
    train step's inputs (``_jax_train_inputs``)."""
    import jax
    import jax.numpy as jnp
    from repro.core import make_optimizer as j_make
    from repro.core.labels import path_str
    from repro.kernels import dispatch as JD
    from repro.models import model as JM
    from repro.models.config import ModelConfig
    from repro.training import trainer as JT

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    def jflat(tree):
        leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
        return {path_str(p).lstrip("."): (np.asarray(x) if x.dtype
                                          == jnp.int32 else f32(x))
                for p, x in leaves}

    out = {"opt": {}, "xent": {}}
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    for op, kind, dt, nd in _opt_cases():
        g, th, m = (jnp.asarray(x).astype(jdt[dt]) for x in _opt_inputs(nd))
        kw = dict(gscale=0.5)
        if op == "normalize":
            res = (JD.normalize(g, kind, **kw),)
        elif op == "norm_update":
            res = (JD.norm_update(th, g, 0.01, kind, **kw),)
        elif op == "momentum_norm":
            res = JD.momentum_norm(m, g, 0.9, kind, **kw)
        else:
            res = JD.momentum_norm_update(th, m, g, 0.9, 0.01, kind, **kw)
        out["opt"][(op, kind, dt, nd)] = [f32(x) for x in res]
    for tied in (False, True):
        for dt in ("f32", "bf16"):
            h, w, labels, c = _xent_inputs(tied)
            h, w = (jnp.asarray(x).astype(jdt[dt]) for x in (h, w))

            def loss(h, w):
                return JD.xent_loss(h, w, jnp.asarray(labels),
                                    vocab_size=XENT["vocab_size"],
                                    transposed=tied)

            val, vjp = jax.vjp(loss, h, w)
            dh, dw = vjp(jnp.asarray(c))
            out["xent"][(tied, dt)] = (f32(val), f32(dh), f32(dw))
    q, k, v, do = (jnp.asarray(x) for x in _attn_inputs())
    val, vjp = jax.vjp(lambda q, k, v: JD.flash_attention(
        q, k, v, scale=0.25, causal=True), q, k, v)
    out["attn"] = (f32(val),) + tuple(f32(x) for x in vjp(do))

    jcfg = ModelConfig(**TINY)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tx = j_make("scale_fused", 1e-2)
    step = jax.jit(JT.make_train_step(jcfg, tx, clip_norm=1.0))
    js = JT.init_state(jp, tx)
    traj = []
    for b in train["batches"]:
        old = jflat(js.params)
        js, jm = step(js, {k: jnp.asarray(x) for k, x in b.items()})
        traj.append({"old": old, "params": jflat(js.params),
                     "opt": jflat(js.opt_state),
                     "loss": float(jm["loss"]),
                     "grad_norm": float(jm["grad_norm"])})
    out["train"] = {**train, "traj": traj}
    return out


# ------------------------------------------------------------ the workers

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank, port, refs, tmp, q):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        res = _run_checks(rank, refs, tmp)
        if rank == 0:
            q.put(("ok", res))
    except BaseException:
        q.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
        raise
    finally:
        dist.destroy_process_group()


def _run_checks(rank, refs, tmp) -> dict:
    from repro_torch.launch.mesh import make_host_mesh
    out = {}
    meshes = {m: make_host_mesh(*m, device_type="cpu") for m in MESHES}
    out["opt"] = _opt_checks(meshes)
    out["xent"] = _xent_checks(meshes)
    out["attn"] = _attn_check(meshes[(2, 2)])
    out["train"] = _train_check(meshes[(2, 2)], refs["train"], tmp, rank)
    out["launcher"] = _launcher_check(refs["train"], tmp, rank)
    return out


def _np(x):
    # a copy: a replicated DTensor's full value is its live local tensor
    from repro_torch.models.sharding import full_value
    return full_value(x).detach().float().numpy().copy()


def _opt_checks(meshes) -> dict:
    from repro_torch.kernels import dispatch as TD
    from repro_torch.models.sharding import NamedSharding, P, place
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {}
    for mshape, mesh in meshes.items():
        for op, kind, dt, nd in _opt_cases():
            spec = P("data", "model") if nd == 2 else P(None, "data",
                                                        "model")
            sh = NamedSharding(mesh, spec)
            g, th, m = (place(torch.from_numpy(x).to(tdt[dt]), sh)
                        for x in _opt_inputs(nd))
            kw = dict(gscale=0.5, sharding=sh)
            if op == "normalize":
                res = (TD.normalize(g, kind, **kw),)
            elif op == "norm_update":
                res = (TD.norm_update(th, g, 0.01, kind, **kw),)
                assert res[0] is th
            elif op == "momentum_norm":
                res = TD.momentum_norm(m, g, 0.9, kind, **kw)
                assert res[0] is m
            else:
                res = TD.momentum_norm_update(th, m, g, 0.9, 0.01, kind,
                                              **kw)
                assert res[0] is th and res[1] is m
            out[(mshape, op, kind, dt, nd)] = [_np(x) for x in res]
    return out


def _xent_checks(meshes) -> dict:
    from repro_torch.kernels import dispatch as TD
    from repro_torch.models.sharding import P, Rules, place
    rules = Rules()
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}
    out = {}
    for mshape, tied, dt, layout in _xent_cases():
        mesh = meshes[mshape]
        h, w, labels, c = _xent_inputs(tied)
        h = torch.from_numpy(h).to(tdt[dt])
        w = torch.from_numpy(w).to(tdt[dt])
        h_sh = rules.sharding(("act_batch", "act_seq", "act_embed"), mesh,
                              h.shape)
        w_sh = rules.sharding(("vocab", "embed") if tied
                              else ("embed", "vocab"), mesh, w.shape)
        if layout == "ref":
            h_sh = h_sh._replace(spec=P("model", None, None))
        route, plan = TD.xent_route(h.shape, w.shape, h_sh, w_sh, tied)
        hd = place(h, h_sh).detach().requires_grad_()
        wd = place(w, w_sh).detach().requires_grad_()
        lab = torch.from_numpy(labels)
        losses = TD.xent_loss(hd, wd, lab, vocab_size=XENT["vocab_size"],
                              transposed=tied, h_sharding=h_sh,
                              w_sharding=w_sh)
        cot = place(torch.from_numpy(c), h_sh._replace(
            spec=tuple(h_sh.spec)[:2]))
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            dh, dw = torch.autograd.grad((losses * cot).sum(), [hd, wd])
        out[(mshape, tied, dt, layout)] = {
            "route": route, "plan": None if plan is None else (
                plan.tok_axes, plan.voc_axes),
            "vals": (_np(losses), _np(dh), _np(dw))}
    return out


def _attn_check(mesh) -> dict:
    from repro_torch.kernels import dispatch as TD
    from repro_torch.models.sharding import NamedSharding, P, place
    sh = NamedSharding(mesh, P("data", None, "model", None))
    q, k, v, do = (torch.from_numpy(x) for x in _attn_inputs())
    q, k, v = (place(x, sh).detach().requires_grad_() for x in (q, k, v))
    route, plan = TD.attn_route(q.shape, k.shape, sh, sh)
    out = TD.flash_attention(q, k, v, scale=0.25, causal=True,
                             q_sharding=sh, kv_sharding=sh)
    grads = torch.autograd.grad(out, [q, k, v], place(do, sh))
    return {"route": route, "plan": (plan.batch_axes, plan.head_axes),
            "placements": str(tuple(out.placements)),
            "vals": (_np(out),) + tuple(_np(x) for x in grads)}


def _tiny(ref):
    from repro_torch.models import config as tconfig
    return tconfig.ModelConfig(**ref["cfg"])


def _train_check(mesh, ref, tmp, rank) -> dict:
    import torch.distributed as dist
    from repro_torch.checkpoint import restore, save
    from repro_torch.core import make_optimizer
    from repro_torch.models.model import flatten, place_params
    from repro_torch.models.sharding import Rules, full_value
    from repro_torch.models.weights import load_flat
    from repro_torch.training import init_state, make_train_step
    cfg = _tiny(ref)
    params = place_params(load_flat(ref["init"], cfg, device="cpu"), cfg,
                          mesh)
    tx = make_optimizer("scale_fused", 1e-2)
    step = make_train_step(cfg, tx, clip_norm=1.0, rules=Rules(), mesh=mesh)
    state = init_state(params, tx)
    traj = []
    for b in ref["batches"]:
        state, m = step(state, {k: torch.from_numpy(x) for k, x in
                                b.items()})
        traj.append({"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": {k: _np(p) for k, p in
                                flatten(state.params).items()},
                     "mu": {k: _np(x) for k, x in
                            state.opt_state.mu.items() if x.numel()}})
    layouts = {k: str(p.placements) for k, p in
               flatten(state.params).items()}
    # the sharded state's checkpoint: rank 0 writes the full tensors
    d = os.path.join(tmp, "direct")
    save(d, STEPS, state)
    dist.barrier()
    full = {k: full_value(x).clone() for k, x in _leaves(state)}
    back = restore(d, STEPS, state)  # placed as the sharded state is
    same_sharded = all(torch.equal(full_value(x), full[k])
                       for k, x in _leaves(back))
    same_plain = None
    if rank == 0:
        plain = init_state(load_flat(ref["init"], cfg, device="cpu"), tx)
        got = restore(d, STEPS, plain)
        same_plain = all(not _is_dt(x) and torch.equal(x, full[k])
                         for k, x in _leaves(got))
    return {"traj": traj, "layouts": layouts, "same_sharded": same_sharded,
            "same_plain": same_plain}


def _is_dt(x):
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _leaves(state):
    from repro_torch.checkpoint.checkpointer import named_leaves
    return list(named_leaves(state))


def _launcher_check(ref, tmp, rank) -> dict:
    from repro_torch.launch import train as launch_train
    cfg = _tiny(ref)
    launch_train.get_arch = lambda name, smoke=False: cfg
    d = os.path.join(tmp, "launch")
    loss = launch_train.main(["--device", "cpu", "--arch", "tiny",
                              "--steps", "2", "--batch", "4", "--seq", "32",
                              "--ckpt-dir", os.path.join(d, "ckpt"),
                              "--ckpt-every", "2", "--log-dir",
                              os.path.join(d, "log"), "--metrics-every", "1",
                              "--log-every", "1"])
    return {"loss": loss}


# ----------------------------------------------------------- the job

@pytest.fixture(scope="module")
def job():
    train = _jax_train_inputs()
    ctx = torch.multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker,
                             args=(r, port, {"train": train}, tmp, q))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        try:
            refs = _jax_refs(train)  # while the workers run
            status, res = q.get(timeout=300)
        finally:
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
        assert status == "ok", res
        res["tmp_files"] = _files(tmp)
        res["restored_launch"] = _restore_launch(refs, tmp)
    return refs, res


def _files(tmp):
    out = []
    for root, _, files in os.walk(tmp):
        out += [os.path.relpath(os.path.join(root, f), tmp) for f in files]
    return sorted(out)


def _restore_launch(refs, tmp):
    """The launcher's committed step restored into the unsharded port."""
    from repro_torch.checkpoint import restore_latest
    from repro_torch.core import make_optimizer
    from repro_torch.models import init_params
    from repro_torch.training import init_state
    cfg = _tiny(refs["train"])
    gen = torch.Generator().manual_seed(0)
    like = init_state(init_params(cfg, gen, device="cpu"),
                      make_optimizer("scale", 1e-3), guard=True)
    got = restore_latest(os.path.join(tmp, "launch", "ckpt"), like)
    assert got is not None
    state, step = got
    return {"step": step, "finite": all(
        bool(torch.isfinite(x.float()).all()) for _, x in _leaves(state)),
        "plain": not any(_is_dt(x) for _, x in _leaves(state))}


# -------------------------------------------------------------- checks

def _ulp(x, dt):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - _MANT[dt])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", _opt_cases(),
                         ids=lambda c: "-".join(map(str, c)))
def test_sharded_optimizer_entry_points_match_jax(job, mesh, case):
    refs, res = job
    got = res["opt"][(mesh,) + case]
    want = refs["opt"][case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if case[2] == "f32":
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=2e-7)
        else:
            np.testing.assert_allclose(g, w, rtol=2**-7,
                                       atol=2**-7 * np.abs(w).max())


@pytest.mark.parametrize("case", _xent_cases(),
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-"
                         f"{'tied' if c[1] else 'untied'}-{c[2]}-{c[3]}")
def test_sharded_xent_loss_matches_jax(job, case):
    refs, res = job
    mshape, tied, dt, layout = case
    r = res["xent"][case]
    if layout == "ref":
        assert r["route"] == "ref" and r["plan"] is None
    else:
        # tokens over "data", the vocabulary over "model"
        assert r["route"] == "kernel"
        assert r["plan"] == (("data",), ("model",))
    val, dh, dw = r["vals"]
    want_val, want_dh, want_dw = refs["xent"][(tied, dt)]
    np.testing.assert_allclose(val, want_val, atol=2e-5, rtol=1e-5)
    tol = (2e-5, 1e-5) if dt == "f32" else (1e-5, 8e-3)
    for got, want in ((dh, want_dh), (dw, want_dw)):
        np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1])


def test_sharded_flash_attention_matches_jax(job):
    refs, res = job
    r = res["attn"]
    assert r["route"] == "kernel" and r["plan"] == (("data",), ("model",))
    assert r["placements"] == "(Shard(dim=0), Shard(dim=2))"
    for got, want in zip(r["vals"], refs["attn"]):
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("step", range(STEPS))
def test_sharded_train_steps_match_jax(job, step):
    refs, res = job
    ref, got = refs["train"]["traj"], res["train"]["traj"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[step][k], ref[step][k], rtol=1e-5,
                                   err_msg=k)
    peak = {k: np.abs(v) for k, v in refs["train"]["init"].items()}
    travel = {k: 0.0 * v for k, v in peak.items()}
    for s in range(step + 1):
        for k, w in ref[s]["params"].items():
            dw = np.abs(w - ref[s]["old"][k])
            peak[k] = np.maximum(peak[k], np.maximum(np.abs(w), dw))
            travel[k] = travel[k] + dw
    for k, w in ref[step]["params"].items():
        tol = 8 * _ulp(peak[k], "float32") + 1e-5 * travel[k].max()
        err = np.abs(got[step]["params"][k] - w)
        assert (err <= tol).all(), (k, float(err.max()))
    mus = {k[3:]: v for k, v in ref[step]["opt"].items()
           if k.startswith("mu/") and v.size}
    assert set(mus) == set(got[step]["mu"])
    for k, w in mus.items():
        err = np.abs(got[step]["mu"][k] - w)
        assert (err <= 4e-6 * np.abs(w).max()).all(), k


def test_sharded_params_follow_the_rules(job):
    """Under the default rules on (2, 2) the head is split (embed over
    data, vocab over model) and the norms are replicated."""
    _, res = job
    lay = res["train"]["layouts"]
    assert lay["lm_head/w"] == "(Shard(dim=0), Shard(dim=1))"
    assert lay["tok_embed/w"] == "(Shard(dim=1), Shard(dim=0))"
    assert lay["segments/seg0_dense/attn/wq"] == (
        "(Shard(dim=1), Shard(dim=2))")
    assert lay["final_norm/s"] == "(Replicate(), Replicate())"


def test_sharded_checkpoint_restores_bitwise(job):
    _, res = job
    assert res["train"]["same_plain"] is True
    assert res["train"]["same_sharded"] is True


def test_sharded_launcher_writes_once_and_restores_unsharded(job):
    _, res = job
    files = res["tmp_files"]
    assert [f for f in files if f.startswith("launch/log/")] == [
        "launch/log/metrics.0.jsonl"]
    assert "launch/ckpt/step_0000000002/COMMITTED" in files
    assert res["restored_launch"] == {"step": 2, "finite": True,
                                      "plain": True}
    assert np.isfinite(res["launcher"]["loss"])
