"""The ``ARCH_IDS`` configurations in the port against the JAX package's:
the registry, shapes and counts of the full-size configurations (from the
specs alone, nothing allocated; deepseek-v3-671b's against JAX's nameplate
bounds too), the paper's memory accounting on dbrx-132b, a forward and a training step of the four dense ``SMOKE``
twins, and the launcher's ``--smoke`` (dbrx-132b, mamba2-370m,
jamba-1.5-large-398b, llama-3.2-vision-11b and musicgen-medium).

Inputs come from JAX's ``init_params`` and data pipeline, crossed over as
numpy through ``load_flat``; torch runs on one intra-op thread. Tolerances
are those of ``tests/test_torch_trainer.py`` in f32, with its reasons:
hidden states 1e-4 absolute (observed 2.1e-6), metrics 1e-5 relative
(observed 6.2e-7), params per element 8 ulps of their peak plus 1e-5 of
the leaf's step (observed 2.8e-6 of it). qwen2's qkv biases take Adam's
first step, lr * g / (|g| + eps) with g = m_hat: the gradient of the key
bias nearly cancels (a vector added to every key moves the scores only
through RoPE's rotation), so the two sides' rounding of it is a larger
share of it, and the step carries that share; they are held to 2e-3 of
their step (observed 9.7e-4 for bk, 2.9e-5 for bq).
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core import memory as JMem  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.data import make_dataset as j_dataset  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import trainer as JT  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.core import memory as TMem  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.model import flatten  # noqa: E402
from repro_torch.models.weights import load_flat  # noqa: E402
from repro_torch.training import init_state, make_train_step  # noqa: E402

PORTED = ("qwen2-7b", "granite-3-8b", "deepseek-67b", "mistral-large-123b",
          "dbrx-132b", "deepseek-v3-671b", "mamba2-370m",
          "jamba-1.5-large-398b", "llama-3.2-vision-11b", "musicgen-medium")
DENSE = PORTED[:4]
# the last two families ported (the VLM and audio), which raised "not yet
# ported" before them
LAST_PORTED = ("llama-3.2-vision-11b", "musicgen-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jflat(tree) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {path_str(p).lstrip("."): np.asarray(x.astype(jnp.float32))
            if x.dtype != jnp.int32 else np.asarray(x) for p, x in leaves}


def _ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(x)) - 23)


# ------------------------------------------------------------ registry

def test_ported_and_unported_ids_partition_arch_ids():
    """Every ``ARCH_IDS`` entry is ported: none is left unported."""
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    assert set(PORTED) == set(jreg.ARCH_IDS)
    assert set(treg._MODULES) == set(PORTED)


@pytest.mark.parametrize("smoke", [False, True], ids=["config", "smoke"])
@pytest.mark.parametrize("arch", PORTED)
def test_get_arch_matches_jax_field_by_field(arch, smoke):
    j, t = jreg.get_arch(arch, smoke=smoke), treg.get_arch(arch, smoke=smoke)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.head_dim, t.padded_vocab, t.segments) == (
        j.head_dim, j.padded_vocab, j.segments)
    # a fresh copy each call, as JAX's dataclasses.replace gives
    t.n_layers = -1
    assert treg.get_arch(arch, smoke=smoke).n_layers == j.n_layers


@pytest.mark.parametrize("arch", LAST_PORTED)
def test_unported_ids_raise(arch):
    """The two ids that raised "not yet ported" until the VLM and audio
    families were ported now give JAX's config, with and without
    ``smoke``; only an id outside the registry raises."""
    for smoke in (False, True):
        got = treg.get_arch(arch, smoke=smoke)
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jreg.get_arch(arch, smoke=smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        treg.get_arch(arch + "-x")


@pytest.mark.parametrize("arch", PORTED)
def test_param_shapes_and_counts_match_jax(arch):
    """Every parameter's path and shape, the total and the MoE-active
    counts, of the full-size configuration, from the specs alone."""
    j, t = jreg.get_arch(arch), treg.get_arch(arch)
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.model_spec(j), is_leaf=lambda x: isinstance(x, JL.Spec))
    want = {path_str(p).lstrip("."): tuple(s.shape) for p, s in leaves}
    shapes = TM.param_shapes(t)
    assert shapes == want
    assert TM.count_params(shapes) == j.num_params() == t.num_params()
    assert (TM.count_params(shapes, cfg=t, active_only=True)
            == j.active_params() == t.active_params())
    if arch == "dbrx-132b":
        # 16 experts, top 4: a quarter of the expert leaves is active
        assert shapes["segments/seg0_moe/ffn/w_gate"] == (40, 16, 6144, 10752)
        assert t.active_params() < t.num_params() / 3
    elif arch == "deepseek-v3-671b":
        # JAX's nameplate bounds (tests/test_models_smoke.py): 671 B total,
        # 37 B activated; 3 dense MLA layers, then 58 MLA + MoE layers
        assert 660e9 <= t.num_params() <= 685e9
        assert 34e9 <= t.active_params() <= 40e9
        assert shapes["segments/seg1_moe/ffn/w_gate"] == (58, 256, 7168, 2048)
        assert shapes["segments/seg0_dense/attn/wkv_b"] == (3, 512, 128 * 256)
        assert shapes["segments/seg1_moe/attn/wq_b"] == (58, 1536, 128 * 192)
    elif arch == "mamba2-370m":
        # 48 attention-free layers; in_proj packs z, x, B, C and dt
        assert 0.41e9 <= t.num_params() <= 0.43e9
        assert shapes["segments/seg0_ssm/mamba/in_proj"] == (48, 1024, 4384)
        assert shapes["segments/seg0_ssm/mamba/conv_w"] == (48, 4, 2304)
        assert shapes["segments/seg0_ssm/mamba/A_log"] == (48, 32)
        assert t.active_params() == t.num_params()
    elif arch == "jamba-1.5-large-398b":
        # 9 hybrid super-blocks of 8: attention + MLP, then 7 Mamba2
        # sub-layers with MoE at the odd positions (16 experts, top 2)
        assert 390e9 <= t.num_params() <= 400e9
        assert 90e9 <= t.active_params() <= 96e9
        assert shapes["segments/seg0_hybrid/attn/wq"] == (9, 8192, 64 * 128)
        assert shapes["segments/seg0_hybrid/ffn1/w_gate"] == (9, 16, 8192,
                                                              24576)
        assert shapes["segments/seg0_hybrid/ffn2/w_gate"] == (9, 8192, 24576)
        assert shapes["segments/seg0_hybrid/mamba7/in_proj"] == (9, 8192,
                                                                 33280)
        assert "segments/seg0_hybrid/ffn7/router" in shapes
    elif arch == "llama-3.2-vision-11b":
        # 8 vlm super-blocks of 5: cross-attention + MLP, then 4 x
        # (self-attention + MLP); the cross sub-layer has no bias
        assert t.num_params() == 9_775_157_248
        assert shapes["segments/seg0_vlm/cross/wk"] == (8, 4096, 8 * 128)
        assert shapes["segments/seg0_vlm/attn4/wq"] == (8, 4096, 32 * 128)
        assert "segments/seg0_vlm/ffn4/w_down" in shapes
        assert t.active_params() == t.num_params()
    elif arch == "musicgen-medium":
        # 4 codebooks: a (C, V, D) embedding and (C, D, V) heads
        assert t.num_params() == 1_837_254_144
        assert shapes["tok_embed/w"] == (4, 2048, 1536)
        assert shapes["lm_head/w"] == (4, 1536, 2048)
        assert t.active_params() == t.num_params()
    else:
        assert t.active_params() == t.num_params()


def test_dbrx_memory_report_matches_jax():
    shapes = TM.param_shapes(treg.get_arch("dbrx-132b"))
    for method in TMem.METHODS:
        for kw in ({}, {"dtype_bytes": 4}):
            got = TMem.memory_report(shapes, method, **kw)
            want = JMem.memory_report(shapes, method, **kw)
            assert (got.weight_bytes, got.state_bytes) == (
                want.weight_bytes, want.state_bytes), (method, kw)


# ------------------------------------------- the dense smoke twins, run

@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_forward_and_train_step_match_jax(arch):
    """The SMOKE twin's forward and one ``scale_fused`` step (clip 1.0)
    from JAX's params on JAX's batch: qwen2's qkv bias, granite's
    unaligned vocab (387 padded to 512, the masked loss), mistral's
    d_model 192."""
    jcfg = jreg.get_arch(arch, smoke=True)
    tcfg = treg.get_arch(arch, smoke=True)
    jp = jax.jit(lambda key: JM.init_params(key, jcfg))(jax.random.PRNGKey(0))
    tp = load_flat(_jflat(jp), tcfg, device="cpu")
    ds = j_dataset(jcfg, seq_len=32, global_batch=4, seed=3)
    b = {k: np.array(v) for k, v in ds.global_batch_at(0).items()}

    jh, _, _ = jax.jit(lambda p, t: JM.forward(p, jcfg, t))(
        jp, jnp.asarray(b["tokens"]))
    th, _, taux = TM.forward(tp, tcfg, torch.from_numpy(b["tokens"]))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=0)
    assert float(taux) == 0.0

    jtx, ttx = j_make("scale_fused", 1e-2), t_make("scale_fused", 1e-2)
    js, jm = jax.jit(JT.make_train_step(jcfg, jtx, clip_norm=1.0))(
        JT.init_state(jp, jtx), {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = make_train_step(tcfg, ttx, clip_norm=1.0)(
        init_state(tp, ttx), {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("loss", "grad_norm", "update_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    old = _jflat(jp)
    for k, w in _jflat(js.params).items():
        step = np.abs(w - old[k])
        rel = 2e-3 if k.rsplit("/", 1)[-1] in ("bq", "bk", "bv") else 1e-5
        tol = 8 * _ulp(np.maximum(np.abs(old[k]), np.maximum(np.abs(w), step))
                       ) + rel * step.max()
        err = np.abs(flatten(ts.params)[k].float().numpy() - w)
        assert (err <= tol).all(), (k, float(err.max()))


# ------------------------------------------------------------ launcher

def test_launcher_smoke_dbrx_loss_falls():
    """``python -m repro_torch.launch.train --arch dbrx-132b --smoke
    --device cpu``: 8 steps of the MoE twin whose loss falls."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = launch_train.main(
            ["--arch", "dbrx-132b", "--smoke", "--device", "cpu", "--steps",
             "8", "--batch", "4", "--seq", "32", "--log-every", "1",
             "--optimizer", "scale_fused", "--lr", "1e-2"])
    out = buf.getvalue()
    assert "arch=dbrx-132b-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and abs(losses[-1] - final) <= 5e-5
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.2, losses


def test_launcher_smoke_jamba_loss_falls():
    """``python -m repro_torch.launch.train --arch jamba-1.5-large-398b
    --smoke --device cpu``: 8 steps of the hybrid twin (two super-blocks
    of attention, Mamba2, MoE and MLP) whose loss falls."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = launch_train.main(
            ["--arch", "jamba-1.5-large-398b", "--smoke", "--device", "cpu",
             "--steps", "8", "--batch", "4", "--seq", "32", "--log-every",
             "1", "--optimizer", "scale_fused", "--lr", "1e-2"])
    out = buf.getvalue()
    assert "arch=jamba-1.5-large-398b-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and abs(losses[-1] - final) <= 5e-5
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.2, losses


@pytest.mark.parametrize("arch", LAST_PORTED)
def test_launcher_smoke_vlm_and_audio_loss_falls(arch):
    """``python -m repro_torch.launch.train --arch <id> --smoke --device
    cpu``: 8 steps of the VLM twin (with the data pipeline's image
    embeddings) and of the audio twin (4 codebook heads) whose loss
    falls."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = launch_train.main(
            ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "8",
             "--batch", "4", "--seq", "32", "--log-every", "1",
             "--optimizer", "scale_fused", "--lr", "1e-2"])
    out = buf.getvalue()
    assert f"arch={arch}-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and abs(losses[-1] - final) <= 5e-5
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.2, losses


def test_launcher_smoke_mamba2_loss_falls():
    """``python -m repro_torch.launch.train --arch mamba2-370m --smoke
    --device cpu``: 8 steps of the Mamba2 twin (2 chunks of 16 a row)
    whose loss falls."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        final = launch_train.main(
            ["--arch", "mamba2-370m", "--smoke", "--device", "cpu",
             "--steps", "8", "--batch", "4", "--seq", "32", "--log-every",
             "1", "--optimizer", "scale_fused", "--lr", "1e-2"])
    out = buf.getvalue()
    assert "arch=mamba2-370m-smoke" in out
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 8 and abs(losses[-1] - final) <= 5e-5
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < losses[0] - 0.2, losses
