"""The port's rules table and meshes (``repro_torch.models.sharding``,
``repro_torch.launch.mesh``) against the JAX package's.

``Rules.spec`` reads only a mesh's axis names and sizes, on both sides,
so the meshes here are duck-typed — (1, 1), (2, 2), (4, 2), (16, 16) and
(2, 16, 16) with "pod" — and no JAX device or process group is built
(building a JAX mesh is what the reference's own sharded tests trip on
under this JAX; ROADMAP.md reference caveat 2). Every leaf of llama-130m,
llama-1b, gemma-2b and a tied llama-1b must get the same spec, with and
without its shape (the divisibility guard), and the same per-dim axes.
The batch's layouts (``shard_batch``'s ``batch_axes``) are held against
JAX's ``launch/dryrun.input_specs`` for the VLM's images and an audio
model's (B, C, S) tokens, under the default rules and under an override
that maps "act_seq" to "model"; the audio logits' layout against JAX's
three-axis annotation (ROADMAP.md reference caveat 16).
Exact equality throughout: these are tables, not numbers.
"""
import dataclasses
import math
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402

MESHES = {
    "1x1": (("data", "model"), (1, 1)),
    "2x2": (("data", "model"), (2, 2)),
    "4x2": (("data", "model"), (4, 2)),
    "16x16": (("data", "model"), (16, 16)),
    "pod2x16x16": (("pod", "data", "model"), (2, 16, 16)),
}
ARCHS = ("llama-130m", "llama-1b", "gemma-2b", "llama-1b-tied")


def _jax_mesh(names, shape):
    """What JAX's Rules.spec reads of a Mesh."""
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))


def _torch_mesh(names, shape):
    """What the port's Rules.spec reads of a DeviceMesh."""
    return SimpleNamespace(mesh_dim_names=names, shape=shape)


def _cfgs(arch):
    name = arch.replace("-tied", "")
    jcfg, tcfg = jreg.get_arch(name), treg.get_arch(name)
    if arch.endswith("-tied"):
        jcfg = dataclasses.replace(jcfg, tie_embeddings=True)
        tcfg.tie_embeddings = True
    return jcfg, tcfg


def _jax_axes(jcfg) -> dict:
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        JM.param_logical_axes(jcfg),
        is_leaf=lambda x: isinstance(x, tuple))
    return {path_str(p).lstrip("."): tuple(a) for p, a in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_axes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    want = _jax_axes(jcfg)
    got = TM.param_logical_axes(tcfg)
    assert got == want
    assert set(got) == set(TM.param_shapes(tcfg))
    assert ("lm_head/w" in got) != tcfg.tie_embeddings


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_spec_matches_jax_on_every_leaf(arch, mesh):
    names, shape = MESHES[mesh]
    jm, tm = _jax_mesh(names, shape), _torch_mesh(names, shape)
    jcfg, tcfg = _cfgs(arch)
    axes, shapes = TM.param_logical_axes(tcfg), TM.param_shapes(tcfg)
    jr, tr = JS.Rules(jcfg.rule_overrides), TS.Rules(tcfg.rule_overrides)
    for k, ax in axes.items():
        for shp in (None, shapes[k]):
            want = tuple(jr.spec(ax, jm, shp))
            got = tr.spec(ax, tm, shp)
            assert isinstance(got, TS.PartitionSpec)
            assert tuple(got) == want, (k, shp)
            assert TS.spec_mesh_axes(got, len(shapes[k])) == \
                JS.spec_mesh_axes(jr.spec(ax, jm, shp), len(shapes[k]))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tree_shardings_and_activation_specs_match_jax(mesh):
    names, shape = MESHES[mesh]
    jm, tm = _jax_mesh(names, shape), _torch_mesh(names, shape)
    jcfg, tcfg = _cfgs("llama-1b")
    got = TS.tree_shardings(TM.param_logical_axes(tcfg), tm, TS.Rules(),
                            TM.param_shapes(tcfg))
    jr = JS.Rules()
    for k, sh in got.items():
        assert sh.mesh is tm
        assert tuple(sh.spec) == tuple(jr.spec(
            TM.param_logical_axes(tcfg)[k], jm, TM.param_shapes(tcfg)[k]))
    # the activations and the loss's operands at llama-1b's train shape
    for ax, shp in ((("act_batch", "act_seq", "act_embed"), (16, 256, 2048)),
                    (("act_batch", None, "act_heads", None),
                     (16, 256, 32, 64)),
                    (("embed", "vocab"), (2048, 32000)),
                    (("vocab", "embed"), (32000, 2048)),
                    (("act_batch", "act_seq"), (3, 256))):
        assert tuple(TS.Rules().spec(ax, tm, shp)) == tuple(
            jr.spec(ax, jm, shp))


def test_rules_overrides_match_jax():
    over = (("embed", ()), ("act_residual", ("model",)), ("vocab", None))
    names, shape = MESHES["4x2"]
    jm, tm = _jax_mesh(names, shape), _torch_mesh(names, shape)
    for ax in (("embed", "vocab"), ("act_batch", "act_seq", "act_residual"),
               ("vocab", "embed")):
        assert tuple(TS.Rules(over).spec(ax, tm, (64, 64, 64)[:len(ax)])) \
            == tuple(JS.Rules(over).spec(ax, jm, (64, 64, 64)[:len(ax)]))


def test_placements_split_major_to_minor():
    """A dim over two mesh axes is Shard on both, in mesh order (how
    DTensor and JAX both split it); another order raises."""
    from torch.distributed.tensor import Replicate, Shard
    tm = _torch_mesh(("pod", "data", "model"), (2, 16, 16))
    spec = TS.Rules().spec(("act_batch", "act_seq", "act_embed"), tm,
                           (64, 8, 8))
    assert tuple(spec) == (("pod", "data"), None, None)
    assert TS.placements(spec, tm, 3) == (Shard(0), Shard(0), Replicate())
    assert TS.placements(TS.P(None, "model"), tm, 2) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        TS.placements(TS.P(("data", "pod")), tm, 1)


def test_shard_is_a_no_op_off_mesh():
    x = torch.ones(4, 8)
    assert TS.shard(x, ("act_batch", "act_embed"), TS.Rules()) is x
    assert TS.full_value(x) is x


def test_make_host_mesh_errors_match_jax():
    """Without a process group the world is one rank, as JAX here sees one
    CPU device: a data axis of 2 is the same error on both sides."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError) as got:
        tmesh.make_host_mesh(data=2)
    with pytest.raises(ValueError) as bad:
        tmesh.make_host_mesh(data=0)
    if len(jax.devices()) == 1:
        with pytest.raises(ValueError) as want:
            jmesh.make_host_mesh(data=2)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError) as want0:
            jmesh.make_host_mesh(data=0)
        assert str(bad.value) == str(want0.value)
    assert "must be a positive divisor of the device count" in str(got.value)


def test_make_production_mesh_needs_its_ranks():
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            tmesh.make_production_mesh(multi_pod=multi)


def _dryrun():
    """``repro.launch.dryrun`` without its 512 host devices: the module
    sets XLA_FLAGS when it is imported, so JAX's backend is started first
    (with this process's devices) and the variable is put back after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


def jax_input_specs(jcfg, batch: int, seq: int, mesh, rules) -> dict:
    """{leaf: (shape, JAX spec as a tuple)} of ``dryrun.input_specs`` for
    a train cell of ``jcfg``, its shardings' specs taken by ``rules``
    (JAX's ``Rules``) on ``mesh`` (duck-typed: ``Rules.spec`` reads only
    the axis names and sizes)."""
    cell = SimpleNamespace(global_batch=batch, seq_len=seq, kind="train")
    specs, sh = _dryrun().input_specs(jcfg, cell, mesh, SimpleNamespace(
        sharding=lambda axes, m, shape: rules.spec(axes, m, shape)))
    return {k: (tuple(specs[k].shape), tuple(sh[k])) for k in specs}


BATCH_ARCHS = ("llama-130m", "llama-3.2-vision-11b", "musicgen-medium")
SEQ_OVER_MODEL = (("act_seq", ("model",)),)


@pytest.mark.parametrize("over", [(), SEQ_OVER_MODEL],
                         ids=["default", "seq_over_model"])
@pytest.mark.parametrize("mesh", ["2x2", "4x2", "pod2x16x16"])
@pytest.mark.parametrize("arch", BATCH_ARCHS)
def test_batch_layouts_match_jax_input_specs(arch, mesh, over):
    """Each batch leaf's spec and DTensor placements (``batch_axes``,
    which ``shard_batch`` lays the leaf out by) equal JAX's over
    ``dryrun.input_specs``' axes: (B, S) tokens and labels per
    ("act_batch", "act_seq"), audio's (B, C, S) per ("act_batch", None,
    "act_seq"), the images per ("act_batch", None, "act_embed"). With
    "act_seq" over "model" the text's S splits, the codebook axis and the
    images' T do not."""
    names, shape = MESHES[mesh]
    jm, tm = _jax_mesh(names, shape), _torch_mesh(names, shape)
    jcfg = jreg.get_arch(arch, smoke=True) if arch != "llama-130m" \
        else jreg.get_arch(arch)
    B = math.prod(shape) * 2
    want = jax_input_specs(jcfg, B, 32, jm, JS.Rules(over))
    leaves = {"tokens", "labels"} | (
        {"image_embeds"} if jcfg.family == "vlm" else set())
    assert set(want) == leaves
    for k, (shp, spec) in want.items():
        got = TS.Rules(over).spec(TS.batch_axes(k, len(shp)), tm, shp)
        assert tuple(got) == spec, k
        assert TS.placements(got, tm, len(shp)) == TS.placements(
            TS.P(*spec), tm, len(shp)), k
    if over and mesh == "2x2":
        seq = {"llama-130m": ("data", "model"),
               "llama-3.2-vision-11b": ("data", "model"),
               "musicgen-medium": ("data", None, "model")}[arch]
        assert want["tokens"][1] == seq
        if "image_embeds" in want:
            assert want["image_embeds"][1] == ("data", None, None)


@pytest.mark.parametrize("mesh", ["2x2", "4x2", "16x16"])
def test_audio_logits_layout_matches_jax(mesh):
    """The audio logits (B, C, S, V) take ``logits_from_hidden``'s three
    logical axes on their first three dims, as JAX's annotation does:
    "act_vocab" lands on S, V stays whole (caveat 16)."""
    names, shape = MESHES[mesh]
    jm, tm = _jax_mesh(names, shape), _torch_mesh(names, shape)
    cfg = treg.get_arch("musicgen-medium")
    full = (16, cfg.n_codebooks, 256, cfg.padded_vocab)
    want = tuple(JS.Rules().spec(("act_batch", "act_seq", "act_vocab"), jm,
                                 full))
    got = TS.Rules().spec(TM.LOGITS_AXES, tm, full)
    assert tuple(got) == want == ("data", None, "model")
    assert TS.spec_mesh_axes(got, 4)[3] == ()
