"""The port's checkpointer (``repro_torch.checkpoint``) against the JAX
package's, and the JAX chaos matrix of ``tests/test_checkpoint.py`` and
``tests/test_resilience.py`` mirrored on torch trees.

  * the codec (``checkpoint/_msgpack.py``) gives the bytes of
    ``msgpack.packb(..., use_bin_type=True)`` for the shard subset, at
    every header-width boundary and on seeded random trees (zero-length
    and bf16 leaves among them), and reads any valid encoding of it;
  * a JAX ``TrainState`` (bf16 params at ``conftest.tiny_cfg`` sizes,
    SCALE's state with its zero-length hidden-matrix moments, the guard's
    leaves; and Stable-SPAM's and GaLore's ``extra``) saved by
    ``repro.checkpoint.save`` restores into the port bitwise; the port
    saves it again to the same shard bytes and the same manifests; a
    state the port trained restores through ``repro.checkpoint.restore``
    bitwise.

Everything is compared bitwise (raw bytes): no tolerance applies.
"""
import dataclasses
import json
import os
import threading
import warnings
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.core import make_optimizer as j_make  # noqa: E402
from repro.core.labels import path_str  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import init_state as j_init_state  # noqa: E402
import repro_torch.checkpoint as ckpt  # noqa: E402
from repro_torch.checkpoint import _msgpack as M  # noqa: E402
from repro_torch.checkpoint import checkpointer as C  # noqa: E402
from repro_torch.core import make_optimizer as t_make  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import (SimulatedKill, faults,  # noqa: E402
                                  init_state, make_train_step)
from test_torch_optimizers import one_torch_thread  # noqa: E402,F401


@pytest.fixture(autouse=True)
def _clean_fault_state():
    faults.reset()
    yield
    faults.reset()


# ---------------------------------------------------------------- the codec

def _leafset(rng, n):
    """n seeded random leaves (key, dtype, shape, bytes) with ragged key
    lengths, 0-d, zero-length and bf16 leaves among them."""
    out = []
    for i in range(n):
        dt = ["float32", "bfloat16", "int32", "float16", "bool"][i % 5]
        ndim = int(rng.integers(0, 4))
        shape = [int(rng.choice([0, 1, 3, 127, 128, 300]))
                 for _ in range(ndim)]
        if np.prod(shape) > 4096:
            shape = shape[:1]
        size = {"float32": 4, "bfloat16": 2, "int32": 4, "float16": 2,
                "bool": 1}[dt] * int(np.prod(shape))
        key = "." + "k" * int(rng.integers(1, 40)) + f"/{i}"
        out.append((key, dt, shape, rng.bytes(size)))
    return out


def _packb(leaves):
    return msgpack.packb({k: {"dtype": d, "shape": s, "data": b}
                          for k, d, s, b in leaves}, use_bin_type=True)


@pytest.mark.parametrize("seed", range(6))
def test_codec_matches_msgpack_on_random_shards(seed):
    rng = np.random.default_rng(seed)
    leaves = _leafset(rng, [1, 15, 16, 40, 3, 70][seed])
    ours = b"".join(bytes(c) for c in M.shard_chunks(leaves))
    assert ours == _packb(leaves)
    back = M.unpackb(ours)
    assert list(back) == [k for k, *_ in leaves]
    for k, d, s, b in leaves:
        assert back[k]["dtype"] == d and back[k]["shape"] == s
        assert bytes(back[k]["data"]) == b


@pytest.mark.parametrize("n", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_codec_header_widths_match_msgpack(n):
    """Every str, bin, array and int header at its width boundaries."""
    assert M.pack_str("s" * n) == msgpack.packb("s" * n, use_bin_type=True)
    assert M.bin_header(n) + b"b" * n == msgpack.packb(b"b" * n,
                                                       use_bin_type=True)
    assert M.pack_int(n) == msgpack.packb(n)
    if n <= 65536:
        a = list(range(n % 300))
        assert (M.array_header(len(a)) + b"".join(M.pack_int(v) for v in a)
                == msgpack.packb(a))


def test_codec_reads_non_minimal_encodings_and_rejects_truncation():
    # {"dtype": "int32", "shape": [2], "data": 8 bytes}, every header in a
    # wider form than the writer's: map16, str16, array32, uint32, bin32
    raw = (b"\xde\x00\x01" + b"\xda\x00\x02ab"
           + b"\xde\x00\x03"
           + b"\xda\x00\x05dtype" + b"\xdb\x00\x00\x00\x05int32"
           + b"\xd9\x05shape" + b"\xdd\x00\x00\x00\x01\xce\x00\x00\x00\x02"
           + b"\xa4data" + b"\xc6\x00\x00\x00\x08" + bytes(range(8)))
    got = M.unpackb(raw)
    assert msgpack.unpackb(raw, raw=False) == {
        k: dict(v, data=bytes(v["data"])) for k, v in got.items()}
    assert got["ab"]["shape"] == [2] and bytes(got["ab"]["data"]) == \
        bytes(range(8))
    for cut in (1, 5, len(raw) - 1):
        with pytest.raises(ValueError, match="truncated"):
            M.unpackb(raw[:cut])
    with pytest.raises(ValueError, match="trailing"):
        M.unpackb(raw + b"\x00")
    with pytest.raises(ValueError, match="outside the checkpoint subset"):
        M.unpackb(b"\xcb" + bytes(8))   # a float64
    # negative ints, which the writer never packs, read in every width
    for v in (-1, -32, -33, -200, -40000, -2**31 - 1):
        assert M.unpackb(msgpack.packb(v)) == v


# ------------------------------------------ JAX <-> port, bitwise, both ways

def _jax_state(opt, guard, seed=0):
    """A JAX TrainState of the tiny bf16 model, every leaf seeded random
    (floats normal, ints small), and the port's like-tree for it."""
    jcfg = tiny_cfg("ckpt", dtype="bfloat16")
    kw = {"rank": 8, "update_proj_gap": 3} if opt == "galore" else {}
    js = j_init_state(JM.init_params(jax.random.PRNGKey(0), jcfg),
                      j_make(opt, 1e-3, **kw), guard=guard)
    rng = np.random.default_rng(seed)

    def rand(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(rng.standard_normal(x.shape, np.float32),
                               x.dtype)
        return jnp.asarray(rng.integers(0, 50, x.shape), x.dtype)

    js = jax.tree_util.tree_map(rand, js)
    tcfg = tconfig.ModelConfig(**dataclasses.asdict(jcfg))
    ttx = t_make(opt, 1e-3, **kw)
    like = init_state(init_params(tcfg, torch.Generator().manual_seed(1),
                                  device="cpu"), ttx, guard=guard)
    return js, like, tcfg, ttx


def _jax_leaves(tree) -> dict:
    return {path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_bitwise(port_tree, jax_tree):
    want = _jax_leaves(jax_tree)
    got = dict(C.named_leaves(port_tree))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert C._NAMES[g.dtype] == str(w.dtype), k
        assert tuple(g.shape) == w.shape, k
        assert C._raw(g.contiguous()).tobytes() == w.tobytes(), k


def _files(step_dir):
    shard = [n for n in os.listdir(step_dir) if n.startswith("shard_")]
    with open(os.path.join(step_dir, shard[0]), "rb") as f:
        data = f.read()
    mans = {}
    for n in ("manifest.00000.json", "manifest.json"):
        with open(os.path.join(step_dir, n)) as f:
            mans[n] = json.load(f)
    return shard, data, mans


@pytest.mark.parametrize("opt,guard", [("scale", True), ("scale", False),
                                       ("stable_spam", True),
                                       ("galore", False)])
def test_jax_checkpoint_restores_into_port_and_saves_back_identically(
        tmp_path, opt, guard):
    js, like, _, _ = _jax_state(opt, guard)
    # "none" is what a machine without zstandard writes; "auto" compresses
    # where it is installed
    for comp in ("none", "auto"):
        a, b = str(tmp_path / f"jax_{comp}"), str(tmp_path / f"port_{comp}")
        jpath = jckpt.save(a, 5, js, compression=comp)
        got = ckpt.restore(a, 5, like)
        _assert_bitwise(got, js)
        # the port writes the very bytes and manifests JAX wrote
        tpath = ckpt.save(b, 5, got, compression=comp)
        assert _files(tpath) == _files(jpath)
        _assert_bitwise(got, jckpt.restore(b, 5, js))
    assert isinstance(got.params, type(like.params))
    assert got.params["tok_embed"]["w"].dtype == torch.bfloat16
    assert got.opt_state.host_count.n == int(got.opt_state.count)
    if opt == "scale":   # SCALE keeps no moments for hidden matrices
        assert got.opt_state.mu["segments/seg0_dense/attn/wq"].shape == (0,)


def test_port_trained_state_restores_through_jax_bitwise(tmp_path):
    js, like, tcfg, ttx = _jax_state("scale_fused", True)
    del like
    from repro_torch.data import make_dataset
    from repro_torch.training import GuardPolicy
    params = init_params(tcfg, torch.Generator().manual_seed(2),
                         device="cpu")
    state = init_state(params, ttx, guard=True)
    step = make_train_step(tcfg, ttx, clip_norm=1.0, guard=GuardPolicy())
    ds = make_dataset(tcfg, 32, 4, seed=0, device="cpu")
    for i in range(2):
        state, _ = step(state, ds.host_batch_at(i))
    ckpt.save(str(tmp_path), 2, state)
    back = jckpt.restore(str(tmp_path), 2, js)
    _assert_bitwise(state, back)
    assert int(back.step) == 2 and int(back.guard.ema_count) == 2


def test_restore_casts_into_the_like_dtype_and_keeps_bf16_on_disk(tmp_path):
    x = torch.randn(4, 6).to(torch.bfloat16)
    path = ckpt.save(str(tmp_path), 1, {"w": x})
    with open(os.path.join(path, "manifest.00000.json")) as f:
        man = json.load(f)
    assert man["leaves"]["w"] == {"dtype": "bfloat16", "shape": [4, 6]}
    got = ckpt.restore(str(tmp_path), 1, {"w": torch.zeros(4, 6)})
    assert got["w"].dtype == torch.float32
    assert torch.equal(got["w"], x.float())


# ------------------------------------------------ the JAX chaos matrix

def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": {"w": torch.randn(8, 16, generator=g),
                  "b": torch.arange(5, dtype=torch.int32)},
            "step": torch.tensor(7, dtype=torch.int32)}


def _equal(a, b):
    la, lb = list(C.named_leaves(a)), list(C.named_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _corrupt_shard(step_dir):
    (shard,) = (os.path.join(step_dir, n) for n in os.listdir(step_dir)
                if n.startswith("shard_00000"))
    with open(shard, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00\x00\x00")


def _assert_committed_steps_verifiable(directory, like):
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.exists(os.path.join(full, "COMMITTED")):
            ckpt.restore(directory, int(name[5:]), like)


def test_roundtrip_exact(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 10, tree)
    _equal(ckpt.restore(str(tmp_path), 10, tree), tree)


def test_restore_latest_and_retention(tmp_path):
    tree = make_tree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert ckpt.latest_step(str(tmp_path)) == 5
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path)
                   if n.startswith("step_"))
    assert steps == [3, 4, 5]
    _, step = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 5


def test_uncommitted_checkpoints_skipped(tmp_path):
    ckpt.save(str(tmp_path), 1, make_tree())
    os.makedirs(tmp_path / "step_0000000002")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checksum_corruption_detected(tmp_path):
    tree = make_tree()
    _corrupt_shard(ckpt.save(str(tmp_path), 3, tree))
    with pytest.raises(ckpt.CorruptCheckpointError, match="checksum"):
        ckpt.restore(str(tmp_path), 3, tree)


def test_truncated_shard_with_matching_checksum_is_corrupt(tmp_path):
    """A shard cut short whose manifest crc was rewritten to match: the
    decode fails and is reported as corruption, not as a bare error."""
    tree = make_tree()
    path = ckpt.save(str(tmp_path), 3, tree)
    (name,) = (n for n in os.listdir(path) if n.startswith("shard_00000"))
    shard = os.path.join(path, name)
    with open(shard, "rb") as f:
        data = f.read()[:-9]
    with open(shard, "wb") as f:
        f.write(data)
    man_path = os.path.join(path, "manifest.00000.json")
    with open(man_path) as f:
        man = json.load(f)
    man["checksums"][name] = zlib.crc32(data)
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ckpt.CorruptCheckpointError, match="decode"):
        ckpt.restore(str(tmp_path), 3, tree)


def test_shape_mismatch_rejected(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 1, tree)
    wrong = {"a": {"w": torch.zeros(4, 4), "b": tree["a"]["b"]},
             "step": tree["step"]}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), 1, wrong)


def test_restore_latest_none_when_empty(tmp_path):
    assert ckpt.restore_latest(str(tmp_path), make_tree()) is None


def test_stale_tmp_shard_does_not_poison_save(tmp_path):
    tree = make_tree()
    tmp_dir = tmp_path / "step_0000000004.tmp"
    os.makedirs(tmp_dir)
    with open(tmp_dir / "shard_00000.mpk.zst", "wb") as f:
        f.write(b"garbage from a crashed zstd save")
    with open(tmp_dir / "manifest.json", "w") as f:
        f.write('{"checksums": {"shard_00000.mpk.zst": 123}}')
    ckpt.save(str(tmp_path), 4, tree)
    _equal(ckpt.restore(str(tmp_path), 4, tree), tree)


def test_async_save_snapshots_before_returning(tmp_path):
    """The train step writes params and momentum in place: a write into the
    saved tensors right after save_async returns must not reach disk."""
    tree = make_tree()
    want = {"a": {"w": tree["a"]["w"].clone(), "b": tree["a"]["b"].clone()},
            "step": tree["step"].clone()}
    h = ckpt.save_async(str(tmp_path), 42, tree)
    tree["a"]["w"].mul_(0).add_(float("nan"))
    tree["step"].add_(1)
    path = h.wait(timeout=30)
    assert h.done and path.endswith("step_0000000042")
    _equal(ckpt.restore(str(tmp_path), 42, want), want)


def test_multi_host_barrier_last_host_commits(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 7, tree, host_id=0, n_hosts=2)
    assert ckpt.latest_step(str(tmp_path)) is None
    assert os.path.exists(tmp_path / "step_0000000007.tmp"
                          / "manifest.00000.json")
    ckpt.save(str(tmp_path), 7, tree, host_id=1, n_hosts=2)
    assert ckpt.latest_step(str(tmp_path)) == 7
    step_dir = tmp_path / "step_0000000007"
    for h in (0, 1):
        assert os.path.exists(step_dir / f"manifest.{h:05d}.json")
        _equal(ckpt.restore(str(tmp_path), 7, tree, host_id=h), tree)
    with open(step_dir / "manifest.json") as f:
        merged = json.load(f)
    assert {n[:11] for n in merged["checksums"]} == {"shard_00000",
                                                     "shard_00001"}


def test_multi_host_concurrent_saves_commit_exactly_once(tmp_path):
    tree = make_tree()
    errs = []

    def worker(h):
        try:
            ckpt.save(str(tmp_path), 3, tree, host_id=h, n_hosts=2,
                      barrier_timeout=30.0)
        except BaseException as e:  # pragma: no cover - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(h,)) for h in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts) and not errs, errs
    assert ckpt.latest_step(str(tmp_path)) == 3
    for h in (0, 1):
        _equal(ckpt.restore(str(tmp_path), 3, tree, host_id=h), tree)


def test_resave_of_committed_step_keeps_other_hosts_shards(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 5, tree, host_id=0, n_hosts=2)
    ckpt.save(str(tmp_path), 5, tree, host_id=1, n_hosts=2)
    ckpt.save(str(tmp_path), 5, tree, host_id=0, n_hosts=2)
    step_dir = tmp_path / "step_0000000005"
    shards = sorted(n for n in os.listdir(step_dir) if n.startswith("shard_"))
    assert [s[:11] for s in shards] == ["shard_00000", "shard_00001"]
    for host in (0, 1):
        _equal(ckpt.restore(str(tmp_path), 5, tree, host_id=host), tree)


def test_committed_shard_wins_over_stale_tmp_debris(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 9, tree, host_id=0, n_hosts=2)
    ckpt.save(str(tmp_path), 9, tree, host_id=1, n_hosts=2)
    (shard_name,) = (n for n in os.listdir(tmp_path / "step_0000000009")
                     if n.startswith("shard_00001"))
    tmp_dir = tmp_path / "step_0000000009.tmp"
    os.makedirs(tmp_dir)
    with open(tmp_dir / shard_name, "wb") as f:
        f.write(b"garbage from a crashed re-save")
    ckpt.save(str(tmp_path), 9, tree, host_id=0, n_hosts=2)
    for host in (0, 1):
        _equal(ckpt.restore(str(tmp_path), 9, tree, host_id=host), tree)


def test_legacy_merged_manifest_still_restores(tmp_path):
    tree = make_tree()
    path = ckpt.save(str(tmp_path), 2, tree)
    for n in list(os.listdir(path)):
        if n.startswith("manifest.") and n != "manifest.json":
            os.remove(os.path.join(path, n))
    _equal(ckpt.restore(str(tmp_path), 2, tree), tree)


def _model_trees():
    untied = {"tok_embed": {"w": torch.ones(8, 4)},
              "final_norm": {"s": torch.ones(4)},
              "lm_head": {"w": torch.ones(4, 8)}}
    tied = {"tok_embed": {"w": torch.ones(8, 4)},
            "final_norm": {"s": torch.ones(4)}}
    return untied, tied


def test_restore_tied_model_from_untied_checkpoint_names_lm_head(tmp_path):
    untied, tied = _model_trees()
    ckpt.save(str(tmp_path), 1, untied)
    with pytest.raises(ValueError, match="lm_head.*untied"):
        ckpt.restore(str(tmp_path), 1, tied)


def test_restore_untied_model_from_tied_checkpoint_names_lm_head(tmp_path):
    untied, tied = _model_trees()
    ckpt.save(str(tmp_path), 1, tied)
    with pytest.raises(ValueError, match="lm_head.*tie_embeddings"):
        ckpt.restore(str(tmp_path), 1, untied)


def test_restore_latest_degrades_past_corrupt_shard(tmp_path):
    tree = make_tree()
    ckpt.save(str(tmp_path), 1, tree)
    _corrupt_shard(ckpt.save(str(tmp_path), 2, tree))
    with pytest.warns(UserWarning, match="falling back"):
        got, step = ckpt.restore_latest(str(tmp_path), tree)
    assert step == 1
    _equal(got, tree)


def test_restore_latest_none_when_all_corrupt(tmp_path):
    tree = make_tree()
    _corrupt_shard(ckpt.save(str(tmp_path), 1, tree))
    with pytest.warns(UserWarning, match="falling back"):
        assert ckpt.restore_latest(str(tmp_path), tree) is None


def test_leaf_checksum_mismatch_names_the_leaf(tmp_path):
    tree = make_tree()
    path = ckpt.save(str(tmp_path), 4, tree)
    man_path = os.path.join(path, "manifest.00000.json")
    with open(man_path) as f:
        man = json.load(f)
    assert man["leaf_checksums"]["a/b"] == zlib.crc32(
        tree["a"]["b"].numpy().tobytes())
    man["leaf_checksums"]["a/w"] += 1
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ckpt.CorruptCheckpointError, match="a/w"):
        ckpt.restore(str(tmp_path), 4, tree)
    with pytest.warns(UserWarning, match="falling back"):
        assert ckpt.restore_latest(str(tmp_path), tree) is None


def test_io_errors_absorbed_by_retry(tmp_path, monkeypatch):
    tree = make_tree()
    monkeypatch.setenv(faults.ENV_VAR, "io_error@save:2")
    with pytest.warns(UserWarning, match="retry"):
        ckpt.save(str(tmp_path), 1, tree, io_retries=3, io_backoff=0.01)
    monkeypatch.delenv(faults.ENV_VAR)
    _equal(ckpt.restore(str(tmp_path), 1, tree), tree)


def test_io_errors_beyond_retry_budget_raise(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "io_error@save:9")
    with pytest.warns(UserWarning, match="retry"):
        with pytest.raises(OSError, match="injected IO error"):
            ckpt.save(str(tmp_path), 1, make_tree(), io_retries=2,
                      io_backoff=0.01)
    assert ckpt.latest_step(str(tmp_path)) is None


def test_commit_io_error_absorbed_by_retry(tmp_path, monkeypatch):
    tree = make_tree()
    monkeypatch.setenv(faults.ENV_VAR, "io_error@commit:1")
    with pytest.warns(UserWarning, match="retry"):
        ckpt.save(str(tmp_path), 1, tree, io_retries=2, io_backoff=0.01)
    monkeypatch.delenv(faults.ENV_VAR)
    assert ckpt.latest_step(str(tmp_path)) == 1
    _assert_committed_steps_verifiable(str(tmp_path), tree)


def test_mid_commit_kill_never_yields_committed_step(tmp_path, monkeypatch):
    tree = make_tree()
    monkeypatch.setenv(faults.ENV_VAR, "kill@commit:1")
    with pytest.raises(SimulatedKill):
        ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) is None
    _assert_committed_steps_verifiable(str(tmp_path), tree)
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 5
    _assert_committed_steps_verifiable(str(tmp_path), tree)


def test_mid_save_kill_leaves_unvouched_shard_only(tmp_path, monkeypatch):
    tree = make_tree()
    monkeypatch.setenv(faults.ENV_VAR, "kill@save:1")
    with pytest.raises(SimulatedKill):
        ckpt.save(str(tmp_path), 3, tree)
    tmp_dir = str(tmp_path / "step_0000000003.tmp")
    assert any(n.startswith("shard_") for n in os.listdir(tmp_dir))
    assert not any(n.startswith("manifest.") for n in os.listdir(tmp_dir))
    assert ckpt.latest_step(str(tmp_path)) is None
    monkeypatch.delenv(faults.ENV_VAR)
    faults.reset()
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    _assert_committed_steps_verifiable(str(tmp_path), tree)


def test_async_save_raises_from_wait_and_done(tmp_path, monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "io_error@save:9")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        handle = ckpt.save_async(str(tmp_path), 1, make_tree(), io_retries=0,
                                 io_backoff=0.0)
        with pytest.raises(OSError, match="injected IO error"):
            handle.wait()
    with pytest.raises(OSError, match="injected IO error"):
        handle.done


def test_zstd_is_optional_and_named_when_missing(tmp_path, monkeypatch):
    """Without ``zstandard``, "auto" writes .mpk, and asking for zstd, or
    reading a .zst shard, raises an ImportError that says why."""
    monkeypatch.setattr(C, "_zstandard", lambda: None)
    tree = make_tree()
    path = ckpt.save(str(tmp_path), 1, tree)
    assert os.path.exists(os.path.join(path, "shard_00000.mpk"))
    with pytest.raises(ImportError, match="zstandard"):
        ckpt.save(str(tmp_path), 2, tree, compression="zstd")
    # a committed step whose manifest names a .zst shard
    os.replace(os.path.join(path, "shard_00000.mpk"),
               os.path.join(path, "shard_00000.mpk.zst"))
    for n in ("manifest.00000.json", "manifest.json"):
        with open(os.path.join(path, n)) as f:
            man = json.load(f)
        man["checksums"] = {"shard_00000.mpk.zst":
                            man["checksums"]["shard_00000.mpk"]}
        with open(os.path.join(path, n), "w") as f:
            json.dump(man, f)
    with pytest.raises(ImportError, match="zstandard"):
        ckpt.restore(str(tmp_path), 1, tree)
