"""Fault-tolerant checkpointing: the port of ``repro.checkpoint.checkpointer``.

The same API, layout and guarantees as the JAX package's, over trees of
torch tensors (a ``TrainState`` of :mod:`repro_torch.training`, or any
nesting of NamedTuples, dicts, :class:`~repro_torch.models.Params` and
tensors):

Layout:  <dir>/step_<N:010d>/shard_<host:05d>.mpk[.zst] + one
``manifest.<host:05d>.json`` per host + a merged ``manifest.json`` + a
``COMMITTED`` marker written last; a crash mid-save never yields a
readable-but-corrupt checkpoint, and ``restore_latest`` skips uncommitted
steps. Each host writes only its own shard and manifest; the step is
committed (renamed into place) by whichever host sees every host's
manifest first, and racing committers are tolerated.

A shard is the msgpack map ``{leaf key: {"dtype", "shape", "data"}}``
(:mod:`._msgpack`, a codec of this subset: the card's machine has no
``msgpack``). Leaf keys are JAX's ``core.labels.path_str`` keys of the
same tree (``.step``, ``.params/<path>``, ``.opt_state/.mu/<path>``,
``.guard/.loss_ema``, ...), dict keys sorted at every level as
``jax.tree_util`` flattens them, so a checkpoint of either package
restores into the other bitwise, with the same shard and leaf crc32s.
bf16 leaves are written as their raw 2-byte words under dtype
``"bfloat16"`` (never widened); ``PipeState.host_count`` and
``TrainState.host_step`` are no leaves (they mirror ``count`` and
``step``, and restore sets them from the restored counts).

Resilience, as in the JAX package: per-leaf crc32s in the per-host
manifest, verified on ``restore``; any corruption-class failure raises
:class:`CorruptCheckpointError`, across which ``restore_latest`` degrades
to the newest verifiable committed step; shard, manifest and commit IO
run under bounded retry with backoff; :class:`AsyncSave` re-raises a
failed background save from ``wait()`` and ``done``; the ``REPRO_FAULTS``
hooks (:mod:`repro_torch.training.faults`) inject IO errors and kills at
the points the atomicity argument rests on.

``zstandard`` is optional: ``"auto"`` writes zstd shards when it is
importable and ``.mpk`` otherwise; asking for zstd, or reading a ``.zst``
shard, without it raises a clear ImportError. Uncompressed shards are
streamed to the file from the leaves' own buffers.

``save_async`` copies every leaf to host memory before it returns, so the
training step may write the parameters and the momentum in place at once.
``restore`` builds new tensors on each ``like`` leaf's device, in its
dtype.

Sharded trees (DTensor leaves on a ``torch.distributed`` mesh, see
:mod:`repro_torch.models.sharding`): ``save`` and ``save_async`` are
collective — every rank gathers each leaf's full value (``full_tensor``)
— and rank 0 alone writes, so a sharded run's checkpoint holds the same
full tensors, bitwise, as an unsharded one; ``restore`` places each full
leaf as the ``like`` leaf is laid out, every rank reading the committed
files.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional, Tuple

import torch

from repro_torch.core.pipeline import HostCount
from repro_torch.models.model import Params, flatten
from repro_torch.models.sharding import is_dtensor

from . import _msgpack

PyTree = Any

# torch dtype <-> the numpy dtype name JAX writes (``str(np.dtype)``)
_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {v: k for k, v in _NAMES.items()}


class CorruptCheckpointError(IOError):
    """A committed checkpoint failed verification (checksum / truncation /
    malformed manifest). ``restore_latest`` degrades across these to the
    newest verifiable step; a direct ``restore`` propagates them."""


def _zstandard():
    try:
        import zstandard
    except ImportError:  # optional dep: only required for zstd compression
        return None
    return zstandard


def _fault_gate(kind: str, site: str) -> None:
    """Chaos hook: inject an IO error or a simulated kill at ``site``.

    A no-op unless ``REPRO_FAULTS`` is set (see
    :mod:`repro_torch.training.faults` for the spec grammar).
    """
    if not os.environ.get("REPRO_FAULTS"):
        return
    from repro_torch.training import faults
    (faults.io_gate if kind == "io" else faults.kill_gate)(site)


def _retry_io(fn, what: str, retries: int, backoff: float):
    """Run ``fn`` with bounded retry-with-backoff on OSError.

    Only OSError (the transient-filesystem class) is retried: a simulated
    kill is a BaseException and anything else is a bug.
    """
    for attempt in range(max(retries, 0) + 1):
        try:
            return fn()
        except OSError as e:
            if attempt >= retries:
                raise
            warnings.warn(
                f"checkpoint {what} failed ({e}); retry "
                f"{attempt + 1}/{retries} in {backoff * (2 ** attempt):.2f}s")
            time.sleep(backoff * (2 ** attempt))


def _require_zstd(why: str):
    zstd = _zstandard()
    if zstd is None:
        raise ImportError(
            f"zstd compression requested ({why}) but the optional "
            "'zstandard' package is not installed; pip install zstandard "
            "or save with compression='none'")
    return zstd


# ------------------------------------------------------------ tree <-> keys

def _join(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


def _sorted_items(mapping):
    # jax.tree_util flattens a dict in sorted key order at every level; a
    # flat {"a/b": x} dict (the optimizer state's) sorts as the nesting
    return sorted(mapping.items(), key=lambda kv: tuple(str(kv[0]).split("/")))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def named_leaves(tree, prefix: str = ""):
    """(key, tensor) of every leaf, in JAX's flatten order and with its
    ``path_str`` keys (``.step``, ``.params/<path>``, ...)."""
    if tree is None or isinstance(tree, HostCount):
        return
    if torch.is_tensor(tree):
        yield prefix, tree
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from named_leaves(getattr(tree, f), _join(prefix, "." + f))
    elif hasattr(tree, "items"):
        for k, v in _sorted_items(tree):
            yield from named_leaves(v, _join(prefix, str(k)))
    else:
        raise TypeError(f"checkpoint: leaf {prefix!r} is a "
                        f"{type(tree).__name__}, not a tensor")


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree`` with each tensor leaf replaced by ``leaf_fn(key, leaf)``; a
    ``HostCount`` is set from its NamedTuple's rebuilt ``count`` (a
    ``PipeState``) or ``step`` (a ``TrainState``)."""
    if tree is None or isinstance(tree, HostCount):
        return tree
    if torch.is_tensor(tree):
        return leaf_fn(prefix, tree)
    if isinstance(tree, Params):
        return Params({k: leaf_fn(_join(prefix, k), v)
                       for k, v in flatten(tree).items()})
    if _is_namedtuple(tree):
        out = {f: _rebuild(getattr(tree, f), leaf_fn, _join(prefix, "." + f))
               for f in tree._fields}
        for f, v in out.items():
            if isinstance(v, HostCount):
                out[f] = HostCount(int(out["count" if "count" in out
                                           else "step"]))
        return type(tree)(**out)
    if hasattr(tree, "items"):
        return {k: _rebuild(v, leaf_fn, _join(prefix, str(k)))
                for k, v in tree.items()}
    raise TypeError(f"checkpoint: leaf {prefix!r} is a "
                    f"{type(tree).__name__}, not a tensor")


def _flatten(tree: PyTree, copy: bool = False) -> Tuple[dict, bool]:
    """({leaf key: contiguous CPU tensor}, writes): ``copy`` forces a
    private copy of CPU leaves too (a CUDA leaf is always copied to the
    host); a DTensor leaf is gathered to its full value on every rank,
    and ``writes`` is False on the ranks other than 0 of a sharded
    tree."""
    out, sharded = {}, False
    for k, x in named_leaves(tree):
        if x.dtype not in _NAMES:
            raise TypeError(f"checkpoint: leaf {k!r} has dtype {x.dtype}")
        x = x.detach()
        if is_dtensor(x):
            x, sharded = x.full_tensor(), True
        out[k] = (x.to("cpu", copy=True) if copy else x.cpu()).contiguous()
    return out, not sharded or torch.distributed.get_rank() == 0


def _raw(t: torch.Tensor):
    """The tensor's bytes as a flat uint8 numpy view (no copy); bf16 is
    its raw 2-byte words."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _crc32_chunks(chunks) -> int:
    crc = 0
    for c in chunks:
        crc = zlib.crc32(c, crc)
    return crc


def _unpack_leaf(d: dict) -> torch.Tensor:
    dtype = _DTYPES[d["dtype"]]
    shape = [int(s) for s in d["shape"]]
    if not memoryview(d["data"]).nbytes:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(d["data"], dtype=dtype).reshape(shape)


# ------------------------------------------------------------- manifests

def _manifest_name(host_id: int) -> str:
    return f"manifest.{host_id:05d}.json"


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None  # missing or partial write from a crashed save


def _write_json_atomic(path: str, obj) -> None:
    # a part name unique across hosts: racing committers write the merged
    # manifest into one shared tmp dir
    part = f"{path}.part.{uuid.uuid4().hex}"
    with open(part, "w") as f:
        json.dump(obj, f)
    os.replace(part, path)


def _adopt_committed(step_dir: str, tmp_dir: str, host_id: int,
                     n_hosts: int) -> None:
    """Copy already-committed hosts' shards + manifests into the tmp dir.

    Re-saving a committed step must not destroy the other hosts' shards
    when the tmp dir is renamed over the step dir. A host's tmp manifest
    (fresher, in flight) wins over its committed one; a tmp shard no tmp
    manifest vouches for is debris and is overwritten by the committed
    copy. Legacy committed dirs (merged manifest only) get per-host
    manifests made from the merged checksums.
    """
    for h in range(n_hosts):
        if h == host_id:
            continue  # our fresh shard supersedes any committed one
        if os.path.exists(os.path.join(tmp_dir, _manifest_name(h))):
            continue  # host h is mid-save into this tmp dir: fresher
        man = _read_json(os.path.join(step_dir, _manifest_name(h)))
        if man is None:
            merged = _read_json(os.path.join(step_dir, "manifest.json"))
            if merged is None:
                continue
            checksums = {n: c for n, c in merged.get("checksums", {}).items()
                         if n.startswith(f"shard_{h:05d}")}
            if not checksums:
                continue
            man = {"step": merged.get("step"), "host": h, "n_hosts": n_hosts,
                   "compression": merged.get("compression", "none"),
                   "checksums": checksums}
        ok = True
        for name in man.get("checksums", {}):
            src = os.path.join(step_dir, name)
            if not os.path.exists(src):
                ok = False  # manifest lists a shard that never landed
                continue
            shutil.copy2(src, os.path.join(tmp_dir, name))
        if ok:
            _write_json_atomic(os.path.join(tmp_dir, _manifest_name(h)), man)


def _commit(directory: str, step: int, tmp_dir: str, step_dir: str,
            keep: int) -> None:
    """Merge per-host manifests, mark COMMITTED, rename into place.

    A racing committer that finds the tmp dir gone verifies the winner's
    COMMITTED marker instead of failing; the rename is tried before any
    removal of an existing step dir, so a loser never deletes the
    winner's commit.
    """
    def _won_by_other() -> bool:
        return (not os.path.exists(tmp_dir)
                and os.path.exists(os.path.join(step_dir, "COMMITTED")))

    try:
        _fault_gate("io", "commit")
        checksums, leaves, leaf_sums, compression, n_hosts = \
            {}, {}, {}, "none", 1
        for name in sorted(os.listdir(tmp_dir)):
            if not (name.startswith("manifest.") and name.endswith(".json")
                    and name != "manifest.json"):
                continue
            man = _read_json(os.path.join(tmp_dir, name))
            if man is None:
                continue
            checksums.update(man.get("checksums", {}))
            leaves.update(man.get("leaves", {}))
            leaf_sums.update(man.get("leaf_checksums", {}))
            compression = man.get("compression", compression)
            n_hosts = max(n_hosts, man.get("n_hosts", 1))
        _write_json_atomic(os.path.join(tmp_dir, "manifest.json"),
                           {"step": step, "n_hosts": n_hosts,
                            "compression": compression,
                            "checksums": checksums, "leaves": leaves,
                            "leaf_checksums": leaf_sums})
        # a kill here (every shard and manifest on disk, COMMITTED not yet
        # written) leaves an uncommitted .tmp dir that restore_latest skips
        _fault_gate("kill", "commit")
        with open(os.path.join(tmp_dir, "COMMITTED"), "w") as f:
            f.write("ok")
    except OSError:
        if _won_by_other():
            _retain_latest(directory, keep)
            return
        raise
    for _ in range(100):
        try:
            os.replace(tmp_dir, step_dir)
            break
        except FileNotFoundError:
            if _won_by_other():
                break  # a racing committer renamed our shared tmp dir
            raise
        except OSError:
            # step_dir exists (re-save of a committed step): remove it and
            # retry, unless a racer has taken the tmp dir meanwhile
            if _won_by_other():
                break
            if not os.path.exists(tmp_dir):
                raise
            shutil.rmtree(step_dir, ignore_errors=True)
    else:
        raise IOError(f"could not commit {step_dir}: rename kept failing")
    _retain_latest(directory, keep)


# ------------------------------------------------------------------ save

def save(directory: str, step: int, tree: PyTree, host_id: int = 0,
         n_hosts: int = 1, keep: int = 3, compression: str = "auto",
         barrier_timeout: float = 0.0, io_retries: int = 3,
         io_backoff: float = 0.05) -> str:
    """Atomically save ``tree`` for ``step``. Returns the checkpoint path.

    ``compression``: "auto" (zstd when available, else uncompressed),
    "zstd" (required; clear error when the module is missing), or "none".

    Multi-host (``n_hosts > 1``, shared filesystem): this host writes its
    shard and its own ``manifest.<host>.json``, then waits at the commit
    barrier for up to ``barrier_timeout`` seconds; whichever host sees
    every manifest present commits for all (with the default 0 an early
    host returns at once, uncommitted, and the last host commits).

    Shard and manifest writes and the commit run under bounded retry
    (``io_retries`` attempts beyond the first, ``io_backoff`` seconds
    doubling per attempt).
    """
    flat, writes = _flatten(tree)
    if not writes:
        return os.path.join(directory, f"step_{step:010d}")
    return _save_flat(directory, step, flat, host_id, n_hosts,
                      keep, compression, barrier_timeout, io_retries,
                      io_backoff)


def _save_flat(directory, step, flat, host_id, n_hosts, keep, compression,
               barrier_timeout, io_retries, io_backoff) -> str:
    if compression not in ("auto", "zstd", "none"):
        raise ValueError(f"compression must be auto|zstd|none, got {compression!r}")
    use_zstd = (compression == "zstd"
                or (compression == "auto" and _zstandard() is not None))
    step_dir = os.path.join(directory, f"step_{step:010d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    # remove only this host's stale files from a crashed earlier save;
    # other hosts may be writing theirs into the same tmp dir
    for name in os.listdir(tmp_dir):
        if (name.startswith(f"shard_{host_id:05d}")
                or name == _manifest_name(host_id)):
            os.remove(os.path.join(tmp_dir, name))

    raw = {k: _raw(v) for k, v in flat.items()}
    chunks = list(_msgpack.shard_chunks(
        (k, _NAMES[v.dtype], tuple(v.shape), raw[k]) for k, v in flat.items()))
    if use_zstd:
        zstd = _require_zstd("compression='zstd'")
        chunks = [zstd.ZstdCompressor(level=3).compress(b"".join(chunks))]
        shard = os.path.join(tmp_dir, f"shard_{host_id:05d}.mpk.zst")
    else:
        shard = os.path.join(tmp_dir, f"shard_{host_id:05d}.mpk")

    def write_shard():
        _fault_gate("io", "save")
        with open(shard + ".part", "wb") as f:
            for c in chunks:
                f.write(c)
        os.replace(shard + ".part", shard)

    # the shard's and the leaves' crc32s (zlib releases the GIL) run on
    # two threads while this one writes the shard
    with ThreadPoolExecutor(max_workers=2) as pool:
        shard_crc = pool.submit(_crc32_chunks, chunks)
        leaf_sums = pool.submit(
            lambda: {k: zlib.crc32(r) for k, r in raw.items()})
        _retry_io(write_shard, f"shard write ({os.path.basename(shard)})",
                  io_retries, io_backoff)
        # a kill here (shard on disk, manifest not) leaves an unvouched
        # shard that the next save overwrites, never a committed step
        _fault_gate("kill", "save")
        manifest = {
            "step": step, "host": host_id, "n_hosts": n_hosts,
            "compression": "zstd" if use_zstd else "none",
            "checksums": {os.path.basename(shard): shard_crc.result()},
            "leaf_checksums": leaf_sums.result(),
            "leaves": {k: {"dtype": _NAMES[v.dtype],
                           "shape": list(v.shape)}
                       for k, v in flat.items()}}
    _retry_io(
        lambda: _write_json_atomic(
            os.path.join(tmp_dir, _manifest_name(host_id)), manifest),
        "manifest write", io_retries, io_backoff)
    if os.path.exists(step_dir):
        _adopt_committed(step_dir, tmp_dir, host_id, n_hosts)

    deadline = time.monotonic() + max(barrier_timeout, 0.0)
    while True:
        present = all(
            os.path.exists(os.path.join(tmp_dir, _manifest_name(h)))
            for h in range(n_hosts))
        if present:
            _retry_io(
                lambda: _commit(directory, step, tmp_dir, step_dir, keep),
                "commit", io_retries, io_backoff)
            break
        if os.path.exists(os.path.join(step_dir, "COMMITTED")):
            break  # another host committed while we polled
        if time.monotonic() >= deadline:
            break  # a later host completes the barrier and commits
        time.sleep(0.05)
    return step_dir


def _retain_latest(directory: str, keep: int) -> None:
    steps = sorted(_list_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)


def _list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "COMMITTED")):
                out.append(int(name[5:]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _list_steps(directory)
    return max(steps) if steps else None


# --------------------------------------------------------------- restore

def _read_verified(step_dir: str, host_id: int) -> dict:
    """Read + verify this host's shard -> {leaf key: CPU tensor}.

    Every corruption-class failure (missing or malformed manifest,
    missing shard, shard or per-leaf checksum mismatch, truncated
    payload) raises :class:`CorruptCheckpointError`. A missing zstandard
    module stays an ImportError: that is the environment, not the
    checkpoint.
    """
    manifest = _read_json(os.path.join(step_dir, _manifest_name(host_id)))
    if manifest is None:
        manifest = _read_json(os.path.join(step_dir, "manifest.json"))
    if manifest is None or "checksums" not in manifest:
        raise CorruptCheckpointError(
            f"no readable manifest for host {host_id} in {step_dir}")
    prefix = f"shard_{host_id:05d}"
    names = [n for n in manifest["checksums"] if n.startswith(prefix)]
    if not names:
        raise CorruptCheckpointError(
            f"no shard for host {host_id} in {step_dir} manifests")
    shard = os.path.join(step_dir, names[0])
    try:
        with open(shard, "rb") as f:
            comp = bytearray(os.fstat(f.fileno()).st_size)
            del comp[f.readinto(comp):]
    except OSError as e:
        raise CorruptCheckpointError(
            f"shard {shard} unreadable: {e}") from e
    have = manifest["checksums"][names[0]]
    leaf_sums = manifest.get("leaf_checksums", {})
    # the shard's crc32 on a second thread while this one decodes and
    # takes the leaves' (zlib releases the GIL); the shard's verdict is
    # read first, as if it had been taken before the decode
    with ThreadPoolExecutor(max_workers=1) as pool:
        shard_crc = pool.submit(zlib.crc32, comp)
        flat, error = None, None
        try:
            if shard.endswith(".zst"):
                payload = bytearray(_require_zstd(f"reading {shard}")
                                    .ZstdDecompressor().decompress(comp))
            else:
                payload = comp
            raw = _msgpack.unpackb(payload)
            flat = {k: _unpack_leaf(v) for k, v in raw.items()}
        except ImportError:
            raise  # missing optional dep, not corruption
        except Exception as e:  # truncated or garbled payloads fail many ways
            error = e
        got_sums = {k: zlib.crc32(_raw(flat[k])) for k in leaf_sums
                    if flat is not None and k in flat}
        want = shard_crc.result()
    if have != want:
        raise CorruptCheckpointError(
            f"checksum mismatch in {shard}: {have} != {want}")
    if error is not None:
        raise CorruptCheckpointError(
            f"shard {shard} failed to decode: {error}") from error
    for key, crc in leaf_sums.items():
        if key not in flat:
            raise CorruptCheckpointError(
                f"shard {shard} is missing leaf {key!r} named by its "
                "manifest")
        got = got_sums[key]
        if got != crc:
            raise CorruptCheckpointError(
                f"leaf checksum mismatch for {key!r} in {shard}: "
                f"{crc} != {got}")
    return flat


def restore(directory: str, step: int, like: PyTree, host_id: int = 0) -> PyTree:
    """Restore ``step`` into the structure, devices and dtypes of ``like``.

    A tied/untied mismatch is a named ValueError: restoring a
    ``tie_embeddings=True`` model (no ``lm_head`` leaves) from an untied
    checkpoint, or the reverse, says which ``lm_head`` entries are extra
    or missing and why. Corruption raises :class:`CorruptCheckpointError`.
    """
    step_dir = os.path.join(directory, f"step_{step:010d}")
    flat = _read_verified(step_dir, host_id)

    want_keys = [k for k, _ in named_leaves(like)]
    missing = [k for k in want_keys if k not in flat]
    if missing:
        head_missing = [k for k in missing if "lm_head" in k]
        if head_missing:
            raise ValueError(
                f"checkpoint {step_dir} has no {head_missing} leaves: it "
                "was saved from a tie_embeddings=True model (the head is "
                "the tied tok_embed). Restore into a tied model "
                "(tie_embeddings=True), or re-export with an explicit "
                "lm_head.")
        raise ValueError(
            f"checkpoint {step_dir} is missing leaves {missing} required "
            "by the target tree")
    extra_head = [k for k in flat if "lm_head" in k and k not in want_keys]
    if extra_head and not any("lm_head" in k for k in want_keys):
        raise ValueError(
            f"checkpoint {step_dir} contains {extra_head} but the target "
            "tree has no lm_head: the checkpoint was saved from an untied "
            "model and cannot restore into a tie_embeddings=True model "
            "(the tied head would silently ignore the trained lm_head). "
            "Restore into an untied model, or fold lm_head into tok_embed "
            "explicitly.")
    for k, leaf in named_leaves(like):
        if tuple(flat[k].shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {k}: ckpt {tuple(flat[k].shape)} vs "
                f"model {tuple(leaf.shape)}")

    def leaf_fn(key, leaf):
        full = torch.empty(leaf.shape, dtype=leaf.dtype,
                           device=leaf.device).copy_(flat[key])
        if is_dtensor(leaf):
            from repro_torch.models.sharding import place, spec_of
            return place(full, spec_of(leaf), copy=True)
        return full

    return _rebuild(like, leaf_fn)


def restore_latest(directory: str, like: PyTree,
                   host_id: int = 0) -> Optional[Tuple[PyTree, int]]:
    """Auto-resume: (tree, step) of the newest **verifiable** committed
    checkpoint, or None.

    A committed but unusable candidate (corrupt shard, failed checksum,
    missing shard, unreadable manifest) is skipped with a warning and the
    next-newest committed step is tried. Structural mismatches against
    ``like`` (tied/untied, missing leaves, shapes) still raise: they would
    fail at every step alike.
    """
    for step in sorted(_list_steps(directory), reverse=True):
        try:
            return restore(directory, step, like, host_id), step
        except (CorruptCheckpointError, OSError) as e:
            warnings.warn(
                f"checkpoint step {step} in {directory} failed "
                f"verification ({e}); falling back to the previous "
                "committed step")
    return None


class AsyncSave:
    """Handle for an in-flight asynchronous checkpoint.

    Worker-thread exceptions are captured and **re-raised** from both
    ``wait()`` and the ``done`` property: a failed background save
    surfaces at the next touch of the handle, never passes for a slow one.
    """

    def __init__(self, thread: threading.Thread):
        self._thread = thread
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> str:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("checkpoint save still in flight")
        if self.error is not None:
            raise self.error
        return self.path

    @property
    def done(self) -> bool:
        """True once the save finished **successfully**; raises the
        worker's exception if it failed (False while still in flight)."""
        if self._thread.is_alive():
            return False
        if self.error is not None:
            raise self.error
        return True


def save_async(directory: str, step: int, tree: PyTree, host_id: int = 0,
               n_hosts: int = 1, keep: int = 3, compression: str = "auto",
               barrier_timeout: float = 0.0, io_retries: int = 3,
               io_backoff: float = 0.05) -> AsyncSave:
    """Checkpoint without blocking the training loop.

    Every leaf is copied to host memory before this returns (the training
    step writes the parameters and the momentum in place, so a worker
    reading live tensors could commit a torn state); serialization, the
    checksums and the atomic commit then run on a background thread.
    """
    # device->host copy (and a sharded tree's gather) happens here
    snapshot, writes = _flatten(tree, copy=True)
    del tree

    handle: AsyncSave

    def work():
        if not writes:
            handle.path = os.path.join(directory, f"step_{step:010d}")
            return
        try:
            handle.path = _save_flat(directory, step, snapshot, host_id,
                                     n_hosts, keep, compression,
                                     barrier_timeout, io_retries, io_backoff)
        except BaseException as e:  # surfaced on wait() and done
            handle.error = e

    t = threading.Thread(target=work, daemon=True)
    handle = AsyncSave(t)
    t.start()
    return handle
