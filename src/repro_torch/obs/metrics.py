"""Structured metrics sinks + a non-blocking host-side MetricsLogger (the
port of ``repro.obs.metrics``; the record grammar is the same).

The training loop must never block on metrics IO: records are enqueued and
a daemon worker thread writes them to every attached sink, flushing on a
record cadence and on explicit :meth:`MetricsLogger.flush` (the launcher
calls it on SIGTERM and on rollback, so the tail of a dying run is on
disk). Sinks:

  * :class:`JSONLSink` — the canonical format. One JSON object per line,
    every record schema-versioned (``schema = "repro_metrics/v1"``) and
    carrying ``kind`` / ``host`` / ``step`` / ``t``; non-finite floats are
    serialized as ``null`` so every line is strict JSON.
  * :class:`CSVSink`  — convenience tabular view. The header is fixed by
    the first record written; later records fill known columns (missing
    -> empty, unknown -> dropped). Use JSONL for anything programmatic.
  * :class:`MemorySink` — in-process list of records, for tests.

Record grammar (v1)
-------------------
Required keys on every record: ``schema`` (str, ``repro_metrics/v1``),
``kind`` (str: ``train_step`` | ``serve`` | ``event`` | ``run_header`` |
``run_end`` | free-form), ``host`` (int process index), ``step`` (int),
``t`` (float unix seconds). All other keys are metric fields: numbers
(finite or ``null``), strings, booleans, or flat lists/dicts thereof.
:func:`validate_record` / :func:`validate_jsonl` enforce exactly this and
are what the tests run against the output of a real training run.

:func:`jsonable` converts torch tensors itself (0-d to a Python number,
others to nested lists, bf16 read as f32), so that a device tensor is
never written as its ``repr`` string; a CUDA tensor is read back here, on
the caller's thread, so a record reads the device only when it is logged.
"""
from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

SCHEMA = "repro_metrics/v1"

_REQUIRED = ("schema", "kind", "host", "step", "t")


def jsonable(v):
    """Coerce a metric value to a JSON-serializable form.

    torch and numpy scalars become Python numbers; non-finite floats
    become None (strict-JSON lines; the guard's ``bad_step`` flag carries
    the NaN signal explicitly). Tensors and arrays become (nested) lists.
    """
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype in (torch.bfloat16, torch.float16):
            v = v.float()
        return jsonable(v.item() if v.ndim == 0 else v.tolist())
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return f if math.isfinite(f) else None
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    try:
        arr = np.asarray(v)
    except Exception:
        return str(v)
    if arr.ndim == 0:
        return jsonable(arr.item())
    return jsonable(arr.tolist())


def validate_record(rec: dict) -> None:
    """Raise ValueError unless ``rec`` is a well-formed v1 record."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be a dict, got {type(rec).__name__}")
    missing = [k for k in _REQUIRED if k not in rec]
    if missing:
        raise ValueError(f"record missing required keys {missing}: {rec}")
    if rec["schema"] != SCHEMA:
        raise ValueError(f"unknown schema {rec['schema']!r} (want {SCHEMA!r})")
    if not isinstance(rec["kind"], str) or not rec["kind"]:
        raise ValueError(f"kind must be a non-empty str: {rec['kind']!r}")
    for key in ("host", "step"):
        if not isinstance(rec[key], int) or isinstance(rec[key], bool):
            raise ValueError(f"{key} must be an int: {rec[key]!r}")
    if not isinstance(rec["t"], (int, float)) or isinstance(rec["t"], bool):
        raise ValueError(f"t must be a number: {rec['t']!r}")

    def ok_value(v, depth=0):
        if v is None or isinstance(v, (str, bool)):
            return True
        if isinstance(v, (int, float)):
            return not (isinstance(v, float) and not math.isfinite(v))
        if depth >= 2:
            return False
        if isinstance(v, dict):
            return all(isinstance(k, str) and ok_value(x, depth + 1)
                       for k, x in v.items())
        if isinstance(v, list):
            return all(ok_value(x, depth + 1) for x in v)
        return False

    for k, v in rec.items():
        if k in _REQUIRED:
            continue
        if not ok_value(v):
            raise ValueError(f"field {k!r} is not a valid metric value: {v!r}")


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL metrics file; return the record count."""
    n = 0
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from e
            validate_record(rec)
            n += 1
    return n


# --------------------------------------------------------------------------
# Sinks. Only the logger's worker thread touches a sink after attach, so
# sinks need no locking of their own.
# --------------------------------------------------------------------------

class MemorySink:
    """Keep records in a list (tests)."""

    def __init__(self):
        self.records: list = []
        self.flushes = 0

    def write(self, rec: dict) -> None:
        self.records.append(rec)

    def flush(self) -> None:
        self.flushes += 1

    def close(self) -> None:
        pass


class JSONLSink:
    """Canonical schema-versioned JSON-lines sink (append mode)."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1 << 16)

    def write(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class CSVSink:
    """Tabular convenience sink; header fixed by the first record."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", buffering=1 << 16)
        self._cols: Optional[list] = None

    @staticmethod
    def _cell(v) -> str:
        if v is None:
            return ""
        s = str(v)
        if any(c in s for c in ",\"\n"):
            s = '"' + s.replace('"', '""') + '"'
        return s

    def write(self, rec: dict) -> None:
        if self._cols is None:
            self._cols = list(_REQUIRED) + sorted(
                k for k in rec if k not in _REQUIRED)
            self._f.write(",".join(self._cols) + "\n")
        self._f.write(",".join(self._cell(rec.get(c)) for c in self._cols)
                      + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


class _Flush:
    def __init__(self):
        self.done = threading.Event()


class MetricsLogger:
    """Buffered, thread-backed metrics fan-out.

    ``log(kind, step, **fields)`` stamps the record (schema, host, wall
    time) and enqueues it — the caller never blocks on sink IO. The worker
    writes to every sink and flushes them every ``flush_every`` records;
    :meth:`flush` is synchronous (enqueues a barrier and waits), which is
    what the launcher calls on SIGTERM and rollback so those tails hit disk.

    ``console(text, step=...)`` is the multi-host-safe console line: only
    host 0 prints, always flushed, and the line carries the host and step.
    """

    def __init__(self, sinks: Sequence, host: int = 0, flush_every: int = 20,
                 console_stream=None):
        self.sinks = list(sinks)
        self.host = int(host)
        self.flush_every = max(1, int(flush_every))
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._since_flush = 0
        self._stream = console_stream
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-logger")
        self._worker.start()

    # ----------------------------------------------------------- producer

    def log(self, kind: str, step: int, fields: Optional[dict] = None,
            **kw) -> dict:
        """Stamp + enqueue one record. Metric fields come either as a
        ``fields`` dict (keys may contain ``/``) or as keyword args."""
        rec = {"schema": SCHEMA, "kind": str(kind), "host": self.host,
               "step": int(step), "t": time.time()}
        for src in (fields or {}), kw:
            for k, v in src.items():
                if k in _REQUIRED:
                    raise ValueError(f"field {k!r} would shadow a required "
                                     "record key")
                rec[k] = jsonable(v)
        if not self._closed:
            self._q.put(rec)
        return rec

    def console(self, text: str, step: int = 0, raw: bool = False) -> None:
        """Host-0-only console line, flushed. ``raw=True`` keeps ``text``
        verbatim as the line start (the historical ``step N loss ...``
        format the greppable launcher lines use) and appends the host tag;
        otherwise the line is prefixed ``[h<host> s<step>]``."""
        if self.host != 0:
            return
        line = f"{text} host {self.host}" if raw \
            else f"[h{self.host} s{int(step)}] {text}"
        print(line, flush=True, file=self._stream)

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until everything enqueued so far is written + flushed."""
        if self._closed:
            return True
        req = _Flush()
        self._q.put(req)
        return req.done.wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        if self._closed:
            return
        self.flush(timeout)
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout)
        for s in self.sinks:
            s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _flush_sinks(self) -> None:
        for s in self.sinks:
            try:
                s.flush()
            except Exception:
                pass
        self._since_flush = 0

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                self._flush_sinks()
                return
            if isinstance(item, _Flush):
                self._flush_sinks()
                item.done.set()
                continue
            for s in self.sinks:
                try:
                    s.write(item)
                except Exception:
                    pass
            self._since_flush += 1
            if self._since_flush >= self.flush_every:
                self._flush_sinks()
