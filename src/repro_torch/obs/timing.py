"""Host-side step-time breakdown and device-memory accounting (the port of
``repro.obs.timing``).

:class:`StepTimer` accumulates named wall-clock sections (``data`` wait,
blocked ``step`` time, ``ckpt`` IO, ...) between metric emissions;
``snapshot()`` returns seconds-per-section (+ call counts) and resets, so
every emitted record carries the breakdown *since the last record*.

:func:`device_memory` reads the CUDA caching allocator's live and peak
bytes of the run's card, plus totals; a CPU run reports nothing, as the
JAX version does on the host CPU. Failures are swallowed: memory
accounting must never take down a training run.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class StepTimer:
    """Accumulating wall-clock section timer (not thread-safe: the train
    loop is single-threaded on the host)."""

    def __init__(self):
        self._acc: dict = {}
        self._n: dict = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._n[name] = self._n.get(name, 0) + 1

    def add(self, name: str, seconds: float) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + float(seconds)
        self._n[name] = self._n.get(name, 0) + 1

    def snapshot(self) -> dict:
        """{'time/<name>_s': secs, 'time/<name>_n': calls, 'time/wall_s':
        wall-clock since the previous snapshot}; resets the accumulators."""
        now = time.perf_counter()
        out = {"time/wall_s": now - self._t0}
        for name, secs in self._acc.items():
            out[f"time/{name}_s"] = secs
            out[f"time/{name}_n"] = self._n[name]
        self._acc, self._n, self._t0 = {}, {}, now
        return out


def device_memory(device="cuda") -> dict:
    """Live and peak bytes of the run's card, from the caching allocator.

    Keys: ``mem/dev<i>/bytes_in_use`` (``torch.cuda.memory_allocated``),
    ``mem/dev<i>/peak_bytes`` (``torch.cuda.max_memory_allocated``) plus
    ``mem/total_bytes_in_use`` / ``mem/total_peak_bytes``. Empty dict on a
    CPU run. Reads no tensor, so it waits for no kernel.
    """
    out: dict = {}
    try:
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_available():
            return out
        i = torch.cuda.current_device() if dev.index is None else dev.index
        live = int(torch.cuda.memory_allocated(i))
        peak = int(torch.cuda.max_memory_allocated(i))
    except Exception:
        return out
    out[f"mem/dev{i}/bytes_in_use"] = live
    out[f"mem/dev{i}/peak_bytes"] = peak
    out["mem/total_bytes_in_use"] = live
    out["mem/total_peak_bytes"] = peak
    return out
