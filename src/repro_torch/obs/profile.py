"""Profiler trace hooks: a step-window controller for ``torch.profiler`` plus
named spans the trace groups work under (the port of
``repro.obs.profile``).

``--profile-steps A:B`` on the training CLI parses into a
:class:`ProfileWindow`; the loop calls ``maybe_start(step)`` before and
``maybe_stop(step)`` after each step, so exactly steps ``A..B`` (inclusive,
0-indexed like the JAX launcher's) land in the trace, a Chrome trace file
``trace_steps_<A>_<B>.json`` under the profile directory. Spans are
:func:`trace_span` (``torch.profiler.record_function``), the names of the
JAX package's ``jax.named_scope``s and ``TraceAnnotation``s: in the
trainer ``fwd``, ``optimizer_update``, ``guard`` and ``obs_stats``; in the
launcher ``data_wait``, ``train_step`` and ``checkpoint``. The MoE layer
(``models.layers.apply_moe``) names its parts ``moe_router``,
``moe_dispatch``, ``moe_experts`` and ``moe_combine`` with
``record_function`` itself (the models package loads before this one). A
span costs a few microseconds of host time when no window is open.
"""
from __future__ import annotations

import os
import warnings
from typing import Optional

import torch


def trace_span(name: str):
    """Context manager naming a span in the profiler timeline."""
    return torch.profiler.record_function(name)


class ProfileWindow:
    """Drive a ``torch.profiler.profile`` session over a step range.

    ``device``: the run's device; a CUDA run traces the card's kernels too
    (CUPTI), a CPU run the host only. None traces the card when one is
    present.
    """

    def __init__(self, start: int, stop: int, logdir: str, device=None):
        if stop < start or start < 0:
            raise ValueError(f"profile window must be 0 <= start <= stop, "
                             f"got {start}:{stop}")
        self.start = int(start)
        self.stop = int(stop)
        self.logdir = logdir
        self.cuda = (torch.cuda.is_available() if device is None
                     else torch.device(device).type == "cuda")
        self.path = os.path.join(logdir,
                                 f"trace_steps_{self.start}_{self.stop}.json")
        self.active = False
        self.done = False
        self._prof = None

    @classmethod
    def parse(cls, spec: str, logdir: str,
              device=None) -> Optional["ProfileWindow"]:
        """``"A:B"`` (inclusive) or ``"A"`` (single step) -> window;
        ``""`` -> None."""
        if not spec:
            return None
        parts = spec.split(":")
        if len(parts) not in (1, 2):
            raise ValueError(
                f"--profile-steps wants 'A:B' or 'A', got {spec!r}")
        try:
            a = int(parts[0])
            b = int(parts[1]) if len(parts) == 2 else a
        except ValueError as e:
            raise ValueError(
                f"--profile-steps wants integers, got {spec!r}") from e
        return cls(a, b, logdir, device)

    def maybe_start(self, step: int) -> bool:
        if self.done or self.active or step < self.start or step > self.stop:
            return False
        try:
            os.makedirs(self.logdir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.start()
            self.active = True
        except Exception as e:  # profiling must never kill the run
            warnings.warn(f"profiler: start failed ({e}); disabling the "
                          "profile window")
            self._prof = None
            self.done = True
        return self.active

    def _stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self.path)

    def maybe_stop(self, step: int) -> bool:
        """Stop after the last window step (call with the step just run)."""
        if not self.active or step < self.stop:
            return False
        try:
            self._stop()
        except Exception as e:
            warnings.warn(f"profiler: stop failed ({e})")
        self.active = False
        self.done = True
        self._prof = None
        return True

    def finalize(self) -> None:
        """Stop an open trace (run ended inside the window / SIGTERM)."""
        if self.active:
            try:
                self._stop()
            except Exception:
                pass
            self.active = False
            self.done = True
            self._prof = None
