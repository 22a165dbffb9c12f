"""repro_torch.obs — the training telemetry plane (the port of ``repro.obs``).

Structured metrics sinks (JSONL canonical / CSV / in-memory) behind a
non-blocking :class:`MetricsLogger`, the per-layer-group gradient
statistics collector (:class:`StatsPolicy` — the paper's Fig. 4/10
quantities as live metrics), host-side step-time and device-memory
accounting, and profiler trace hooks over ``torch.profiler``. Records
follow the JAX package's ``repro_metrics/v1`` grammar.
"""
from .metrics import (SCHEMA, CSVSink, JSONLSink, MemorySink, MetricsLogger,
                      jsonable, validate_jsonl, validate_record)
from .profile import ProfileWindow, trace_span
from .stats import StatsPolicy, make_stats_fn, split_stats, stats_keys
from .timing import StepTimer, device_memory

__all__ = [
    "SCHEMA", "CSVSink", "JSONLSink", "MemorySink", "MetricsLogger",
    "jsonable", "validate_jsonl", "validate_record",
    "ProfileWindow", "trace_span",
    "StatsPolicy", "make_stats_fn", "split_stats", "stats_keys",
    "StepTimer", "device_memory",
]
