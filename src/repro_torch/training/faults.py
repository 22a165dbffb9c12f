"""Deterministic fault injection: the port of ``repro.training.faults``.

Each way a pretraining run dies in production (a gradient blow-up, IO
errors under a flaky filesystem, a host killed mid-commit, a kernel that
fails) becomes a reproducible event driven by the ``REPRO_FAULTS``
environment variable, so the guard (:mod:`.resilience`), the checkpointer
(:mod:`repro_torch.checkpoint`) and the launcher's recovery can be
exercised by tests and by hand without patching internals.

Spec grammar (the JAX package's)::

    REPRO_FAULTS ::= clause (";" clause)*
    clause       ::= kind "@" arg (":" arg)*

    nan_grad@K        NaN gradients at global step K (repeatable)
    inf_grad@K        Inf gradients at global step K (repeatable)
    io_error@SITE:N   the first N IO ops at SITE raise OSError
                      (SITE in {save, commit}; exercises retry-with-backoff)
    kill@SITE:N       the N-th operation at SITE raises SimulatedKill, a
                      BaseException that generic recovery code cannot
                      swallow (SITE in {save, commit}: "save" fires after
                      the shard lands but before this host's manifest;
                      "commit" after the merged manifest but before the
                      COMMITTED marker)
    dispatch_fail@OP  the wrapper of kernel entry point OP (an op name of
                      ``repro_torch.kernels.dispatch``, or "*" for all)
                      raises FaultError before any launch

``dispatch_fail`` differs from the JAX package on purpose: there the
dispatch layer catches the failure and degrades to the jnp reference; the
port has no fallback, so the failure reaches the caller, on the CPU and
on the card alike.

Examples::

    REPRO_FAULTS="nan_grad@3"
    REPRO_FAULTS="io_error@save:2;kill@commit:1"
    REPRO_FAULTS="nan_grad@5;inf_grad@9;dispatch_fail@norm_update"

Step-indexed faults key off the train state's device step counter;
counted faults (``io_error``, ``kill``) consume process-local counters
that :func:`reset` rewinds. An unset or empty ``REPRO_FAULTS`` makes every
gate a no-op.
"""
from __future__ import annotations

import functools
import os
import threading
from typing import NamedTuple

ENV_VAR = "REPRO_FAULTS"

_SITES = ("save", "commit")
_GRAD_KINDS = ("nan_grad", "inf_grad")


class FaultError(RuntimeError):
    """Raised by the dispatch gate: the injected kernel-route failure."""


class SimulatedKill(BaseException):
    """A simulated hard kill (SIGKILL at the worst moment).

    A ``BaseException``, so recovery code that catches ``Exception``
    (retry loops) cannot absorb it. Only the chaos tests catch it.
    """


class FaultPlan(NamedTuple):
    """Parsed, immutable ``REPRO_FAULTS`` spec.

    ``grad_steps``: ((step, kind), ...) sorted, kind in {nan, inf}.
    ``io_errors``: ((site, n), ...): the first n IO ops at site fail.
    ``kills``: ((site, n), ...): the n-th op at site raises SimulatedKill.
    ``dispatch_ops``: op names (or "*") whose kernel wrapper must fail.
    """
    grad_steps: tuple = ()
    io_errors: tuple = ()
    kills: tuple = ()
    dispatch_ops: tuple = ()

    def grad_fault_steps(self, kind: str) -> tuple:
        """Sorted global steps at which ``kind`` gradients are injected."""
        return tuple(s for s, k in self.grad_steps if k == kind)

    @property
    def any_grad_faults(self) -> bool:
        return bool(self.grad_steps)


def _int_arg(clause: str, arg: str) -> int:
    try:
        v = int(arg)
    except ValueError:
        raise ValueError(
            f"REPRO_FAULTS clause {clause!r}: {arg!r} is not an integer")
    if v < 0:
        raise ValueError(f"REPRO_FAULTS clause {clause!r}: {arg!r} < 0")
    return v


@functools.lru_cache(maxsize=None)
def parse_faults(spec: str) -> FaultPlan:
    """Parse a ``REPRO_FAULTS`` spec string (see the module docstring).

    Raises ``ValueError`` naming the offending clause for anything outside
    the grammar: a silently ignored typo would make a chaos run vacuous.
    """
    grad, io, kills, ops = [], [], [], []
    for clause in filter(None, (c.strip() for c in spec.split(";"))):
        kind, sep, rest = clause.partition("@")
        if not sep or not rest:
            raise ValueError(
                f"REPRO_FAULTS clause {clause!r}: expected kind@arg[:arg]")
        args = rest.split(":")
        if kind in _GRAD_KINDS:
            if len(args) != 1:
                raise ValueError(
                    f"REPRO_FAULTS clause {clause!r}: expected {kind}@step")
            grad.append((_int_arg(clause, args[0]), kind.split("_")[0]))
        elif kind in ("io_error", "kill"):
            if len(args) != 2 or args[0] not in _SITES:
                raise ValueError(
                    f"REPRO_FAULTS clause {clause!r}: expected "
                    f"{kind}@site:n with site in {_SITES}")
            (io if kind == "io_error" else kills).append(
                (args[0], _int_arg(clause, args[1])))
        elif kind == "dispatch_fail":
            if len(args) != 1 or not args[0]:
                raise ValueError(
                    f"REPRO_FAULTS clause {clause!r}: expected "
                    "dispatch_fail@op (op name or *)")
            ops.append(args[0])
        else:
            raise ValueError(
                f"REPRO_FAULTS clause {clause!r}: unknown fault kind "
                f"{kind!r} (known: nan_grad, inf_grad, io_error, kill, "
                "dispatch_fail)")
    return FaultPlan(tuple(sorted(grad)), tuple(io), tuple(kills),
                     tuple(ops))


def resolve_plan() -> FaultPlan | None:
    """Read ``REPRO_FAULTS`` now and parse it (None when unset or empty)."""
    spec = os.environ.get(ENV_VAR, "").strip()
    return parse_faults(spec) if spec else None


# Counted gates (IO errors, kills): process-local and thread-safe (AsyncSave
# runs the checkpoint IO on a worker thread), rewound by reset().

_lock = threading.Lock()
_counts: dict = {}


def reset() -> None:
    """Rewind all fault counters (the chaos tests call this between cases)."""
    with _lock:
        _counts.clear()


def _bump(key: str) -> int:
    """1-based occurrence number of this event at ``key``."""
    with _lock:
        _counts[key] = _counts.get(key, 0) + 1
        return _counts[key]


def io_gate(site: str, plan: FaultPlan | None = None) -> None:
    """Raise OSError for the first N IO ops at ``site`` (per the plan)."""
    plan = resolve_plan() if plan is None else plan
    if plan is None:
        return
    budget = sum(n for s, n in plan.io_errors if s == site)
    if budget and _bump(f"io:{site}") <= budget:
        raise OSError(f"injected IO error at {site!r} (REPRO_FAULTS)")


def kill_gate(site: str, plan: FaultPlan | None = None) -> None:
    """Raise SimulatedKill on the configured occurrence at ``site``."""
    plan = resolve_plan() if plan is None else plan
    if plan is None:
        return
    hits = {n for s, n in plan.kills if s == site}
    if hits and _bump(f"kill:{site}") in hits:
        raise SimulatedKill(f"injected kill at {site!r} (REPRO_FAULTS)")


def dispatch_gate(op: str, plan: FaultPlan | None = None) -> None:
    """Raise FaultError when ``op``'s kernel wrapper is spec'd to fail.

    ``repro_torch.kernels.dispatch`` calls this at the top of each entry
    point, before any launch; nothing catches it.
    """
    plan = resolve_plan() if plan is None else plan
    if plan is None:
        return
    if "*" in plan.dispatch_ops or op in plan.dispatch_ops:
        raise FaultError(
            f"injected kernel-dispatch failure for {op!r} (REPRO_FAULTS)")
