"""Retrace sentinel: the hot-loop trace-count guard, as the reference has it.

The port compiles nothing, so a *trace* here is a step running at an input
signature (every input tensor's shape, dtype and device) it has not run at
before: exactly when the reference's ``jit`` would retrace. The executors
key each step on that signature (:class:`SignatureCache`) and call
:meth:`RetraceSentinel.trace` on a new one; a warm step costs one tuple
build and one set lookup per call.

Each step owns one :class:`RetraceSentinel` with a trace *budget*
(``allowed``): 1 for the pipelined step, its emission and the ad hoc
query; 0 for the batched window step, which calls ``allow(1)`` per new
micro-batch count before running it. A trace beyond the budget is a
violation: recorded (and reported through the attached telemetry hook)
by default, raised as :class:`RetraceError` in strict mode
(``REPRO_OBS_STRICT=1`` or ``Telemetry(strict_retrace=True)``).
"""
from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import torch


def strict_from_env() -> bool:
    """CI switch: ``REPRO_OBS_STRICT=1`` makes every sentinel raise."""
    return os.environ.get("REPRO_OBS_STRICT", "") not in ("", "0")


class RetraceError(RuntimeError):
    """A compiled step retraced beyond its declared budget."""


class RetraceSentinel:
    """Trace-budget guard for one step."""

    def __init__(self, name: str, allowed: int = 1,
                 strict: Optional[bool] = None,
                 on_violation: Optional[Callable[[str, int, int], None]]
                 = None):
        self.name = name
        self.allowed = allowed
        self.strict = strict_from_env() if strict is None else strict
        self.on_violation = on_violation
        self.traces = 0
        self.violations = 0

    def allow(self, n: int = 1) -> None:
        """Raise the budget: call BEFORE an expected new signature, e.g.
        a new micro-batch count."""
        self.allowed += n

    def trace(self) -> None:
        """Record one trace (a step running at a new signature)."""
        self.traces += 1
        if self.traces <= self.allowed:
            return
        self.violations += 1
        msg = (f"compiled step {self.name!r} retraced after warmup: "
               f"{self.traces} traces > budget {self.allowed} — the "
               "hot loop is paying trace+compile per call (shape/dtype "
               "drift or a donation mismatch)")
        if self.on_violation is not None:
            self.on_violation(self.name, self.traces, self.allowed)
        if self.strict:
            raise RetraceError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    def __repr__(self) -> str:
        return (f"RetraceSentinel({self.name!r}, traces={self.traces}, "
                f"allowed={self.allowed}, violations={self.violations})")


def signature(*trees) -> tuple:
    """The abstract signature of tensors nested in dataclasses, tuples,
    lists and dicts: each tensor's shape, dtype and device, each other
    leaf's type (a Python scalar is a weak-typed scalar to ``jit``)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((tuple(x.shape), x.dtype, x.device))
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f))
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            out.append(type(x))
    for t in trees:
        walk(t)
    return tuple(out)


class SignatureCache:
    """The signatures one step has run at: :meth:`see` traces the
    sentinel on a new one, as ``jit`` traces on a cache miss."""

    def __init__(self, sentinel: RetraceSentinel):
        self.sentinel = sentinel
        self.seen: set = set()

    def see(self, sig: tuple) -> None:
        if sig not in self.seen:
            # A trace that raises is not cached, as jit caches nothing
            # for a trace that failed.
            self.sentinel.trace()
            self.seen.add(sig)
