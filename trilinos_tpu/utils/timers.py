"""Scoped timers and profiler regions.

JAX analogue of ``Teuchos::TimeMonitor`` / ``StackedTimer``
(reference: packages/teuchos/comm/src/Teuchos_TimeMonitor.hpp:145,
Teuchos_StackedTimer.hpp) and of ``Tpetra::Details::ProfilingRegion``
(packages/tpetra/core/src/Tpetra_Details_Profiling.hpp:100), which pushed
Kokkos profiling regions; here regions additionally push
``jax.profiler.TraceAnnotation`` scopes so they show up in device traces.

Timing JAX correctly requires blocking on async dispatch, so ``Timer``
optionally calls ``block_until_ready`` on a supplied value.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

try:  # profiler annotation is best-effort (absent on some backends)
    from jax.profiler import TraceAnnotation
except Exception:  # pragma: no cover
    TraceAnnotation = None


@dataclass
class _Record:
    total: float = 0.0
    count: int = 0
    t_min: float = float("inf")
    t_max: float = 0.0

    def add(self, dt: float) -> None:
        self.total += dt
        self.count += 1
        self.t_min = min(self.t_min, dt)
        self.t_max = max(self.t_max, dt)


@dataclass
class TimerRegistry:
    """Accumulates named timings; hierarchical names use '/' separators."""

    records: dict = field(default_factory=lambda: defaultdict(_Record))
    _stack: list = field(default_factory=list)

    @contextlib.contextmanager
    def time(self, name: str, block_on=None):
        """Scoped timer. ``block_on``: array(s) whose readiness ends the scope."""
        self._stack.append(name)
        full = "/".join(self._stack)
        ctx = TraceAnnotation(name) if TraceAnnotation is not None else contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            if block_on is not None:
                _block(block_on)
            self.records[full].add(time.perf_counter() - t0)
            self._stack.pop()

    def summarize(self) -> str:
        """Table like TimeMonitor::summarize (single-process statistics)."""
        lines = [f"{'Timer':50s} {'total(s)':>10s} {'count':>7s} {'avg(ms)':>10s}"]
        for name in sorted(self.records):
            r = self.records[name]
            avg_ms = 1e3 * r.total / max(r.count, 1)
            lines.append(f"{name:50s} {r.total:10.4f} {r.count:7d} {avg_ms:10.3f}")
        return "\n".join(lines)

    def total(self, name: str) -> float:
        return self.records[name].total

    def reset(self) -> None:
        self.records.clear()


def _block(x):
    import jax

    jax.block_until_ready(x)


# Global default registry (like the TimeMonitor static counter table).
GLOBAL_TIMERS = TimerRegistry()


@contextlib.contextmanager
def profiling_region(name: str):
    """RAII profiling region: shows up in jax.profiler device traces."""
    if TraceAnnotation is not None:
        with TraceAnnotation(name):
            yield
    else:  # pragma: no cover
        yield
