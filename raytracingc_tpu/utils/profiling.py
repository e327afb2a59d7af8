"""Profiling and observability hooks.

The reference has zero timing/tracing (SURVEY.md §5.1 — it never measures its
own speed). Here:

* :class:`Profiler` — lightweight wall-clock phase timers plus derived
  throughput (rays/s) accounting, printable as a one-line summary.
* :func:`trace_annotation` — names a region for the JAX profiler
  (``jax.profiler.TraceAnnotation``), visible in TensorBoard/Perfetto traces.
* :func:`start_trace` / :func:`stop_trace` — capture a device trace for a
  window of steps (wraps ``jax.profiler``; works on the GPU and the CPU).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class Profiler:
    """Accumulating phase timers: ``with prof.phase("trace"): ...``."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
    rays: float = 0.0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def add_rays(self, n: float) -> None:
        self.rays += float(n)

    def summary(self) -> str:
        parts = [
            f"{k}={v:.3f}s/{self.counts[k]}x" for k, v in sorted(self.totals.items())
        ]
        total = sum(self.totals.values())
        if self.rays and total > 0:
            parts.append(f"rays/s={self.rays / total:.3g}")
        return " ".join(parts) or "(no phases recorded)"


def trace_annotation(name: str):
    """Named region in device profiles (no-op overhead when not tracing)."""
    return jax.profiler.TraceAnnotation(name)


def start_trace(log_dir: str) -> None:
    """Begin capturing a device trace (view with TensorBoard's profile tab)."""
    jax.profiler.start_trace(log_dir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
