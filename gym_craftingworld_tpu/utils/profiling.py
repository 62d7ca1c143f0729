"""Tracing / profiling helpers.

The reference has no profiling at all (SURVEY §5); here every hot region can
be annotated for the JAX profiler and throughput is tracked per host.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region for jax.profiler traces (XPlane/TensorBoard)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Capture a device trace around a block (view with TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Throughput:
    """Env-steps/s counter with exponential smoothing."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.rate = None
        self._t = None

    def tick(self, steps: int) -> float | None:
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / (now - self._t)
            self.rate = (
                inst
                if self.rate is None
                else self.alpha * inst + (1 - self.alpha) * self.rate
            )
        self._t = now
        return self.rate
