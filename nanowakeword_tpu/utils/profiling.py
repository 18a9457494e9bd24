"""Tracing & profiling hooks (new capability — the reference has none,
SURVEY.md §5.1).

Two layers:
* `trace(logdir)`: context manager around `jax.profiler.trace` producing
  xprof/TensorBoard traces of device execution.
* `StepTimer`: lightweight wall-clock step statistics (p50/p90/mean,
  steps/sec) for the training loop and benchmarks, synchronised with
  `jax.block_until_ready`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a device trace viewable in TensorBoard / xprof."""
    import jax
    jax.profiler.start_trace(logdir,
                             create_perfetto_link=create_perfetto_link)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up in device traces (TraceAnnotation)."""
    import jax
    return jax.profiler.TraceAnnotation(name)


class StepTimer:
    """Accumulates per-step wall times; `sync_value` is waited on."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        self._count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        """End the step; pass the step's device output to wait on."""
        if sync_value is not None:
            import jax
            jax.block_until_ready(sync_value)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    def stats(self) -> dict:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        return {
            "steps": int(t.size),
            "mean_ms": float(t.mean() * 1e3),
            "p50_ms": float(np.percentile(t, 50) * 1e3),
            "p90_ms": float(np.percentile(t, 90) * 1e3),
            "steps_per_sec": float(1.0 / t.mean()),
        }
