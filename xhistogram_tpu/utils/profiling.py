"""Profiling helpers (SURVEY.md §5: the reference has no in-repo tracing —
observability came from dask's dashboard; the JAX equivalents are the
JAX profiler + the ``jax.named_scope`` annotations already placed in the
pipeline, plus this thin harness).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

__all__ = ["trace", "measure"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture a JAX/Perfetto profiler trace of the enclosed block.

    View with ``xprof``/TensorBoard or ui.perfetto.dev. The pipeline's
    ``xhistogram.*`` named scopes label the digitize/count stages.
    """
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield


def measure(fn, *args, reps=5, warmup=1):
    """Wall-clock a function that returns jax arrays, each call ending in
    ``jax.block_until_ready`` (JAX returns before the device finishes).
    Returns (median_seconds, list_of_seconds)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times
