"""Profiling / tracing hooks.

The reference has no tracing layer (SURVEY.md §5: perf measurement lives
only in its test harness); this is new surface, labeled as such. Wraps jax.profiler so users can capture device traces of the SSIM
pipeline for the XProf/TensorBoard toolchain.
"""

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace of the enclosed block:

        with ssim_tpu.utils.profiling.trace("/tmp/ssim-trace"):
            compute_ssim(a, b)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


#: Named region in the trace timeline. A direct alias of
#: jax.profiler.TraceAnnotation (same context-manager call syntax) —
#: a generator wrapper would only add a host-side frame per region
#: entry/exit in exactly the hot loops annotations are used in.
annotate = jax.profiler.TraceAnnotation


class Timer:
    """Wall-clock timer for quick measurements without a full trace.

    The caller is responsible for blocking on device outputs inside the
    block (e.g. via a host readback); JAX dispatch is asynchronous. For
    steady-state device rates use the on-device loop of
    ssim_tpu/testing/devicebench.py."""

    def __init__(self):
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
