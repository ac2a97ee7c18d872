"""Tracing/profiling hooks.

The reference's observability is ``time.perf_counter`` brackets and a
matvec-counting wrapper (``scripts/utils.py:55-68,138-148``); wrappers can't
see through ``jit``, so here the equivalents are:

* :func:`trace` — context manager around ``jax.profiler`` emitting a
  TensorBoard-loadable device trace of everything inside.
* :func:`annotate` — named ``TraceAnnotation`` scopes so solver phases
  (expand / rotate / truncate) are distinguishable in the trace.
* matvec counting lives in the solver state itself
  (:class:`arnoldi_jax.utils.History`), not in a wrapper.
"""

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir):
    """Capture a device profile of the enclosed block into ``log_dir``
    (view with TensorBoard's profile plugin or xprof)."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name):
    """Named scope that shows up in profiler traces."""
    return jax.profiler.TraceAnnotation(name)


class WallClock:
    """Tiny phase stopwatch for host-side instrumentation.

    >>> clock = WallClock()
    >>> with clock("expand"): ...
    >>> clock.totals
    {'expand': 0.0123}
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, phase):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    def report(self):
        return {
            phase: {"seconds": round(t, 6), "calls": self.counts[phase]}
            for phase, t in sorted(self.totals.items())
        }


class _NullClock:
    """No-op stand-in so hot paths can call ``with clock(...)``
    unconditionally."""

    @contextlib.contextmanager
    def __call__(self, phase):
        yield

    def report(self):
        return {}


NULL_CLOCK = _NullClock()


def phase_clock():
    """Solver phase stopwatch: a :class:`WallClock` when the
    ``ARNOLDI_PHASES`` environment variable is set (the report lands on
    ``History.phases``), else the shared no-op."""
    import os

    return WallClock() if os.environ.get("ARNOLDI_PHASES") else NULL_CLOCK
