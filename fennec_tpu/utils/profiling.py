"""Observability: per-stage wall timers and jax.profiler traces.

The reference's only timing surface is the CLI wall-clock print
(cmd/fennec/main.go:116-127) and Go benchmarks; this build adds
device-aware tracing (jax.profiler) and a composable stage timer.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from typing import Dict, Iterator, Optional


class StageTimer:
    """Accumulates wall time per named stage.  Thread-safe: the fused
    batch engine records feeder-pool stages into the same timer the
    dispatch thread uses.

    with timer.stage("resize"): ...
    print(timer.report())
    """

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        with self._lock:  # workers may still be recording stages
            totals = dict(self.totals)
            counts = dict(self.counts)
        lines = []
        for name in sorted(totals, key=totals.get, reverse=True):
            t = totals[name]
            n = counts[name]
            lines.append(f"{name:24s} {t * 1000:9.1f} ms  ({n}×, "
                         f"{t / n * 1000:.1f} ms avg)")
        return "\n".join(lines)


# Ambient timer: production paths call `stage("name")` unconditionally;
# it is a no-op unless a caller (CLI -v, FENNEC_DEBUG_BATCH) installed a
# StageTimer via use_timer().  A ContextVar (not a module global) keeps
# concurrent compress calls on other threads from recording into — or
# clobbering — an unrelated caller's timer; engine code that WANTS
# worker-thread stages in one report passes the timer object explicitly.
_active: "contextvars.ContextVar[Optional[StageTimer]]" = \
    contextvars.ContextVar("fennec_stage_timer", default=None)


@contextlib.contextmanager
def use_timer(timer: StageTimer) -> Iterator[StageTimer]:
    """Install `timer` as the ambient stage timer for the block."""
    token = _active.set(timer)
    try:
        yield timer
    finally:
        _active.reset(token)


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """Time a named stage on the ambient timer (no-op when none)."""
    timer = _active.get()
    if timer is None:
        yield
        return
    with timer.stage(name):
        yield


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Wrap a block in a jax.profiler trace when log_dir is given; no-op
    otherwise.  View with TensorBoard or xprof."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def nan_check(name: str, *arrays) -> None:
    """Debug guard: raise if any array contains NaN/Inf.

    The functional-JAX analogue of the reference's -race discipline
    (Makefile:25) — there are no data races to detect in pure programs,
    so the numeric failure mode worth guarding is NaN propagation.
    Enable globally instead with jax.config.update("jax_debug_nans", True).
    """
    import numpy as np

    for i, a in enumerate(arrays):
        arr = np.asarray(a)
        if not np.isfinite(arr).all():
            raise FloatingPointError(
                f"fennec: non-finite values in {name}[{i}]")
