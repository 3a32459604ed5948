"""Adaptive chunk watchdog (_FaultBoard): a wedged device must be
detected within tens of seconds once the pipeline is warm, while cold
compiles (minutes for a large new geometry) must never false-positive —
they hold the FENNEC_CHUNK_TIMEOUT ceiling via cold_guard.  The reference has no device to wedge; its analogue is the
worker pool never hanging the caller on one bad item (batch.go:58-128).
"""

import concurrent.futures
import threading
import time

import pytest

import fennec_tpu.engine.batched as eb
from fennec_tpu.engine.batched import (
    DeviceTimeoutError,
    _FaultBoard,
    _is_device_error,
)


def _hung_future():
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ev = threading.Event()
    fut = pool.submit(ev.wait, 60.0)
    return fut, ev, pool


class TestAdaptiveTimeout:
    def test_cold_until_first_wall(self):
        b = _FaultBoard(900.0)
        assert b.current_timeout() == 900.0
        b.note_wall(0.5)
        # Warm: max(floor, K * p95) — tens of seconds, not 15 minutes.
        assert b.current_timeout() == max(eb.WATCHDOG_FLOOR,
                                          eb.WATCHDOG_K * 0.5)
        assert b.current_timeout() < 60.0

    def test_ceiling_is_hard(self):
        # A configured tight ceiling stays authoritative even when the
        # adaptive bound would be larger (the wedged-device test in
        # test_fused_batch.py monkeypatches CHUNK_TIMEOUT=0.5).
        b = _FaultBoard(0.5)
        b.note_wall(30.0)
        assert b.current_timeout() == 0.5

    def test_scales_with_slow_device(self):
        # Legitimately slow chunks (large images, a busy device) raise
        # the bound — the watchdog adapts instead of false-firing.
        b = _FaultBoard(900.0)
        for _ in range(8):
            b.note_wall(45.0)
        assert b.current_timeout() == pytest.approx(
            min(900.0, eb.WATCHDOG_K * 45.0))

    def test_cold_guard_holds_ceiling(self):
        b = _FaultBoard(420.0)
        b.note_wall(0.1)
        with b.cold_guard(("prog", 1)):
            # Simulated cold compile in flight: full ceiling applies.
            assert b.current_timeout() == 420.0
        assert b.current_timeout() < 60.0
        # Repeat key is warm — no ceiling hold.
        with b.cold_guard(("prog", 1)):
            assert b.current_timeout() < 60.0

    def test_wedged_fast_path(self):
        b = _FaultBoard(900.0)
        b.fault["wedged"] = True
        assert b.current_timeout() == 2.0


class TestWaitAndDrain:
    def test_wait_future_detects_wedge_fast_post_warmup(self,
                                                        monkeypatch):
        # Warm board + hung pull: detection must take the adaptive
        # bound (sub-minute at real walls; sub-second at test scale),
        # not the 900 s ceiling.
        monkeypatch.setattr(eb, "WATCHDOG_FLOOR", 0.3)
        b = _FaultBoard(900.0)
        b.note_wall(0.01)
        fut, ev, pool = _hung_future()
        t0 = time.perf_counter()
        with pytest.raises(DeviceTimeoutError):
            b.wait_future(fut, "chunk pull")
        assert time.perf_counter() - t0 < 5.0
        ev.set()
        pool.shutdown(wait=True)

    def test_wait_future_no_false_positive_during_cold(self,
                                                       monkeypatch):
        # A slow first-time dispatch (simulated compile under
        # cold_guard) must NOT trip the warm bound.
        monkeypatch.setattr(eb, "WATCHDOG_FLOOR", 0.2)
        b = _FaultBoard(30.0)
        b.note_wall(0.01)  # warm bound would be 0.2 s
        pool = concurrent.futures.ThreadPoolExecutor(1)
        guard = b.cold_guard(("new-program",))

        def compile_then_finish():
            with guard:
                time.sleep(1.0)  # "compile" 5× the warm bound
            return 42

        fut = pool.submit(compile_then_finish)
        assert b.wait_future(fut, "chunk pull") == 42
        pool.shutdown(wait=True)

    def test_drain_one_deadline_not_per_future(self, monkeypatch):
        # 6 hung futures must cost ONE adaptive bound, not 6× — the
        # round-4 force-drain paid 2 s per future serially.
        monkeypatch.setattr(eb, "WATCHDOG_FLOOR", 0.5)
        b = _FaultBoard(900.0)
        b.note_wall(0.01)
        pool = concurrent.futures.ThreadPoolExecutor(6)
        ev = threading.Event()
        futs = [pool.submit(ev.wait, 60.0) for _ in range(6)]
        t0 = time.perf_counter()
        not_done = b.drain(futs, "item finalize")
        dt = time.perf_counter() - t0
        assert len(not_done) == 6
        assert dt < 3.0  # one bound (+ poll slack), not 6 × 0.5
        assert b.fault["wedged"]
        assert isinstance(b.fault["last"], DeviceTimeoutError)
        ev.set()
        pool.shutdown(wait=True)

    def test_drain_passes_completed_futures(self):
        b = _FaultBoard(5.0)
        pool = concurrent.futures.ThreadPoolExecutor(2)
        futs = [pool.submit(lambda: 1) for _ in range(4)]
        assert b.drain(futs, "x") == set()
        assert not b.fault["wedged"]
        pool.shutdown(wait=True)


class TestErrorTaxonomy:
    def test_host_timeout_is_not_a_device_error(self):
        # A builtin TimeoutError out of host code inside a per-item
        # redo is a host bug and must propagate — only the watchdog's
        # own DeviceTimeoutError counts as a device fault.
        assert not _is_device_error(TimeoutError("host-side"))
        assert _is_device_error(DeviceTimeoutError("watchdog"))

    def test_xla_errors_still_match(self):
        class XlaRuntimeError(RuntimeError):
            pass

        assert _is_device_error(XlaRuntimeError("backend error"))
        assert not _is_device_error(ValueError("host bug"))
