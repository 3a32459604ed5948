"""Fused mega-batch compression: the device CompressBatch core.

The reference's batch engine is a goroutine worker pool running the whole
scalar pipeline per file (batch.go:58-128).  Here, standard-mode JPEG
compression over a list of decoded images is restructured as device
mega-batches:

  1. bucket images by exact (H, W) shape (XLA needs static shapes; same-
     shape images share one compiled program);
  2. within a bucket, run the vmapped lockstep quality bisection for up to
     BATCH_CHUNK images at a time — every image carries its own (lo, hi)
     search state, so mixed difficulty costs nothing extra;
  3. entropy-code the winners.  Either the Huffman bitstream is
     ASSEMBLED ON DEVICE (ops/jpeg_emit.py) — with per-image optimal
     tables built from device symbol histograms when optimize_huffman is
     on — and the host only byte-stuffs and wraps the container, or the
     C++ host codec codes the scan while the device works on the next
     chunk (Options.device_entropy=None takes the platform's default,
     backend.device_entropy_default).

PNG-routed images (alpha / few colors under AUTO) take the per-image PNG
path — palette work is host-side anyway.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import device_entropy_default
from ..codecs.jpeg import (
    assemble_jpeg,
    encode_scan_from_quantized,
    encode_scan_optimized,
)
from ..image import analyze_format, to_nrgba, validate_image
from ..ops.dct import all_quality_tables
from ..ops.jpeg_emit import emit_words_for_bits
from ..ops.resize import smart_resize
from ..parallel.batched import batched_search_and_quantize
from ..types import Context, Format, Options, Result
from .compress import compress_png

# Pipeline constants.  Their values are UNTUNED defaults: they are yet
# to be derived from the device idle share measured on the GPU.
#
# Images per device dispatch.
BATCH_CHUNK = int(os.environ.get("FENNEC_BATCH_CHUNK", "64"))
# How many chunks the feeder keeps decoded+uploaded ahead of the
# dispatch thread (2 = double-buffering).
PREFETCH = max(2, int(os.environ.get("FENNEC_BATCH_PREFETCH", "2")))
# Width of the stage-A/stage-B executors: widths above 1 overlap chunk
# k+1's pull with chunk k's host table build + dispatch.  Ledger entries
# carry their own (ids, futures) pairs, so completion order across
# chunks is free to interleave — on_chunk streaming order is
# by-completion, the documented contract.
STAGE_WORKERS = max(1, int(os.environ.get("FENNEC_STAGE_WORKERS", "3")))
# How many chunks' search dispatches run ahead of their stage-A pulls.
# 2 = dispatch chunk k+1's search before pulling chunk k; deeper values
# trade device memory for more dispatch-ahead slack.
SEARCHQ_DEPTH = max(1, int(os.environ.get("FENNEC_SEARCHQ_DEPTH", "2")))
# Stage width of the pixel path, whose feeder uploads ~48 MB of pixels
# per 64-chunk (the coefficient path uploads ~50x less).
STAGE_WORKERS_PX = max(1, int(os.environ.get(
    "FENNEC_STAGE_WORKERS_PX", "1")))
# Fused optimal-Huffman: search → histograms → DEVICE K.2 table build →
# custom-table emission in ONE dispatch with ONE pull (ops/huffbuild.py),
# vs the two-stage hist-pull → host-tables → emit-dispatch → words-pull.
#
# DEFAULT OFF: the fused-opt emission programs size their buffers for
# the worst case (n_blocks*53 words), which makes them very large; the
# two-stage path sizes its emission buffer from the chunk's exact
# standard-table bit counts instead.  Not yet measured on the GPU.
# FENNEC_FUSED_OPT=1 opts in.
FUSED_OPT = os.environ.get("FENNEC_FUSED_OPT", "0") == "1"
# In-memory pixel wire format: "yuv420" (default) ships host-converted
# YCbCr 4:2:0 planes at HALF the RGB bytes (opaque 4:2:0 device-entropy
# chunks only; everything else ships "rgb" = (B, H, W, 3|4) uint8 with
# the color convert on device).  The C++ per-image conversion writes the
# wire straight from the caller's NRGBA arrays (no staging stack); the
# u8 plane rounding bounds |dSSIM| against the rgb wire (pinned in
# tests/test_pixel_wire.py).  FENNEC_PIXEL_WIRE=rgb restores the
# bit-exact-with-per-image wire.
PIXEL_WIRE = os.environ.get("FENNEC_PIXEL_WIRE", "yuv420")
# COO coefficient uploads: ~2.5x smaller uploads on photo content;
# FENNEC_COO=0 forces the dense zigzag-truncated layout (A/B).
COO_UPLOADS = os.environ.get("FENNEC_COO", "1") != "0"
# Per-chunk watchdog CEILING: if a chunk's upload/pull blocks longer
# than this the device is treated as wedged — the engine stops
# dispatching and fails the remaining items instead of hanging the
# caller forever.  0 disables.  The ceiling leaves room for a cold
# compile of a large program — but once the pipeline is WARM (no
# compile in flight, completed chunk walls on record) the effective
# bound drops to max(FLOOR, K × p95 of recent chunk walls), so a wedge
# after warmup is detected in tens of seconds, not 15 minutes
# (_FaultBoard).
CHUNK_TIMEOUT = float(os.environ.get("FENNEC_CHUNK_TIMEOUT", "900"))
# Adaptive-watchdog floor and multiplier (see _FaultBoard.current_timeout).
WATCHDOG_FLOOR = float(os.environ.get("FENNEC_WATCHDOG_FLOOR", "20"))
WATCHDOG_K = float(os.environ.get("FENNEC_WATCHDOG_K", "10"))


class DeviceTimeoutError(TimeoutError):
    """Raised (or recorded) by the chunk watchdog when a device
    upload/pull exceeds the adaptive bound.  A DEDICATED subclass so
    `_is_device_error` never misclassifies a host-side TimeoutError
    raised inside a per-item redo (a host bug must propagate, not be
    silently downgraded to a failed item)."""


def _is_device_error(e: BaseException) -> bool:
    """True for failures of the device or its transport (XLA runtime
    errors, watchdog timeouts) — the class of error the batch engines
    isolate per chunk and retry, as opposed to host-code bugs, which
    propagate.  The reference's worker pool has the same split: a
    worker's per-item error is captured, a panic propagates
    (batch.go:108-113).  Only the engine's own DeviceTimeoutError
    counts — a builtin TimeoutError out of host code is a host bug."""
    if isinstance(e, DeviceTimeoutError):
        return True
    for klass in type(e).__mro__:
        if klass.__name__ in ("XlaRuntimeError", "JaxRuntimeError"):
            return True
    return False


class FusedChunkError(RuntimeError):
    """Some chunks of a fused batch failed on-device.  Successful chunks
    were already streamed via on_chunk; `failed_ids` lists the indices
    (into the call's input list) that did NOT complete.  `wedged` means
    the device stopped responding (a pull timed out) — callers
    must NOT retry through the device in that case."""

    def __init__(self, failed_ids, cause, wedged: bool = False):
        self.failed_ids = sorted(failed_ids)
        self.cause = cause
        self.wedged = wedged
        state = "device wedged (pull timeout)" if wedged \
            else "device error"
        super().__init__(
            f"fennec: fused batch: {len(self.failed_ids)} item(s) "
            f"failed [{state}]: {cause!r}")


def _batch_timer():
    """Per-call StageTimer when FENNEC_DEBUG_BATCH is set, else None."""
    if os.environ.get("FENNEC_DEBUG_BATCH"):
        from ..utils.profiling import StageTimer

        return StageTimer()
    return None


def _tstage(timer, name: str):
    import contextlib

    return timer.stage(name) if timer is not None \
        else contextlib.nullcontext()


def _treport(timer, tag: str) -> None:
    if timer is not None and timer.totals:
        import sys

        print(f"fennec: {tag} stage breakdown:\n{timer.report()}",
              file=sys.stderr, flush=True)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _yuv420_wire_host(stack: np.ndarray, h: int, w: int) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB → flat (B, ph·pw + 2·(ph/2)·(pw/2)) uint8
    YCbCr 4:2:0 wire buffer, mirroring forward_dct_device's convert +
    edge pad + 2×2 mean chroma exactly (ops/color.rgb_to_ycbcr,
    ops/dct.pad_to_multiple/downsample_420); device side:
    parallel.batched._split_yuv420_wire.  One C++ pass when the native
    runtime is available (the numpy conversion costs ~0.5 s/64-chunk of
    the single host core); both paths agree to ≤1 u8 LSB (pinned in
    tests/test_pixel_wire.py)."""
    from ..native import rgb_to_yuv420

    native = rgb_to_yuv420(stack[..., :3])
    if native is not None:
        return native
    ph, pw = h + (-h) % 16, w + (-w) % 16
    rgb = stack.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168735892 * r - 0.331264108 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418687589 * g - 0.081312411 * b
    if (ph, pw) != (h, w):
        pads = ((0, 0), (0, ph - h), (0, pw - w))
        y = np.pad(y, pads, mode="edge")
        cb = np.pad(cb, pads, mode="edge")
        cr = np.pad(cr, pads, mode="edge")
    bsz = stack.shape[0]
    cb = cb.reshape(bsz, ph // 2, 2, pw // 2, 2).mean(axis=(2, 4))
    cr = cr.reshape(bsz, ph // 2, 2, pw // 2, 2).mean(axis=(2, 4))
    ny, nc = ph * pw, (ph // 2) * (pw // 2)
    buf = np.empty((bsz, ny + 2 * nc), np.uint8)
    buf[:, :ny] = np.clip(np.rint(y), 0, 255).reshape(bsz, -1)
    buf[:, ny:ny + nc] = np.clip(np.rint(cb), 0, 255).reshape(bsz, -1)
    buf[:, ny + nc:] = np.clip(np.rint(cr), 0, 255).reshape(bsz, -1)
    return buf


def _make_ledger_flush(ledger: List, results: List, on_chunk,
                       ctx=None, lock=None, board=None):
    """FIFO chunk-completion reporter shared by both fused engines:
    flush(force) reports chunks whose host encodes have all finished;
    force waits on stragglers, otherwise only fully-done chunks flush.

    Ledger entries are appended from the stage-A/stage-B executor
    threads while the dispatch thread flushes; `lock` guards the list
    mutations.  Entries are SELF-CONTAINED (each carries its own ids +
    futures pair), so a wider stage executor (STAGE_WORKERS > 1) only
    changes the order chunks complete in — flush still reports each
    chunk's own ids against its own futures, and on_chunk's contract is
    by-completion streaming, not input order.

    Cancellation is honored BETWEEN chunk reports: an on_item callback
    that calls ctx.cancel() deterministically stops every later chunk
    from being reported as a success — those items get the context
    error, no matter how far ahead the device pipeline raced
    (batch.go:93-99 semantics; the per-item pool has the same check
    between items)."""
    import threading

    if lock is None:
        lock = threading.Lock()
    failed = board.failed if board is not None else None

    def flush(force: bool) -> None:
        while True:
            if ctx is not None:
                ctx.raise_if_done()
            with lock:
                if not ledger:
                    return
                ids, futs = ledger[0]
            # Futures are waited on OUTSIDE the lock (they run on the
            # same pools that append new entries).
            if not force and not all(f.done() for f in futs):
                return
            if board is None:
                for f in futs:
                    f.result()
            else:
                # One concurrent wait over the chunk's futures against
                # one adaptive deadline (not a serial per-future wait —
                # a late wedge in a deep queue must cost ONE bound, not
                # len(futs) × bound).  Done futures re-raise host bugs.
                not_done = board.drain(futs, "item finalize")
                for f in futs:
                    if f not in not_done:
                        f.result()
                if not_done:
                    failed.update(ids)
            with lock:
                ledger.pop(0)
            if on_chunk is not None:
                # Items that failed on-device (per-item overflow redo
                # hitting a device error) must not be reported as
                # successes — the caller retries exactly the items it
                # never saw stream.
                live_ids = [i for i in ids
                            if failed is None or i not in failed]
                if live_ids:
                    on_chunk([(i, results[i]) for i in live_ids])

    flush.lock = lock  # appenders use the same lock
    return flush


class _FaultBoard:
    """Per-chunk device-error isolation + adaptive watchdog, shared by
    both fused engines.

    `failed` uses atomic set ops; `fault` fields are guarded by `lock`.
    wait_stage waits out one (stage-A future, ids) pair — and its
    chained stage-B future — under the watchdog: a timeout marks the
    device wedged (the zombie thread stays stuck on its pull, but the
    engine stops feeding it and fails the remaining items honestly
    instead of hanging the caller), and once wedged the remaining waits
    drop to a 2-second fast path so a deep queue cannot multiply the
    configured bound.

    The watchdog bound ADAPTS: while any first-time program dispatch is
    in flight (cold compile) or no chunk has completed yet, the full
    FENNEC_CHUNK_TIMEOUT
    ceiling applies; once warm, the bound drops to
    max(WATCHDOG_FLOOR, WATCHDOG_K × p95 of recent stage walls), so a
    wedge after warmup is detected in tens of seconds instead of 15
    minutes, with zero false positives on cold compiles (they hold the
    ceiling via cold_guard)."""

    def __init__(self, timeout_s):
        import threading

        self.lock = threading.Lock()
        self.failed: set = set()
        self.fault = {"consec": 0, "wedged": False, "last": None}
        self.timeout_s = timeout_s
        self._walls: List[float] = []
        self._seen: set = set()
        self._cold = 0

    # ── adaptive timeout ──

    def note_wall(self, dt: float) -> None:
        """Record one completed stage/chunk wall time (warm evidence)."""
        with self.lock:
            self._walls.append(dt)
            if len(self._walls) > 32:
                self._walls.pop(0)

    def cold_guard(self, key):
        """Context manager: marks a first-time program dispatch (likely
        XLA compile) in flight, holding the watchdog at the full
        ceiling; repeat keys are free."""
        import contextlib

        with self.lock:
            warm = key in self._seen
            self._seen.add(key)
            if not warm:
                self._cold += 1

        @contextlib.contextmanager
        def guard():
            try:
                yield
            finally:
                if not warm:
                    with self.lock:
                        self._cold -= 1

        return guard()

    def current_timeout(self):
        if self.timeout_s is None:
            return None
        with self.lock:
            if self.fault["wedged"]:
                return 2.0
            if self._cold > 0 or not self._walls:
                return self.timeout_s
            walls = sorted(self._walls)
            p95 = walls[min(len(walls) - 1,
                            int(0.95 * len(walls)))]
            return min(self.timeout_s,
                       max(WATCHDOG_FLOOR, WATCHDOG_K * p95))

    def wait_future(self, fut, what: str):
        """future.result() under the adaptive watchdog, re-evaluating
        the bound every few seconds (a cold compile finishing or a
        wedge flag raised mid-wait takes effect immediately).  Raises
        DeviceTimeoutError on expiry."""
        import time as _time

        start = _time.monotonic()
        while True:
            t = self.current_timeout()
            if t is None:
                return fut.result()
            rem = t - (_time.monotonic() - start)
            if rem <= 0:
                raise DeviceTimeoutError(
                    f"fennec: {what} exceeded the chunk watchdog "
                    f"({t:.0f}s bound, ceiling FENNEC_CHUNK_TIMEOUT="
                    f"{self.timeout_s:.0f}s) — device unresponsive")
            try:
                return fut.result(timeout=min(rem, 5.0))
            except concurrent.futures.TimeoutError:
                continue

    def drain(self, futs, what: str):
        """Concurrently wait out a batch of futures against ONE
        adaptive deadline; returns the set of futures that did NOT
        finish (marking the device wedged if any).  Replaces serial
        per-future timed waits (a late wedge in a large batch would
        pay len(futs) × bound sequentially)."""
        import time as _time

        pending_set = {f for f in futs if not f.done()}
        start = _time.monotonic()
        while pending_set:
            t = self.current_timeout()
            if t is None:
                concurrent.futures.wait(pending_set)
                return set()
            rem = t - (_time.monotonic() - start)
            if rem <= 0:
                break
            done, pending_set = concurrent.futures.wait(
                pending_set, timeout=min(rem, 5.0))
        if pending_set:
            with self.lock:
                self.fault["wedged"] = True
                if self.fault["last"] is None:
                    self.fault["last"] = DeviceTimeoutError(
                        f"fennec: {what} exceeded the chunk watchdog "
                        f"— device unresponsive")
        return pending_set

    # ── chunk bookkeeping ──

    def chunk_failed(self, ids, exc) -> None:
        with self.lock:
            self.failed.update(ids)
            self.fault["consec"] += 1
            self.fault["last"] = exc
        if os.environ.get("FENNEC_DEBUG_BATCH"):
            import sys
            import traceback

            if sys.exc_info()[0] is not None:
                traceback.print_exc()
            else:
                print(f"fennec: chunk marked failed: {exc!r}",
                      file=sys.stderr, flush=True)

    def item_failed(self, i, exc) -> None:
        with self.lock:
            self.failed.add(i)
            self.fault["last"] = exc

    def chunk_ok(self) -> None:
        with self.lock:
            self.fault["consec"] = 0

    def wait_stage(self, entry) -> None:
        fut, ids = entry
        try:
            bf = self.wait_future(fut, "chunk pull")
            if bf is not None:
                self.wait_future(bf, "chunk pull")
        except DeviceTimeoutError as exc:
            with self.lock:
                self.fault["wedged"] = True
            self.chunk_failed(ids, exc)


def _make_fault_board(timeout_s) -> _FaultBoard:
    return _FaultBoard(timeout_s)


def qualify_jpeg_bytes(data: bytes):
    """Fast-path qualification key for one JPEG: (w, h, in_subsample), or
    None when the coefficient path can't handle it (non-JPEG, progressive,
    unusual sampling, per-component chroma tables, multi-scan)."""
    from ..codecs import sniff_format
    from ..codecs.jpeg import is_progressive_jpeg, parse_jpeg

    if sniff_format(data) != "jpeg" or is_progressive_jpeg(data):
        return None
    try:
        hdr = parse_jpeg(data)
    except Exception:
        return None
    if hdr.ncomp != 3 or len(hdr.scan_comps) != 3:
        return None
    samp = [(c["h"], c["v"]) for c in hdr.comps]
    if samp == [(2, 2), (1, 1), (1, 1)]:
        in_sub = True
    elif samp == [(1, 1), (1, 1), (1, 1)]:
        in_sub = False
    else:
        return None
    if hdr.comps[1]["tq"] != hdr.comps[2]["tq"]:
        return None
    return (hdr.width, hdr.height, in_sub)


def compress_jpeg_bytes_batched(ctx: Optional[Context],
                                datas: List[bytes],
                                opts: Options,
                                on_chunk=None,
                                qualify_key=None,
                                workers: int = 0,
                                chunk_size: int = 0) -> \
        Optional[List[Result]]:
    """All-on-device JPEG→JPEG batch: host entropy-decodes inputs to
    coefficients, ships coefficients up, the device reconstructs pixels,
    runs the SSIM-guided search, and re-quantizes — pixels never cross the
    host↔device boundary.  The winning coefficients come back for host
    Huffman coding.

    Returns None when the inputs don't qualify (non-JPEG, progressive,
    mixed geometry, unusual sampling/tables) — callers fall back to the
    pixel path.  Requires opts.format == JPEG and no resize.

    on_chunk, when given, is called from the dispatch thread with
    [(index, Result), ...] as each chunk's results become final —
    streaming progress/writes for large batches instead of one burst at
    the end (the reference fires OnItem per completed item,
    batch.go:108-124).

    qualify_key: the shared (w, h, in_subsample) qualification key when
    the caller already ran qualify_jpeg_bytes per input and grouped by
    it (batch.py does) — skips a second header parse per file.

    chunk_size overrides FENNEC_BATCH_CHUNK (0 = default) — the
    device-fault backoff retries failed items at a smaller chunk.

    Fault isolation: a device error (XLA runtime error, pull timeout)
    in one chunk fails only that chunk's items; other chunks still
    stream via on_chunk.  Failed items are retried once internally at
    chunk 16; whatever still fails raises FusedChunkError AFTER all
    work finishes, so callers retry exactly the unstreamed items (the
    reference's pool never loses items on one worker's error,
    batch.go:58-128).  Two consecutive chunk failures or any pull
    timeout mark the device wedged: dispatching stops immediately and
    FusedChunkError.wedged tells callers not to touch the device again.
    """
    from ..codecs.jpeg import decode_jpeg_to_coefs
    from ..ops.resize import resize_weights, smart_resize_dims
    from ..parallel.batched import batched_decode_resize_search_quantize

    if opts.format != Format.JPEG:
        return None
    if opts.target_size > 0:
        return None
    if not datas:
        return []

    if qualify_key is None:
        keys = [qualify_jpeg_bytes(d) for d in datas]
        if keys[0] is None or any(k != keys[0] for k in keys):
            return None
        qualify_key = keys[0]
    w, h, in_sub = qualify_key
    target = opts.quality.target_ssim()
    if 0.0 < opts.target_ssim <= 1.0:
        target = opts.target_ssim
    subsample = bool(opts.subsample)

    # Optional on-device smart resize between decode and search.
    dst_w, dst_h = w, h
    rwh = rwv = None
    if opts.max_width > 0 or opts.max_height > 0:
        dst_w, dst_h = smart_resize_dims(w, h, opts.max_width,
                                         opts.max_height)
        if (dst_w, dst_h) != (w, h):
            wts = resize_weights(w, h, dst_w, dst_h)
            rwh, rwv = jnp.asarray(wts[0]), jnp.asarray(wts[1])

    n = len(datas)
    results: List[Result] = [
        Result(original_dimensions=(w, h), final_dimensions=(dst_w, dst_h),
               format=Format.JPEG) for _ in range(n)]

    nworkers = workers if workers > 0 else min(16, os.cpu_count() or 4)
    pool = concurrent.futures.ThreadPoolExecutor(nworkers)
    timer = _batch_timer()
    pending = []
    ledger: List = []  # (chunk_ids, futures) per dispatched chunk

    timeout_s = CHUNK_TIMEOUT if CHUNK_TIMEOUT > 0 else None
    board = _make_fault_board(timeout_s)
    flock, failed, fault = board.lock, board.failed, board.fault
    _chunk_failed, _item_failed = board.chunk_failed, board.item_failed
    _chunk_ok, _wait_stage = board.chunk_ok, board.wait_stage

    _flush_ledger = _make_ledger_flush(ledger, results, on_chunk, ctx,
                                       board=board)

    # Multi-device: shard every chunk's batch axis over all local devices
    # (the device CompressBatch parallelism, batch.go:58-128).
    from ..parallel.batched import data_mesh, shard_data_call

    mesh = data_mesh()
    if opts.device_entropy is None:
        use_device_entropy = rwh is None and device_entropy_default()
    else:
        use_device_entropy = (opts.device_entropy and rwh is None)
    inflight = []

    def _overflow_redo(i: int, res: Result) -> None:
        """Word-capacity overflow (pathological content or the Q=100
        fallback inflating past the input size): redo this one image
        through the per-image engine.  A device error here fails ONLY
        this item; a wedged device skips the dispatch entirely."""
        from ..api import compress_bytes
        from ..types import CanceledError

        if fault["wedged"]:
            _item_failed(i, fault["last"])
            return
        try:
            # The first redo compiles the per-image programs — hold
            # the watchdog at its cold ceiling while it does.
            with board.cold_guard(("item-redo",)):
                r = compress_bytes(ctx, datas[i], opts)
        except CanceledError:
            raise
        except Exception as e:
            if _is_device_error(e):
                _item_failed(i, e)
                return
            raise
        results[i] = r
        results[i].original_dimensions = res.original_dimensions

    def _collect_emit(chunk_ids, handles):
        """Pull a device-entropy chunk: the scan bitstream was assembled
        on device; the host only 1-pads, byte-stuffs, and wraps.  The
        whole chunk output (q/ssim/found/bits + words) is ONE packed
        uint32 array — one device→host pull.  emit_words is sized from
        the LARGEST INPUT file, so a chunk of big JPEGs can pad the
        buffer far past the re-encoded outputs: above the same 8 MB
        guard pull_emit_words uses, the small columns come down first
        and the word pull is sliced to the chunk's actual extent."""
        from ..ops.jpeg_emit import finalize_scan_host
        from ..parallel.batched import split_emit_full

        b = handles.shape[0]
        if (emit_words + 4) * b * 4 <= (8 << 20):
            q_host, s_host, f_host, bits_h, words_h = split_emit_full(
                np.asarray(handles))
        else:
            head = np.asarray(handles[:, :4])
            q_host = head[:, 0].astype(np.int32)
            s_host = np.ascontiguousarray(head[:, 1]).view(np.float32)
            f_host = head[:, 2] != 0
            bits_h = head[:, 3].astype(np.int64)
            used = min(int(bits_h.max()) // 32 + 2, emit_words)
            words_h = np.asarray(handles[:, 4:4 + used])

        def emit_one(i: int, j: int) -> None:
            res = results[i]
            if int(bits_h[j]) + 64 > emit_words * 32:
                return _overflow_redo(i, res)
            quality = int(q_host[j])
            ssim_val = float(s_host[j])
            if not bool(f_host[j]):
                quality, ssim_val = 100, 1.0
            scan = finalize_scan_host(words_h[j], int(bits_h[j]))
            data = assemble_jpeg(dst_w, dst_h,
                                 all_quality_tables()[quality],
                                 scan, subsample)
            res.jpeg_quality = quality
            res.ssim = ssim_val
            res.compressed_data = data
            res.compressed_size = len(data)
            res.compute_stats()

        futs = [pool.submit(emit_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    def _collect_opt_fused(chunk_ids, handles):
        """Pull a FUSED optimal-Huffman chunk (flavor "opt"): the device
        built the K.2 tables itself and emitted with them, so the ONE
        packed pull carries q/ssim/found/bits, the DHT specs, and the
        scan words.  Same 8 MB guard as _collect_emit: oversized buffers
        pull the header first and slice the words to the chunk's actual
        bit extent."""
        from ..codecs.jpeg import _dht_segment_custom
        from ..ops.jpeg_emit import finalize_scan_host
        from ..parallel.batched import (
            OPT_HDR,
            specs_from_opt_header,
            split_opt_header,
        )

        b = handles.shape[0]
        with _tstage(timer, "opt: packed pull"):
            if (OPT_HDR + emit_words) * b * 4 <= (8 << 20):
                wb_h = np.asarray(handles)
                hdr, words_h = wb_h[:, :OPT_HDR], wb_h[:, OPT_HDR:]
            else:
                hdr = np.asarray(handles[:, :OPT_HDR])
                bmax = int(hdr[:, 3].astype(np.int64).max())
                used = min(bmax // 32 + 2, emit_words)
                words_h = np.asarray(
                    handles[:, OPT_HDR:OPT_HDR + used])
        (q_host, s_host, f_host, bits_h, ovf, bits16, nvals,
         vals) = split_opt_header(hdr)

        def emit_one(i: int, j: int) -> None:
            res = results[i]
            # K.2 >32-bit code (host builder raises the canonical
            # ValueError) or word-capacity overflow: redo on host.
            if bool(ovf[j]) or int(bits_h[j]) + 64 > emit_words * 32:
                return _overflow_redo(i, res)
            quality = int(q_host[j])
            ssim_val = float(s_host[j])
            if not bool(f_host[j]):
                quality, ssim_val = 100, 1.0
            scan = finalize_scan_host(words_h[j], int(bits_h[j]))
            dht = _dht_segment_custom(
                *specs_from_opt_header(bits16, nvals, vals, j))
            data = assemble_jpeg(dst_w, dst_h,
                                 all_quality_tables()[quality],
                                 scan, subsample, dht=dht)
            res.jpeg_quality = quality
            res.ssim = ssim_val
            res.compressed_data = data
            res.compressed_size = len(data)
            res.compute_stats()

        futs = [pool.submit(emit_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    def _stage_a_opt(chunk_ids, handles):
        """Stage A of the optimal-Huffman pipeline: pull the SMALL search
        outputs + symbol histograms (blocks only until the search kernel
        finishes), build per-image K.2 tables on the host pool, and
        dispatch the stage-2 emission on the RESIDENT coefficients.  The
        words pull + container wrap happen one pipeline stage later
        (stage B), overlapped with the next chunk's search."""
        from ..codecs.huffopt import specs_and_tables_batch
        from ..parallel.batched import (
            batched_emit_custom,
            split_search_small,
        )

        small, packed = handles
        # ONE pull for everything host-visible (q/ssim/found/bits_std +
        # both histograms) — the round-trip latency dwarfs the bytes.
        with _tstage(timer, "A: small pull"):
            (q_host, s_host, f_host, bstd, dcf,
             acf) = split_search_small(np.asarray(small))
        # Exact sizing: optimal tables never beat the standard-table bit
        # count they're built against, so overflow is impossible.
        opt_words = emit_words_for_bits(int(bstd.max()))

        # One C call builds every image's K.2 specs; the packed device
        # code tables come from one vectorized canonical-code pass (the
        # per-image Python loop was the single-core host's largest term).
        with _tstage(timer, "A: K.2 tables"):
            specs, dc_tabs, ac_tabs = specs_and_tables_batch(
                dcf.astype(np.int64), acf.astype(np.int64))

        with _tstage(timer, "A: emit dispatch"):
            from ..ops import jpeg_emit as _je

            lw = _je.EMIT_LWORDS
            tables = np.concatenate([dc_tabs, ac_tabs], axis=2)
            # First dispatch of a new emission width compiles — hold
            # the watchdog at its cold ceiling for its duration.
            key = ("emitc", tuple(getattr(packed, "shape", ())),
                   opt_words, lw)
            with board.cold_guard(key):
                if mesh is not None:
                    wb = shard_data_call(
                        mesh, ("emit_custom", h, w, subsample,
                               opt_words, lw),
                        lambda p, tb: batched_emit_custom(
                            p, tb, h, w, subsample, opt_words, lw),
                        packed, tables)
                else:
                    wb = batched_emit_custom(packed,
                                             jnp.asarray(tables),
                                             h, w, subsample,
                                             opt_words, lw)
        return (chunk_ids, (q_host, s_host, f_host, specs, wb,
                            opt_words))

    def _stage_b_opt(chunk_ids, state):
        """Stage B: pull the emitted words and wrap containers.  Images
        whose blocks outgrew the optimistic per-block emit buffer
        (blk_ovf — exact flag, rare on real content) redo through the
        per-image engine like word-capacity overflows."""
        from ..codecs.jpeg import _dht_segment_custom
        from ..ops.jpeg_emit import finalize_scan_host
        from ..parallel.batched import pull_emit_words

        q_host, s_host, f_host, specs, wb, opt_words = state
        words_h, bits_h, bovf = pull_emit_words(wb, opt_words)

        def emit_one(i: int, j: int) -> None:
            res = results[i]
            if bool(bovf[j]):
                return _overflow_redo(i, res)
            quality = int(q_host[j])
            ssim_val = float(s_host[j])
            if not bool(f_host[j]):
                quality, ssim_val = 100, 1.0
            scan = finalize_scan_host(words_h[j], int(bits_h[j]))
            dht = _dht_segment_custom(*specs[j])
            data = assemble_jpeg(dst_w, dst_h,
                                 all_quality_tables()[quality],
                                 scan, subsample, dht=dht)
            res.jpeg_quality = quality
            res.ssim = ssim_val
            res.compressed_data = data
            res.compressed_size = len(data)
            res.compute_stats()

        futs = [pool.submit(emit_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    def _collect(entry):
        """Pull a dispatched chunk's results and queue host encodes."""
        from ..parallel.batched import packed_to_int8, split_packed

        kind, chunk_ids, handles = entry
        if kind == "emit":
            return _collect_emit(chunk_ids, handles)
        if kind == "optf":
            return _collect_opt_fused(chunk_ids, handles)
        if kind == "opt":
            return _stage_b_opt(*_stage_a_opt(chunk_ids, handles))
        (qs, ssims, found, packed, fits8) = handles
        q_host = np.asarray(qs)
        s_host = np.asarray(ssims)
        f_host = np.asarray(found)
        # fits8 is a scalar on the unsharded path, a per-image vector on
        # the mesh path (shard_map outputs can't mix per-shard scalars).
        if bool(np.asarray(fits8).all()):
            packed_h = np.asarray(packed_to_int8(packed))
        else:
            packed_h = np.asarray(packed)
        qy_h, qcb_h, qcr_h, ph, pw = split_packed(packed_h, dst_h, dst_w,
                                                  subsample)

        def encode_one(i: int, j: int) -> None:
            res = results[i]
            quality = int(q_host[j])
            ssim_val = float(s_host[j])
            if not bool(f_host[j]):
                quality, ssim_val = 100, 1.0
            if opts.optimize_huffman:
                scan, dht = encode_scan_optimized(
                    np.asarray(qy_h[j]), np.asarray(qcb_h[j]),
                    np.asarray(qcr_h[j]), ph, pw, subsample)
                data = assemble_jpeg(dst_w, dst_h,
                                     all_quality_tables()[quality],
                                     scan, subsample, dht=dht)
            else:
                scan = encode_scan_from_quantized(
                    np.asarray(qy_h[j]), np.asarray(qcb_h[j]),
                    np.asarray(qcr_h[j]), ph, pw, subsample)
                data = assemble_jpeg(dst_w, dst_h,
                                     all_quality_tables()[quality],
                                     scan, subsample)
            res.jpeg_quality = quality
            res.ssim = ssim_val
            res.compressed_data = data
            res.compressed_size = len(data)
            res.compute_stats()

        futs = [pool.submit(encode_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    # Input MCU geometry — the flat int8 upload layout.
    mult_in = 16 if in_sub else 8
    phi, pwi = h + (-h) % mult_in, w + (-w) % mult_in
    nyi = (phi // 8) * (pwi // 8)
    nci = (phi // 16) * (pwi // 16) if in_sub else nyi
    nt = nyi + 2 * nci

    def _pack_exceptions(exc_parts, padded, extra=None):
        """Merge per-file exception lists (+ optional COO overflow
        triple) into padded (ej, ei, ev) arrays; rows with img == padded
        are out of bounds → dropped by the device scatter."""
        ejs = [np.full(p[0].shape, j, np.int32)
               for j, p in enumerate(exc_parts)]
        eis = [p[0] for p in exc_parts]
        evs = [p[1] for p in exc_parts]
        if extra is not None:
            ejs.append(extra[0])
            eis.append(extra[1])
            evs.append(extra[2])
        ej = np.concatenate(ejs)
        ei = np.concatenate(eis).astype(np.int32)
        ev = np.concatenate(evs)
        pad = _next_pow2(max(int(ei.size), 1))
        if pad != ei.size:
            ej = np.concatenate(
                [ej, np.full(pad - ej.size, padded, np.int32)])
            ei = np.concatenate(
                [ei, np.zeros(pad - ei.size, np.int32)])
            ev = np.concatenate([ev, np.zeros(pad - ev.size, np.int16)])
        return ej, ei, ev

    def _pack_tail(buf, o, padded, qts, ej, ei, ev):
        e = int(ej.size)
        buf[o:o + padded * 128] = qts.reshape(-1)
        o += padded * 128
        buf[o:o + e] = ej
        buf[o + e:o + 2 * e] = ei
        buf[o + 2 * e:o + 3 * e] = ev.astype(np.int32)
        o += 3 * e
        buf[o:] = np.full(padded, target, np.float32).view(np.int32)

    def _prep_chunk_dense(chunk, padded):
        """Dense upload path: decode into a (padded, NT, 64) int8
        ZIGZAG-order buffer with sparse exceptions — one C++ pass per
        file — then truncate to the chunk's maximum nonzero zigzag
        extent (photo blocks end early in zigzag order)."""
        from ..codecs.jpeg import decode_jpeg_to_coefs_i8
        from ..ops.dct import ZIGZAG

        i8 = np.zeros((padded, nt, 64), np.int8)
        qts = np.zeros((padded, 2, 64), np.int32)
        exc_parts: List = [None] * len(chunk)
        maxks = [1] * len(chunk)

        def one(j: int) -> None:
            # Exception offsets are IMAGE-LOCAL (flat_base=0): a flat
            # whole-chunk index (j·NT·64 bias) overflows int32 once
            # B·NT·64 > 2^31 (≈24MP × 64-deep chunks) and the device
            # scatter would silently drop the wrapped entries.
            r = decode_jpeg_to_coefs_i8(datas[chunk[j]],
                                        i8[j].reshape(-1), 0)
            if r is not None:
                hdr, ei, ev, mk = r
            else:  # dense fallback: exception-heavy or unusual file
                hdr, coefs = decode_jpeg_to_coefs(datas[chunk[j]])
                zz = np.concatenate(
                    [np.asarray(c, np.int16)[:, ZIGZAG] for c in coefs])
                f16 = zz.reshape(-1)
                big = np.abs(f16) > 127
                ei = np.nonzero(big)[0].astype(np.int32)
                ev = f16[big]
                f16 = f16.copy()
                f16[big] = 0
                i8[j] = f16.astype(np.int8).reshape(nt, 64)
                nzc = np.nonzero(np.any(zz != 0, axis=0))[0]
                mk = int(nzc[-1]) + 1 if nzc.size else 1
            qts[j] = np.stack(
                [hdr.qtables[hdr.comps[0]["tq"]],
                 hdr.qtables[hdr.comps[1]["tq"]]]).astype(np.int32)
            exc_parts[j] = (ei, ev)
            maxks[j] = mk

        list(pool.map(one, range(len(chunk))))
        # Truncate trailing all-zero zigzag columns, bucketed to bound
        # recompiles; exception offsets remap to the narrow layout.
        kk = max(maxks)
        kk = min(64, ((kk + 15) // 16) * 16)
        if kk < 64:
            i8 = np.ascontiguousarray(i8[:, :, :kk])
        ej, ei, ev = _pack_exceptions(exc_parts, padded)
        if kk < 64 and ei.size:
            live = ej < padded
            ei[live] = (ei[live] // 64) * kk + (ei[live] % 64)
        # Pack EVERYTHING (coefficients, qtables, exceptions, targets)
        # into ONE int32 buffer — each uploaded array costs a host→device
        # round-trip, so six uploads become one (device side:
        # parallel.batched.unpack_chunk_buf).
        n0 = i8.size // 4  # kk is a multiple of 16 → size % 4 == 0
        e = int(ej.size)
        buf = np.empty(n0 + padded * 128 + 3 * e + padded, np.int32)
        buf[:n0] = i8.reshape(-1).view(np.int32)
        _pack_tail(buf, n0, padded, qts, ej, ei, ev)
        return "i8", buf, i8.shape[2], e

    _COO_RCAP = 16

    def _prep_chunk_csr(chunk, padded, dcp, posp, valp, qts, exc_parts):
        """Variable-length (CSR) upload: per-block counts + the exact
        (position, value) pair streams, ordered by (image, block, scan
        order).  ~2× fewer bytes than the best fixed-R COO layout on
        photographic content; the device re-expands to slots with one
        sorted window-gather (parallel.batched._csr_to_slots).

        Byte layout: [dc (B·NT) | counts (B·NT) | spos (M) | sval (M) |
        pad] + int32 [qts | base (B) | ej | ei | ev | targets]."""
        rcap = posp.shape[2]
        occ = posp != 0  # filled slots are a prefix per block
        counts = occ.sum(axis=2, dtype=np.int32)  # (padded, nt)
        per_img = counts.sum(axis=1)
        base = (np.cumsum(per_img) - per_img).astype(np.int32)
        total = int(per_img.sum())
        m = _next_pow2(max(total, 1))
        flat = occ.reshape(-1, rcap)
        spos = np.zeros(m, np.int8)
        sval = np.zeros(m, np.int8)
        spos[:total] = posp.reshape(-1, rcap)[flat].view(np.int8)
        sval[:total] = valp.reshape(-1, rcap)[flat]
        # r_active: pow2-bucketed max per-block occupancy — the static
        # slot width the device expansion re-creates (≤ rcap).
        r_active = _next_pow2(max(int(counts.max()), 1))

        ej, ei, ev = _pack_exceptions(exc_parts, padded)
        e = int(ej.size)
        nb = 2 * padded * nt + 2 * m
        w0 = (nb + 3) // 4
        buf = np.zeros(w0 + padded * 128 + padded + 3 * e + padded,
                       np.int32)
        bview = buf[:w0].view(np.int8)
        bview[:padded * nt] = dcp.reshape(-1)
        bview[padded * nt:2 * padded * nt] = \
            counts.astype(np.int8).reshape(-1)
        bview[2 * padded * nt:2 * padded * nt + m] = spos
        bview[2 * padded * nt + m:nb] = sval
        o = w0
        buf[o:o + padded * 128] = qts.reshape(-1)
        o += padded * 128
        buf[o:o + padded] = base
        o += padded
        buf[o:o + e] = ej
        buf[o + e:o + 2 * e] = ei
        buf[o + 2 * e:o + 3 * e] = ev.astype(np.int32)
        o += 3 * e
        buf[o:] = np.full(padded, target, np.float32).view(np.int32)
        return "csr", buf, (r_active, m), e

    # Sticky COO geometry across chunks: once the first chunk's census
    # picks the byte-optimal slot width R (and sizes the exception
    # tail), later chunks allocate the FINAL int32 upload buffer up
    # front and the C++ decoder writes the COO body straight into it at
    # stride R — no slot demotion, no narrowing copies, no 6 MB
    # assembly memcpys: it removes the numpy half of the feeder's
    # decode+pack.
    # Guarded by `slock`: two feeder threads prep chunks concurrently.
    sticky = {"r": 0, "ecap": 0}
    import threading as _threading

    slock = _threading.Lock()

    def _prep_chunk_coo_sticky(chunk, padded, r, ecap):
        """Fast COO prep at a known slot width: decode directly into
        the upload buffer.  Returns None when a file rejects the COO
        decoder or the exception tail overflows ecap — caller falls
        back to the census path."""
        from ..codecs.jpeg import decode_jpeg_to_coefs_coo

        nb = padded * nt * (1 + 2 * r)
        w0 = (nb + 3) // 4
        buf = np.zeros(w0 + padded * 128 + 3 * ecap + padded, np.int32)
        bview = buf[:w0].view(np.int8)
        dcp = bview[:padded * nt].reshape(padded, nt)
        posp = bview[padded * nt:padded * nt * (1 + r)] \
            .view(np.uint8).reshape(padded, nt, r)
        valp = bview[padded * nt * (1 + r):nb].reshape(padded, nt, r)
        qts = np.zeros((padded, 2, 64), np.int32)
        exc_parts: List = [None] * len(chunk)
        hists = np.zeros((len(chunk), 65), np.int64)
        failed_f = [False]

        def one(j: int) -> None:
            rr = decode_jpeg_to_coefs_coo(datas[chunk[j]], dcp[j],
                                          posp[j], valp[j], r)
            if rr is None:
                failed_f[0] = True
                return
            hdr, ei, ev, hist, _mk = rr
            qts[j] = np.stack(
                [hdr.qtables[hdr.comps[0]["tq"]],
                 hdr.qtables[hdr.comps[1]["tq"]]]).astype(np.int32)
            exc_parts[j] = (ei, ev)
            hists[j] = hist

        list(pool.map(one, range(len(chunk))))
        if failed_f[0]:
            return None
        total_e = sum(int(p[0].size) for p in exc_parts)
        if total_e > ecap:
            with slock:
                sticky["ecap"] = _next_pow2(2 * total_e)
            return None  # rare: rebuild via the census path this once
        o = w0
        buf[o:o + padded * 128] = qts.reshape(-1)
        o += padded * 128
        # Exception tail at fixed capacity; unused rows carry
        # img == padded → dropped by the device scatter's mode="drop".
        buf[o:o + ecap] = padded
        pos = 0
        for j, (ei, ev) in enumerate(exc_parts):
            k = int(ei.size)
            buf[o + pos:o + pos + k] = j
            buf[o + ecap + pos:o + ecap + pos + k] = ei
            buf[o + 2 * ecap + pos:o + 2 * ecap + pos + k] = ev
            pos += k
        o += 3 * ecap
        buf[o:] = np.full(padded, target, np.float32).view(np.int32)
        # Keep R tracking content drift: re-pick from this chunk's
        # census for the NEXT chunk (this chunk's exceptions already
        # absorbed any mismatch exactly).
        with slock:
            sticky["r"] = _best_coo_r(hists.sum(axis=0))
        return "coo", buf, r, ecap

    def _best_coo_r(hist):
        """Byte-optimal fixed slot width for a chunk census (hist[k] =
        blocks with k slot-eligible AC nonzeros)."""
        ks = np.arange(65)
        best_r, best_bytes = _COO_RCAP, None
        for r_ in (2, 4, 6, 8, 12, 16):
            over = int((ks - r_).clip(0).dot(hist))
            bytes_ = padded_hint[0] * nt * (1 + 2 * r_) + 12 * over
            if best_bytes is None or bytes_ < best_bytes:
                best_r, best_bytes = r_, bytes_
        return best_r

    padded_hint = [_next_pow2(min(chunk_size if chunk_size > 0
                                  else BATCH_CHUNK, max(n, 1)))]

    def _prep_chunk_i8(chunk, padded):
        """Decode a chunk's files into the smaller of two single-buffer
        upload formats (fewer upload bytes):

        - "coo": DC int8 plane + per-block (zigzag position, int8 value)
          AC-nonzero pairs padded to R slots, written DIRECTLY by the
          C++ entropy decoder (photo content is ~92% zeros at typical
          qualities → ~2.5× smaller than dense); |v| > 127 and slot
          overflow ride the exception list;
        - "i8": the dense zigzag-truncated layout (_prep_chunk_dense),
          kept for noisy/dense content where COO would not pay and as
          the fallback when any file rejects the COO decoder.

        After the first chunk, same-geometry chunks take the sticky
        zero-copy path above (same output layout, bytes differ only in
        slot width / exception padding — both device-dropped).
        """
        from ..codecs.jpeg import decode_jpeg_to_coefs_coo
        from ..native import native_available

        if not native_available() or not COO_UPLOADS:
            return _prep_chunk_dense(chunk, padded)

        padded_hint[0] = padded
        with slock:
            r_sticky, ecap_sticky = sticky["r"], sticky["ecap"]
        if (r_sticky > 0 and not os.environ.get("FENNEC_UPLOAD")
                and mesh is None):
            out = _prep_chunk_coo_sticky(chunk, padded, r_sticky,
                                         ecap_sticky)
            if out is not None:
                return out

        rcap = _COO_RCAP
        dcp = np.zeros((padded, nt), np.int8)
        posp = np.zeros((padded, nt, rcap), np.uint8)
        valp = np.zeros((padded, nt, rcap), np.int8)
        qts = np.zeros((padded, 2, 64), np.int32)
        exc_parts: List = [None] * len(chunk)
        hists = np.zeros((len(chunk), 65), np.int64)
        maxks = [1] * len(chunk)
        failed = [False]

        def one(j: int) -> None:
            r = decode_jpeg_to_coefs_coo(datas[chunk[j]], dcp[j],
                                         posp[j], valp[j], rcap)
            if r is None:
                failed[0] = True
                return
            hdr, ei, ev, hist, mk = r
            qts[j] = np.stack(
                [hdr.qtables[hdr.comps[0]["tq"]],
                 hdr.qtables[hdr.comps[1]["tq"]]]).astype(np.int32)
            exc_parts[j] = (ei, ev)
            hists[j] = hist
            maxks[j] = mk

        list(pool.map(one, range(len(chunk))))
        if failed[0]:
            # Any COO-rejected file (unusual scan, exception overflow):
            # the whole chunk re-decodes through the dense path, which
            # has per-file Python fallbacks.
            return _prep_chunk_dense(chunk, padded)

        # Pick R minimizing upload bytes; compare against the dense
        # estimate.  hist[k] counts blocks with k slot-eligible AC
        # nonzeros (capped contributions at rcap — deeper spills are
        # exceptions under every R).
        hist = hists.sum(axis=0)
        ks = np.arange(65)
        kk = min(64, ((max(maxks) + 15) // 16) * 16)
        best_r, best_bytes = rcap, None
        for r_ in (2, 4, 6, 8, 12, 16):
            # Every slot-eligible nonzero beyond r_ becomes a 12-byte
            # exception row in the COO buffer (including the > rcap
            # spills the C++ decoder already diverted) but is FREE in
            # the dense layout — charge them all.
            over = int((ks - r_).clip(0).dot(hist))
            bytes_ = padded * nt * (1 + 2 * r_) + 12 * over
            if best_bytes is None or bytes_ < best_bytes:
                best_r, best_bytes = r_, bytes_
        # CSR (FENNEC_UPLOAD=csr, OPT-IN): each block ships its exact
        # pairs (+1 count byte) instead of fixed R slots — ~2× fewer
        # upload bytes on photographic content (mean ≈ 3 nonzeros/block
        # vs best fixed R ≈ 6).  Chunk uploads already overlap device
        # compute in the 3-stage pipeline, so the saved bytes buy little
        # wall time, while the device-side slot expansion adds straight
        # to the serial device path.  Not yet measured on the GPU.
        force = os.environ.get("FENNEC_UPLOAD", "")
        if force == "dense" or (not force
                                and best_bytes >= 0.85 * padded * nt * kk):
            return _prep_chunk_dense(chunk, padded)
        if force == "csr":
            return _prep_chunk_csr(chunk, padded, dcp, posp, valp, qts,
                                   exc_parts)
        r = best_r

        extra = None
        if r < rcap:
            # Demote slots ≥ R to the exception list, then narrow.
            bi, ni, si = np.nonzero(posp[:, :, r:])
            if bi.size:
                pdem = posp[bi, ni, si + r].astype(np.int32)
                extra = (bi.astype(np.int32),
                         (ni.astype(np.int64) * 64
                          + pdem).astype(np.int32),
                         valp[bi, ni, si + r].astype(np.int16))
            posp = np.ascontiguousarray(posp[:, :, :r])
            valp = np.ascontiguousarray(valp[:, :, :r])

        ej, ei, ev = _pack_exceptions(exc_parts, padded, extra)
        e = int(ej.size)
        nb = padded * nt * (1 + 2 * r)
        w0 = (nb + 3) // 4
        buf = np.zeros(w0 + padded * 128 + 3 * e + padded, np.int32)
        bview = buf[:w0].view(np.int8)
        bview[:padded * nt] = dcp.reshape(-1)
        bview[padded * nt:padded * nt * (1 + r)] = posp.reshape(-1)
        bview[padded * nt * (1 + r):nb] = valp.reshape(-1)
        _pack_tail(buf, w0, padded, qts, ej, ei, ev)
        # Arm the sticky zero-copy path for the following chunks: this
        # chunk's census R, an exception tail with 2× headroom (floor
        # 2048 rows; a pinned capacity also pins the compiled program's
        # shape across chunks).
        with slock:
            sticky["r"] = r
            if sticky["ecap"] == 0:
                sticky["ecap"] = max(_next_pow2(2 * e), 2048)
        return "coo", buf, r, e

    if use_device_entropy:
        # Word capacity: the winner is (re)quantized at most at the
        # input's quality, so the input scan bounds the typical output;
        # the rare overflow (Q=100 fallback on noisy content) is caught
        # per image in _collect_emit and redone host-side.
        mult = 16 if subsample else 8
        ph = h + (-h) % mult
        pw = w + (-w) % mult
        n_blocks = ((ph // 8) * (pw // 8)
                    + 2 * ((ph // 16) * (pw // 16)
                           if subsample else (ph // 8) * (pw // 8)))
        biggest = max(len(d) for d in datas)
        # Cap: bit counts ride int32 with bit 31 reserved for the
        # optimistic-lwords overflow flag (pull_emit_words), so the
        # word buffer must stay under 2^31 bits.  Images whose scans
        # genuinely exceed the cap (a >256 MB entropy stream) redo per
        # image via the exact bits check.
        emit_words = min(_next_pow2(biggest // 4 + 1024),
                         n_blocks * 53 + 64, (1 << 26) - 64)

    chunk_sz = chunk_size if chunk_size > 0 else BATCH_CHUNK
    starts = list(range(0, n, chunk_sz))

    if rwh is not None:
        # Resize path: dense int16 stacks, decoded PER CHUNK on the
        # worker pool and prefetched two deep by a feeder thread — a
        # whole-batch up-front decode would hold every input's
        # coefficients in host RAM at once and serialize the decode.
        def _make_chunk_dense(start):
            chunk = list(range(start, min(start + chunk_sz, n)))
            b = len(chunk)
            padded = _next_pow2(b)
            parts: List = [None] * b

            def one(j: int) -> None:
                hdr, coefs = decode_jpeg_to_coefs(datas[chunk[j]])
                qt = np.stack(
                    [hdr.qtables[hdr.comps[0]["tq"]],
                     hdr.qtables[hdr.comps[1]["tq"]]]).astype(np.int32)
                parts[j] = (coefs, qt)

            list(pool.map(one, range(b)))
            ys = np.stack([parts[j % b][0][0] for j in range(padded)])
            cbs = np.stack([parts[j % b][0][1] for j in range(padded)])
            crs = np.stack([parts[j % b][0][2] for j in range(padded)])
            qts = np.stack([parts[j % b][1] for j in range(padded)])
            targets = jnp.asarray(
                np.full((padded,), target, dtype=np.float32))
            return (chunk, padded, jnp.asarray(ys), jnp.asarray(cbs),
                    jnp.asarray(crs), jnp.asarray(qts), targets)

        feeder = concurrent.futures.ThreadPoolExecutor(2)
        futs = [feeder.submit(_make_chunk_dense, s)
                for s in starts[:PREFETCH]]
        try:
            for i in range(len(starts)):
                if ctx is not None:
                    ctx.raise_if_done()
                (chunk, padded, ys, cbs, crs, qts,
                 targets) = futs[i].result()
                futs[i] = None
                if i + PREFETCH < len(starts):
                    futs.append(feeder.submit(_make_chunk_dense,
                                              starts[i + PREFETCH]))
                handles = batched_decode_resize_search_quantize(
                    ys, cbs, crs, qts, h, w, in_sub, subsample,
                    resize_wh=rwh, resize_wv=rwv, targets=targets)
                inflight.append(("quant", chunk, handles))
                if len(inflight) >= 2:
                    _collect(inflight.pop(0))
                _flush_ledger(False)
            while inflight:
                _collect(inflight.pop(0))
            board.drain(pending, "item redo")
            _flush_ledger(True)
        finally:
            # Cancellation/exception must not leak feeder decodes or
            # encode workers still writing results after the call has
            # raised: queued futures are cancelled, in-flight ones
            # complete before we return.
            feeder.shutdown(wait=True, cancel_futures=True)
            pool.shutdown(wait=True, cancel_futures=True)
        return results

    # ── Pipelined no-resize path ──
    # Five overlapped actors around the single device FIFO:
    #   feeder threads (2) : C++ decode into the packed upload buffer +
    #                        the host→device copy for chunk k+2;
    #   dispatch thread    : unpack + search dispatch only (async RPCs),
    #                        plus the FIFO ledger flush;
    #   stage-A thread     : pull the packed small search outputs, build
    #                        optimal tables, upload them, dispatch the
    #                        stage-2 emission on resident coefficients;
    #   stage-B thread     : pull emitted words, queue byte-stuff + wrap
    #                        on the worker pool.
    # Stage A and B each BLOCK on one device round-trip per chunk;
    # running them on their own executors keeps those waits off the
    # dispatch thread, so the
    # critical path drops to max(feeder, stage A, stage B) instead of
    # their sum.  Single-thread executors preserve chunk order.

    def _upload_sharded(fmt, buf, meta, e, padded):
        """Mesh path: split the flat upload buffer host-side and place
        each section with its sharding — batch-leading sections split
        over 'data', the flat cross-image exception lists replicated
        (their image indices are globally addressed; the shard_map
        wrappers rebase them per shard and let mode="drop" discard
        other shards' rows)."""
        from jax.sharding import NamedSharding, PartitionSpec as _P

        dsh = NamedSharding(mesh, _P("data"))
        rsh = NamedSharding(mesh, _P())
        repl = ()
        if fmt == "csr":
            r_active, m = meta
            nb = 2 * padded * nt + 2 * m
            w0 = (nb + 3) // 4
            by = buf[:w0].view(np.int8)
            lead = (by[:padded * nt].reshape(padded, nt),
                    by[padded * nt:2 * padded * nt]
                    .reshape(padded, nt))
            # The pair streams are variable-length per image and carry
            # GLOBAL offsets (base) — replicate them; each shard reads
            # only its images' windows.
            repl = (by[2 * padded * nt:2 * padded * nt + m],
                    by[2 * padded * nt + m:nb])
            o = w0
        elif fmt == "coo":
            r = meta
            nb = padded * nt * (1 + 2 * r)
            w0 = (nb + 3) // 4
            by = buf[:w0].view(np.int8)
            lead = (by[:padded * nt].reshape(padded, nt),
                    by[padded * nt:padded * nt * (1 + r)]
                    .reshape(padded, nt, r),
                    by[padded * nt * (1 + r):nb].reshape(padded, nt, r))
            o = w0
        else:
            k = meta
            n0 = padded * nt * k // 4
            lead = (buf[:n0].view(np.int8).reshape(padded, nt, k),)
            o = n0
        qts = buf[o:o + padded * 128].reshape(padded, 2, 64)
        o += padded * 128
        base = None
        if fmt == "csr":
            base = buf[o:o + padded]
            o += padded
        ej = buf[o:o + e]
        ei = buf[o + e:o + 2 * e]
        ev = buf[o + 2 * e:o + 3 * e]
        o += 3 * e
        tgt = buf[o:o + padded].view(np.float32)
        parts = [jax.device_put(np.ascontiguousarray(a), dsh)
                 for a in lead]
        if base is not None:
            parts.append(jax.device_put(np.ascontiguousarray(base), dsh))
        parts.extend(jax.device_put(np.ascontiguousarray(x), rsh)
                     for x in repl)
        parts.append(jax.device_put(np.ascontiguousarray(qts), dsh))
        parts.append(jax.device_put(np.ascontiguousarray(tgt), dsh))
        parts.extend(jax.device_put(np.ascontiguousarray(x), rsh)
                     for x in (ej, ei, ev))
        return tuple(parts)

    def _make_chunk(start):
        with _tstage(timer, "prep + upload (feeder)"):
            chunk = list(range(start, min(start + chunk_sz, n)))
            padded = _next_pow2(len(chunk))
            if mesh is not None:  # shards need equal batch slices
                padded = -(-padded // mesh.size) * mesh.size
            with _tstage(timer, "feeder: decode+pack"):
                fmt, buf, meta, e = _prep_chunk_i8(chunk, padded)
            if mesh is not None:
                return (fmt, chunk, padded,
                        _upload_sharded(fmt, buf, meta, e, padded),
                        meta, e)
            with _tstage(timer, "feeder: upload"):
                dbuf = jnp.asarray(buf)
                if timer is not None:
                    jax.block_until_ready(dbuf)
            return fmt, chunk, padded, dbuf, meta, e

    def _dispatch_chunk(fmt, chunk, padded, dbuf, meta, e):
        """Fire this chunk's async device dispatches and return the
        searchq entry.  Synchronous RPC-layer device errors are
        isolated per chunk by the caller."""
        with _tstage(timer, "search dispatch"):
            if use_device_entropy and opts.optimize_huffman:
                if FUSED_OPT:
                    # mw stays 0: dispatch 1 doesn't emit, and the
                    # program cache key must not vary with input
                    # file sizes.
                    kind, mw = "optf", 0
                    flavor = "opt"
                else:
                    kind, mw = "opt", 0
                    flavor = "hist"
            elif use_device_entropy:
                kind, mw = "emit", emit_words
                flavor = "emit"
            else:
                kind, mw = "quant", 0
                flavor = "quant"
            from ..parallel.batched import (
                batched_decode_search_emit_i8,
                batched_decode_search_hist_i8,
                batched_decode_search_opt_i8,
                batched_decode_search_quantize_i8,
                batched_search_coo,
                batched_search_csr,
                unpack_chunk_buf,
                unpack_chunk_coo,
                unpack_chunk_csr,
            )

            if mesh is not None and fmt == "csr":
                (dc, dcnt, dbase, dspos, dsval, dqts, dtg, dej, dei,
                 dev_) = dbuf
                r_active = meta[0]

                def _csr_fn(dc_, cnt_, base_, qts_, t_, spos_, sval_,
                            ej_, ei_, ev_):
                    off = (jax.lax.axis_index("data")
                           * dc_.shape[0]).astype(ej_.dtype)
                    out = batched_search_csr(
                        dc_, cnt_, base_, spos_, sval_, ej_ - off,
                        ei_, ev_, qts_, t_, h, w, in_sub, subsample,
                        flavor, mw, r_active)
                    if flavor == "quant":
                        q, sv, fv, pk, f8 = out
                        out = (q, sv, fv, pk,
                               jnp.broadcast_to(f8, q.shape))
                    return out

                handles = shard_data_call(
                    mesh, ("csr", h, w, in_sub, subsample, flavor,
                           mw, r_active),
                    _csr_fn, dc, dcnt, dbase, dqts, dtg, dspos,
                    dsval, dej, dei, dev_, replicated=5)
            elif mesh is not None and fmt == "coo":
                dc, dpos, dval, dqts, dtg, dej, dei, dev_ = dbuf

                def _coo_fn(dc_, pos_, val_, qts_, t_, ej_, ei_,
                            ev_):
                    # Rebase global exception image indices to this
                    # shard; rows landing outside [0, local_b) are
                    # dropped by the scatter's mode="drop".
                    off = (jax.lax.axis_index("data")
                           * dc_.shape[0]).astype(ej_.dtype)
                    out = batched_search_coo(
                        dc_, pos_, val_, ej_ - off, ei_, ev_, qts_,
                        t_, h, w, in_sub, subsample, flavor, mw)
                    if flavor == "quant":
                        q, sv, fv, pk, f8 = out
                        out = (q, sv, fv, pk,
                               jnp.broadcast_to(f8, q.shape))
                    return out

                handles = shard_data_call(
                    mesh, ("coo", h, w, in_sub, subsample, flavor,
                           mw),
                    _coo_fn, dc, dpos, dval, dqts, dtg, dej, dei,
                    dev_, replicated=3)
            elif mesh is not None:
                di8, dqts, dtg, dej, dei, dev_ = dbuf

                def _i8_fn(i8_, qts_, t_, ej_, ei_, ev_):
                    off = (jax.lax.axis_index("data")
                           * i8_.shape[0]).astype(ej_.dtype)
                    ejl = ej_ - off
                    if kind == "optf":
                        return batched_decode_search_opt_i8(
                            i8_, ejl, ei_, ev_, qts_, t_, h, w,
                            in_sub, subsample)
                    if kind == "opt":
                        return batched_decode_search_hist_i8(
                            i8_, ejl, ei_, ev_, qts_, t_, h, w,
                            in_sub, subsample)
                    if kind == "emit":
                        return batched_decode_search_emit_i8(
                            i8_, ejl, ei_, ev_, qts_, t_, h, w,
                            in_sub, subsample, emit_words)
                    q, sv, fv, pk, f8 = \
                        batched_decode_search_quantize_i8(
                            i8_, ejl, ei_, ev_, qts_, t_, h, w,
                            in_sub, subsample)
                    return (q, sv, fv, pk,
                            jnp.broadcast_to(f8, q.shape))

                handles = shard_data_call(
                    mesh, ("i8", kind, h, w, in_sub, subsample,
                           mw),
                    _i8_fn, di8, dqts, dtg, dej, dei, dev_,
                    replicated=3)
            elif fmt == "csr":
                (dc, dcnt, dbase, dspos, dsval, dqts, dej, dei,
                 dev_, targets) = unpack_chunk_csr(dbuf, padded, nt,
                                                   meta[1], e)
                handles = batched_search_csr(
                    dc, dcnt, dbase, dspos, dsval, dej, dei, dev_,
                    dqts, targets, h, w, in_sub, subsample, flavor,
                    mw, meta[0])
            elif fmt == "coo":
                (dc, dpos, dval, dqts, dej, dei, dev_,
                 targets) = unpack_chunk_coo(dbuf, padded, nt,
                                             meta, e)
                handles = batched_search_coo(
                    dc, dpos, dval, dej, dei, dev_, dqts, targets,
                    h, w, in_sub, subsample, flavor, mw)
            else:
                (di8, dqts, dej, dei, dev_,
                 targets) = unpack_chunk_buf(dbuf, padded, nt,
                                             meta, e)
                if kind == "optf":
                    handles = batched_decode_search_opt_i8(
                        di8, dej, dei, dev_, dqts, targets, h, w,
                        in_sub, subsample)
                elif kind == "opt":
                    handles = batched_decode_search_hist_i8(
                        di8, dej, dei, dev_, dqts, targets, h, w,
                        in_sub, subsample)
                elif kind == "emit":
                    handles = batched_decode_search_emit_i8(
                        di8, dej, dei, dev_, dqts, targets, h, w,
                        in_sub, subsample, emit_words)
                else:
                    handles = batched_decode_search_quantize_i8(
                        di8, dej, dei, dev_, dqts, targets, h, w,
                        in_sub, subsample)
            if kind == "optf":
                # Chain the custom-table emission on the RESIDENT
                # dispatch-1 handles — both dispatches are async, so
                # the host pays zero round-trips between them (the
                # single guarded pull happens in _collect_opt_fused).
                # The emit runs at the optimistic EMIT_LWORDS width
                # (worst-case-width programs are very large); the exact
                # overflow flag rides the header's redo column.
                from ..ops import jpeg_emit as _je
                from ..parallel.batched import batched_emit_custom_hdr

                lw = _je.EMIT_LWORDS
                hdr_d, pk_d, tb_d = handles
                if mesh is not None:
                    handles = shard_data_call(
                        mesh, ("emit_hdr", h, w, subsample,
                               emit_words, lw),
                        lambda p, tb, hd: batched_emit_custom_hdr(
                            p, tb, hd, h, w, subsample, emit_words,
                            lw),
                        pk_d, tb_d, hdr_d)
                else:
                    handles = batched_emit_custom_hdr(
                        pk_d, tb_d, hdr_d, h, w, subsample,
                        emit_words, lw)
        return (kind, chunk, handles)

    feeder = concurrent.futures.ThreadPoolExecutor(2)
    stage_a_exec = concurrent.futures.ThreadPoolExecutor(STAGE_WORKERS)
    stage_b_exec = concurrent.futures.ThreadPoolExecutor(STAGE_WORKERS)
    futs = [feeder.submit(_make_chunk, s) for s in starts[:PREFETCH]]
    searchq: List = []
    bfuts: List = []

    def _run_a(kind, chunk, handles):
        """Stage-A executor body: device errors fail only this chunk.
        Successful stage walls feed the adaptive watchdog."""
        t0 = time.perf_counter()
        try:
            if kind == "opt":
                with _tstage(timer, "stage A: pull + tables + emit"):
                    state = _stage_a_opt(chunk, handles)
                board.note_wall(time.perf_counter() - t0)
                return stage_b_exec.submit(_run_b, state)
            _collect((kind, chunk, handles))
            board.note_wall(time.perf_counter() - t0)
            _chunk_ok()
            return None
        except Exception as exc:
            if _is_device_error(exc):
                _chunk_failed(chunk, exc)
                return None
            raise

    def _run_b(state):
        t0 = time.perf_counter()
        try:
            with _tstage(timer, "stage B: words pull + wrap"):
                _stage_b_opt(*state)
            board.note_wall(time.perf_counter() - t0)
            _chunk_ok()
        except Exception as exc:
            if _is_device_error(exc):
                _chunk_failed(state[0], exc)
                return
            raise

    try:
        for i in range(len(starts)):
            if ctx is not None:
                ctx.raise_if_done()
            if fault["wedged"] or fault["consec"] >= 2:
                # Device wedged or failing every chunk: stop feeding it.
                # Remaining (undispatched) chunks fail with the last
                # device error; dispatched ones resolve below.
                for s in starts[i:]:
                    _chunk_failed(
                        range(s, min(s + chunk_sz, n)), fault["last"])
                break
            try:
                fmt, chunk, padded, dbuf, meta, e = \
                    board.wait_future(futs[i], "chunk upload")
            except DeviceTimeoutError as exc:
                with flock:
                    fault["wedged"] = True
                _chunk_failed(
                    range(starts[i], min(starts[i] + chunk_sz, n)),
                    exc)
                continue
            except Exception as exc:
                if _is_device_error(exc):  # device_put failed
                    _chunk_failed(
                        range(starts[i], min(starts[i] + chunk_sz, n)),
                        exc)
                    futs[i] = None
                    if i + PREFETCH < len(starts):
                        futs.append(feeder.submit(
                            _make_chunk, starts[i + PREFETCH]))
                    continue
                raise
            futs[i] = None
            if i + PREFETCH < len(starts):
                futs.append(feeder.submit(_make_chunk,
                                          starts[i + PREFETCH]))
            try:
                searchq.append(_dispatch_chunk(fmt, chunk, padded,
                                               dbuf, meta, e))
            except Exception as exc:
                if not _is_device_error(exc):
                    raise
                _chunk_failed(chunk, exc)

            if len(searchq) >= SEARCHQ_DEPTH:
                e2 = searchq.pop(0)
                bfuts.append((stage_a_exec.submit(_run_a, *e2), e2[1]))
            # Backpressure: an error in stage A/B must surface promptly,
            # and unbounded racing would pin every chunk's resident
            # coefficients in HBM at once.
            while len(bfuts) > 3:
                _wait_stage(bfuts.pop(0))
            _flush_ledger(False)

        while searchq:
            e2 = searchq.pop(0)
            if fault["wedged"]:
                _chunk_failed(e2[1], fault["last"])
                continue
            bfuts.append((stage_a_exec.submit(_run_a, *e2), e2[1]))
        for entry in bfuts:
            _wait_stage(entry)
        # One concurrent drain of every queued host encode/redo — a
        # per-item redo wedged on the device marks the board wedged
        # (the zombie thread is abandoned); the ledger flush below
        # marks its chunk's items failed.
        board.drain(pending, "item redo")
        _flush_ledger(True)
        _treport(timer, "coef-fastpath")

        if failed and not fault["wedged"] and chunk_sz > 16 \
                and len(datas) > 1:
            # Chunk-size backoff: the failure may be specific to this
            # chunk shape's compiled program; one retry at chunk 16
            # recovers at batch rates before
            # callers pay per-file dispatch costs.  The remap writes
            # retried successes straight into results AND forwards them
            # to on_chunk, so a subsequent raise loses nothing.
            retry_ids = sorted(failed)

            def _remap(pairs):
                for j, r in pairs:
                    results[retry_ids[j]] = r
                    failed.discard(retry_ids[j])
                if on_chunk is not None:
                    on_chunk([(retry_ids[j], r) for j, r in pairs])

            try:
                sub = compress_jpeg_bytes_batched(
                    ctx, [datas[i] for i in retry_ids], opts,
                    on_chunk=_remap, qualify_key=qualify_key,
                    workers=workers, chunk_size=16)
                for j, i2 in enumerate(retry_ids):
                    results[i2] = sub[j]
                failed.clear()
            except FusedChunkError as fe:
                fault["wedged"] = fault["wedged"] or fe.wedged
                fault["last"] = fe.cause
                # _remap already cleared the items that made it.

        if failed:
            raise FusedChunkError(failed, fault["last"],
                                  wedged=fault["wedged"])
    finally:
        # Feeder first (its chunk prep uses `pool` internally), then the
        # stage executors (their work writes results/pending), then the
        # emit pool: cancel queued encodes, wait out in-flight ones so no
        # worker writes results after an exception has propagated.  A
        # wedged device means threads stuck on dead pulls — don't join
        # them (they are abandoned; nothing downstream reads their
        # chunks' results).
        wait = not fault["wedged"]
        feeder.shutdown(wait=wait, cancel_futures=True)
        stage_a_exec.shutdown(wait=wait, cancel_futures=True)
        stage_b_exec.shutdown(wait=wait, cancel_futures=True)
        pool.shutdown(wait=wait, cancel_futures=True)
    return results


def _compress_images_targetsize(ctx: Optional[Context],
                                images: List[np.ndarray],
                                opts: Options,
                                on_chunk=None) -> List[Result]:
    """Target-size mode over many images: same-shape buckets run through
    the batched lockstep engine (engine/targetsize_batched.py); singleton
    shapes take the per-image engine.  Per-image results are identical to
    compress_image with the same options."""
    from .targetsize import hit_target_size
    from .targetsize_batched import hit_target_size_batched

    n = len(images)
    results: List[Optional[Result]] = [None] * n
    prepped: List[np.ndarray] = [None] * n  # type: ignore[list-item]
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for i, img in enumerate(images):
        if ctx is not None:
            ctx.raise_if_done()
        arr = to_nrgba(validate_image(img))
        res = Result(original_dimensions=(arr.shape[1], arr.shape[0]))
        if opts.max_width > 0 or opts.max_height > 0:
            arr = smart_resize(arr, opts.max_width, opts.max_height)
        res.image = arr
        res.final_dimensions = (arr.shape[1], arr.shape[0])
        results[i] = res
        prepped[i] = arr
        buckets.setdefault(arr.shape[:2], []).append(i)

    for shape, idxs in buckets.items():
        if ctx is not None:
            ctx.raise_if_done()
        if len(idxs) >= 2:
            srs = hit_target_size_batched(
                ctx, [prepped[i] for i in idxs], opts.target_size, opts)
        else:
            srs = [hit_target_size(ctx, prepped[idxs[0]],
                                   opts.target_size, opts)]
        for i, sr in zip(idxs, srs):
            res = results[i]
            res.compressed_data = sr.data
            res.format = sr.format
            res.jpeg_quality = sr.quality
            res.ssim = sr.ssim
            res.final_dimensions = (sr.final_w, sr.final_h)
            if sr.img is not None:
                res.image = sr.img
            res.compressed_size = len(sr.data)
            res.compute_stats()
        if on_chunk is not None:
            on_chunk([(i, results[i]) for i in idxs])
    return results  # type: ignore[return-value]


def compress_images_batched(ctx: Optional[Context],
                            images: List[np.ndarray],
                            opts: Options,
                            workers: int = 0,
                            on_chunk=None,
                            chunk_size: int = 0) -> List[Result]:
    """Standard-mode compression of many decoded images with shared
    options, device-batched.  Returns Results in input order.

    Semantically equivalent to [compress_image(ctx, im, opts) for im in
    images] when opts.target_size == 0; target-size mode falls back to the
    per-image engine.  on_chunk, when given, streams [(index, Result)]
    groups as they become final (see compress_jpeg_bytes_batched).

    Fault isolation matches compress_jpeg_bytes_batched: a device error
    fails only its chunk, failed items retry once at chunk 16, and
    whatever remains raises FusedChunkError after all other work
    finishes (wedged=True when a pull timed out — do not retry through
    the device then).
    """
    opts.validate()
    n = len(images)
    results: List[Optional[Result]] = [None] * n
    if n == 0:
        return []

    if opts.target_size > 0:
        return _compress_images_targetsize(ctx, images, opts, on_chunk)

    target = opts.quality.target_ssim()
    if 0.0 < opts.target_ssim <= 1.0:
        target = opts.target_ssim

    # Preprocess: validate, resize, route PNG vs JPEG.
    jpeg_buckets: Dict[Tuple[int, int], List[int]] = {}
    prepped: List[np.ndarray] = [None] * n  # type: ignore[list-item]
    for i, img in enumerate(images):
        if ctx is not None:
            ctx.raise_if_done()
        arr = to_nrgba(validate_image(img))
        result = Result(original_dimensions=(arr.shape[1], arr.shape[0]))
        if opts.max_width > 0 or opts.max_height > 0:
            arr = smart_resize(arr, opts.max_width, opts.max_height)
        result.image = arr
        result.final_dimensions = (arr.shape[1], arr.shape[0])
        fmt = opts.format
        if fmt == Format.AUTO:
            fmt = analyze_format(arr)
        result.format = fmt
        results[i] = result
        prepped[i] = arr
        if fmt == Format.PNG:
            result.compressed_data = compress_png(arr, opts)
            result.ssim = 1.0
            result.compressed_size = len(result.compressed_data)
            result.compute_stats()
        else:
            jpeg_buckets.setdefault(arr.shape[:2], []).append(i)

    # PNG-routed items finished synchronously during prep — stream them
    # out as one completed group before any device work (and before the
    # all-PNG early return, so the on_chunk contract holds either way).
    png_done = [i for i in range(n)
                if results[i].format == Format.PNG]
    if on_chunk is not None and png_done:
        on_chunk([(i, results[i]) for i in png_done])

    if not jpeg_buckets:
        return results  # type: ignore[return-value]

    nworkers = workers if workers > 0 else min(16, os.cpu_count() or 4)
    pool = concurrent.futures.ThreadPoolExecutor(nworkers)
    subsample = bool(opts.subsample)
    pending = []
    ledger: List = []  # (chunk_ids, futures) per dispatched chunk
    chunk_sz = chunk_size if chunk_size > 0 else BATCH_CHUNK

    timeout_s = CHUNK_TIMEOUT if CHUNK_TIMEOUT > 0 else None
    board = _make_fault_board(timeout_s)
    flock, failed, fault = board.lock, board.failed, board.fault
    _chunk_failed, _item_failed = board.chunk_failed, board.item_failed
    _chunk_ok, _wait_stage = board.chunk_ok, board.wait_stage

    _flush_ledger = _make_ledger_flush(ledger, results, on_chunk, ctx,
                                       board=board)

    # Multi-device: shard every chunk's batch axis over all local devices
    # (the device CompressBatch parallelism, batch.go:58-128).
    from ..parallel.batched import data_mesh, shard_data_call

    mesh = data_mesh()

    if opts.device_entropy is None:
        use_device_entropy = device_entropy_default()
    else:
        use_device_entropy = bool(opts.device_entropy)

    def _finalize(i, quality, ssim_val, found, data):
        res = results[i]
        if not found:
            quality, ssim_val = 100, 1.0  # compress.go fallback
        res.jpeg_quality = quality
        res.ssim = ssim_val
        res.compressed_data = data
        res.compressed_size = len(data)
        res.compute_stats()

    def _collect_quant(chunk_ids, h, w, handles):
        from ..parallel.batched import packed_to_int8, split_packed

        qs, ssims, found, packed, fits8 = handles
        q_host = np.asarray(qs)
        s_host = np.asarray(ssims)
        f_host = np.asarray(found)
        # fits8 is a scalar on the unsharded path, a per-image vector on
        # the mesh path (shard_map outputs can't mix per-shard scalars).
        if bool(np.asarray(fits8).all()):
            packed_h = np.asarray(packed_to_int8(packed))
        else:
            packed_h = np.asarray(packed)
        qy_h, qcb_h, qcr_h, ph, pw = split_packed(packed_h, h, w,
                                                  subsample)

        def encode_one(i: int, j: int) -> None:
            # Pure host work: Huffman-code the device-quantized blocks.
            if opts.optimize_huffman:
                scan, dht = encode_scan_optimized(
                    np.asarray(qy_h[j]), np.asarray(qcb_h[j]),
                    np.asarray(qcr_h[j]), ph, pw, subsample)
                data = assemble_jpeg(
                    w, h, all_quality_tables()[int(q_host[j])], scan,
                    subsample, dht=dht)
            else:
                scan = encode_scan_from_quantized(
                    np.asarray(qy_h[j]), np.asarray(qcb_h[j]),
                    np.asarray(qcr_h[j]), ph, pw, subsample)
                data = assemble_jpeg(
                    w, h, all_quality_tables()[int(q_host[j])], scan,
                    subsample)
            _finalize(i, int(q_host[j]), float(s_host[j]),
                      bool(f_host[j]), data)

        futs = [pool.submit(encode_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    def _collect_opt_px(chunk_ids, h, w, mw, handles):
        """Fused optimal-Huffman pixel chunk: ONE guarded pull carries
        q/ssim/found/bits, the device-built DHT specs, and the scan
        words.  Three per-image redo triggers share one branch: the
        K.2 >32-bit flag, the optimistic-lwords block-overflow flag
        (both OR'd into the header's redo column on device), and the
        exact bits check against the optimistic word capacity."""
        from ..codecs.jpeg import _dht_segment_custom
        from ..ops.jpeg_emit import finalize_scan_host
        from ..parallel.batched import (
            OPT_HDR,
            specs_from_opt_header,
            split_opt_header,
        )

        b = handles.shape[0]
        if (OPT_HDR + mw) * b * 4 <= (8 << 20):
            wb_h = np.asarray(handles)
            hdr, words_h = wb_h[:, :OPT_HDR], wb_h[:, OPT_HDR:]
        else:
            hdr = np.asarray(handles[:, :OPT_HDR])
            bmax = int(hdr[:, 3].astype(np.int64).max())
            used = min(bmax // 32 + 2, mw)
            words_h = np.asarray(handles[:, OPT_HDR:OPT_HDR + used])
        (q_host, s_host, f_host, bits_h, ovf, bits16, nvals,
         vals) = split_opt_header(hdr)

        def emit_one(i: int, j: int) -> None:
            if bool(ovf[j]) or int(bits_h[j]) + 64 > mw * 32:
                from ..api import compress_image
                from ..types import CanceledError

                if fault["wedged"]:
                    _item_failed(i, fault["last"])
                    return
                od = results[i].original_dimensions
                try:
                    with board.cold_guard(("item-redo",)):
                        results[i] = compress_image(ctx, prepped[i],
                                                    opts)
                except CanceledError:
                    raise
                except Exception as exc:
                    if _is_device_error(exc):
                        _item_failed(i, exc)
                        return
                    raise
                results[i].original_dimensions = od
                return
            quality = int(q_host[j])
            if not bool(f_host[j]):
                quality = 100
            scan = finalize_scan_host(words_h[j], int(bits_h[j]))
            dht = _dht_segment_custom(
                *specs_from_opt_header(bits16, nvals, vals, j))
            data = assemble_jpeg(w, h, all_quality_tables()[quality],
                                 scan, subsample, dht=dht)
            _finalize(i, int(q_host[j]), float(s_host[j]),
                      bool(f_host[j]), data)

        futs = [pool.submit(emit_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    def _stage_a_dev(chunk_ids, h, w, handles, use_opt):
        """Stage A: pull small search outputs + histograms, build tables
        (one C call), dispatch the stage-2 emission on the resident
        coefficients; the words pull happens one stage later, overlapped
        with the next chunk's search.  Word buffer sized from the exact
        standard-table bit counts (optimal tables never exceed them, so
        overflow is impossible)."""
        from ..codecs.huffopt import specs_and_tables_batch
        from ..parallel.batched import (
            batched_emit_custom,
            batched_emit_std,
            split_search_small,
        )

        small, packed = handles
        (q_host, s_host, f_host, bstd_h, dcf,
         acf) = split_search_small(np.asarray(small))
        emit_words = emit_words_for_bits(int(bstd_h.max()))

        specs: List = [None] * len(q_host)
        from ..ops import jpeg_emit as _je

        lw = _je.EMIT_LWORDS
        # First dispatch of a new emission width compiles — hold the
        # watchdog at its cold ceiling for its duration.
        key = ("emitpx", use_opt, tuple(getattr(packed, "shape", ())),
               emit_words, lw)
        if use_opt:
            specs, dc_tabs, ac_tabs = specs_and_tables_batch(
                dcf.astype(np.int64), acf.astype(np.int64))

            tables = np.concatenate([dc_tabs, ac_tabs], axis=2)
            with board.cold_guard(key):
                if mesh is not None:
                    wb = shard_data_call(
                        mesh, ("emit_custom", h, w, subsample,
                               emit_words, lw),
                        lambda p, tb: batched_emit_custom(
                            p, tb, h, w, subsample, emit_words, lw),
                        packed, tables)
                else:
                    wb = batched_emit_custom(packed,
                                             jnp.asarray(tables),
                                             h, w, subsample,
                                             emit_words, lw)
        else:
            with board.cold_guard(key):
                if mesh is not None:
                    wb = shard_data_call(
                        mesh, ("emit_std", h, w, subsample, emit_words,
                               lw),
                        lambda p: batched_emit_std(p, h, w, subsample,
                                                   emit_words, lw),
                        packed)
                else:
                    wb = batched_emit_std(packed, h, w, subsample,
                                          emit_words, lw)
        return (chunk_ids, h, w, (q_host, s_host, f_host, specs, wb,
                                  emit_words, use_opt))

    def _stage_b_dev(chunk_ids, h, w, state):
        from ..codecs.jpeg import _dht_segment_custom
        from ..ops.jpeg_emit import finalize_scan_host
        from ..parallel.batched import pull_emit_words

        (q_host, s_host, f_host, specs, wb, emit_words,
         use_opt) = state
        words_h, bits_h, bovf = pull_emit_words(wb, emit_words)

        def emit_one(i: int, j: int) -> None:
            if bool(bovf[j]):
                # A block outgrew the optimistic emit buffer (exact
                # flag): redo this image on the per-image path, same as
                # the fused path's K.2-overflow branch.
                from ..api import compress_image
                from ..types import CanceledError

                if fault["wedged"]:
                    _item_failed(i, fault["last"])
                    return
                od = results[i].original_dimensions
                try:
                    with board.cold_guard(("item-redo",)):
                        results[i] = compress_image(ctx, prepped[i],
                                                    opts)
                except CanceledError:
                    raise
                except Exception as exc:
                    if _is_device_error(exc):
                        _item_failed(i, exc)
                        return
                    raise
                results[i].original_dimensions = od
                return
            quality = int(q_host[j])
            if not bool(f_host[j]):
                quality = 100
            scan = finalize_scan_host(words_h[j], int(bits_h[j]))
            dht = _dht_segment_custom(*specs[j]) if use_opt else None
            data = assemble_jpeg(w, h, all_quality_tables()[quality],
                                 scan, subsample, dht=dht)
            _finalize(i, int(q_host[j]), float(s_host[j]),
                      bool(f_host[j]), data)

        futs = [pool.submit(emit_one, i, j)
                for j, i in enumerate(chunk_ids)]
        with _flush_ledger.lock:
            pending.extend(futs)
            ledger.append((chunk_ids, futs))

    # ── Pipelined dispatch: feeder thread builds + uploads pixel stacks
    # for chunk k+2; stage A (k-1) builds tables and dispatches emission;
    # stage B (k-2) pulls words and wraps (same 3-stage scheme as the
    # coefficient fast path in compress_jpeg_bytes_batched). ──
    from ..image import is_opaque

    jobs = []  # (h, w, chunk)
    for (h, w), idxs in jpeg_buckets.items():
        for start in range(0, len(idxs), chunk_sz):
            jobs.append((h, w, idxs[start:start + chunk_sz]))

    timer = _batch_timer()

    def _make_stack(job):
        with _tstage(timer, "stack + upload (feeder)"):
            h, w, chunk = job
            b = len(chunk)
            # Pad the chunk to a power of two to bound recompilation; ship
            # uint8 (4x less transfer); opaque chunks ship RGB-only (25%
            # less) — alpha is synthesized on device by the search kernels.
            padded = _next_pow2(b)
            if mesh is not None:  # shards need equal batch slices
                padded = -(-padded // mesh.size) * mesh.size
            nch = 3 if all(is_opaque(prepped[i]) for i in chunk) else 4
            # Halved wire: opaque 4:2:0 chunks on the device-entropy
            # path ship HOST-converted YCbCr planes at 1.5 B/px instead
            # of 3 B/px RGB, halving the in-memory path's upload.  The
            # conversion
            # mirrors forward_dct_device exactly (rgb_to_ycbcr formula,
            # edge pad, 2×2 mean chroma); the only deviation is the
            # uint8 wire rounding (≤0.5 per DCT input sample).
            wire = (PIXEL_WIRE == "yuv420" and nch == 3 and subsample
                    and use_device_entropy)
            stack = None
            if wire:
                # Direct per-image C++ conversion into the wire buffer:
                # skips the packed-RGB staging stack (a 48 MB copy per
                # chunk).
                from ..native import rgba_to_yuv420_into

                ph_, pw_ = h + (-h) % 16, w + (-w) % 16
                wl = ph_ * pw_ + 2 * (ph_ // 2) * (pw_ // 2)
                buf = np.empty((padded, wl), dtype=np.uint8)
                direct = True
                for j, i in enumerate(chunk):
                    if not rgba_to_yuv420_into(prepped[i], buf[j]):
                        direct = False  # no native lib: batch fallback
                        break
                if direct:
                    for j in range(b, padded):
                        buf[j] = buf[0]
                    stack = buf
            if stack is None:
                stack = np.empty((padded, h, w, nch), dtype=np.uint8)
                for j, i in enumerate(chunk):
                    stack[j] = prepped[i][..., :nch]
                for j in range(b, padded):
                    stack[j] = stack[0]
                if wire:
                    stack = _yuv420_wire_host(stack, h, w)
            tgt = np.full((padded,), target, dtype=np.float32)
            if mesh is not None:
                from jax.sharding import (
                    NamedSharding, PartitionSpec as _P,
                )

                dsh = NamedSharding(mesh, _P("data"))
                return (h, w, chunk, padded, wire,
                        jax.device_put(stack, dsh),
                        jax.device_put(tgt, dsh))
            return h, w, chunk, padded, wire, jnp.asarray(stack), \
                jnp.asarray(tgt)

    # Stage A and B each block on one device round-trip per chunk; the
    # coefficient fast path runs them on dedicated executors so those
    # waits stay off the dispatch thread (critical path = max(feeder, A,
    # B), not their sum), and the pixel path uses the same executor
    # scheme.  Single-thread executors preserve chunk order (the ledger
    # FIFO invariant).
    def _dispatch_px(h, w, chunk, padded, wire, stack_dev, targets):
        """Fire this pixel chunk's async device dispatches and return
        the searchq entry; device errors isolate per chunk in the
        caller.  wire=True means stack_dev is the flat YCbCr 4:2:0
        plane buffer (half the RGB bytes), not an RGB stack."""
        with _tstage(timer, "search dispatch"):
            # Fused single-dispatch optimal path: word capacity is
            # the hard 53-words/block bound (no input file to size
            # from), so gate on the padded device buffer staying
            # reasonable — large stills fall back to the two-stage
            # exact-sized path.
            mult_ = 16 if subsample else 8
            ph_ = h + (-h) % mult_
            pw_ = w + (-w) % mult_
            nb_ = ((ph_ // 8) * (pw_ // 8)
                   + 2 * ((ph_ // 16) * (pw_ // 16) if subsample
                          else (ph_ // 8) * (pw_ // 8)))
            # Optimistic word capacity: ~8 bits/pixel of scan budget
            # (Balanced outputs measure ~0.4 bpp — 20× headroom) with
            # the hard per-block bound as ceiling; a rare capacity
            # overflow is caught by the exact bits check in
            # _collect_opt_px and redone per image.
            opt_mw = min(nb_ * 53 + 64,
                         _next_pow2(max(ph_ * pw_ // 4, 4096)),
                         (1 << 26) - 64)  # 2^31-bit emission bound
            fused = (use_device_entropy and opts.optimize_huffman
                     and FUSED_OPT
                     and (opt_mw + 209) * 4 * padded <= (256 << 20))
            if fused:
                from ..ops import jpeg_emit as _je
                from ..parallel.batched import (
                    batched_emit_custom_hdr,
                    batched_search_opt,
                )

                lw_ = _je.EMIT_LWORDS

                # Two chained async dispatches, zero host pulls in
                # between: search+hist+K.2-build returns RESIDENT
                # handles, the custom-table emission consumes them.
                # (In a single fused program XLA pessimizes the one-hot
                # code lookups when the tables are intermediates instead
                # of inputs.)
                if wire:
                    from ..parallel.batched import (
                        batched_search_opt_yuv420,
                    )

                    def _s1(im, t):
                        return batched_search_opt_yuv420(im, t, h, w)
                else:
                    def _s1(im, t):
                        return batched_search_opt(im, t, subsample)

                if mesh is not None:
                    hdr_d, pk_d, tb_d = shard_data_call(
                        mesh, ("search_opt", wire, h, w, subsample),
                        _s1, stack_dev, targets)
                    handles = shard_data_call(
                        mesh, ("emit_hdr", h, w, subsample, opt_mw,
                               lw_),
                        lambda p, tb, hd: batched_emit_custom_hdr(
                            p, tb, hd, h, w, subsample, opt_mw, lw_),
                        pk_d, tb_d, hdr_d)
                else:
                    hdr_d, pk_d, tb_d = _s1(stack_dev, targets)
                    handles = batched_emit_custom_hdr(
                        pk_d, tb_d, hdr_d, h, w, subsample, opt_mw,
                        lw_)
                return ("optf", chunk, (h, w, opt_mw), handles)
            elif use_device_entropy:
                from ..parallel.batched import (
                    batched_search_hist,
                    batched_search_hist_yuv420,
                )

                if wire:
                    def _sh(im, t):
                        return batched_search_hist_yuv420(im, t, h, w)
                else:
                    def _sh(im, t):
                        return batched_search_hist(im, t, subsample)

                if mesh is not None:
                    handles = shard_data_call(
                        mesh, ("search_hist", wire, h, w, subsample),
                        _sh, stack_dev, targets)
                else:
                    handles = _sh(stack_dev, targets)
                return ("dev", chunk, (h, w), handles)
            else:
                if mesh is not None:
                    def _quant_fn(im, t):
                        q, s, f, pk, f8 = batched_search_and_quantize(
                            im, t, subsample)
                        return (q, s, f, pk,
                                jnp.broadcast_to(f8, q.shape))

                    handles = shard_data_call(
                        mesh, ("search_quant", subsample),
                        _quant_fn, stack_dev, targets)
                else:
                    handles = batched_search_and_quantize(
                        stack_dev, targets, subsample)
                return ("quant", chunk, (h, w), handles)

    feeder = concurrent.futures.ThreadPoolExecutor(2)
    stage_a_exec = concurrent.futures.ThreadPoolExecutor(STAGE_WORKERS_PX)
    stage_b_exec = concurrent.futures.ThreadPoolExecutor(STAGE_WORKERS_PX)
    futs = [feeder.submit(_make_stack, j) for j in jobs[:PREFETCH]]
    searchq: List = []
    bfuts: List = []

    def _run_a(kind, chunk_ids, hw, handles):
        """Stage-A executor body: device errors fail only this chunk.
        Successful stage walls feed the adaptive watchdog."""
        t0 = time.perf_counter()
        try:
            if kind == "dev":
                with _tstage(timer, "stage A: pull + tables + emit"):
                    state = _stage_a_dev(chunk_ids, *hw, handles,
                                         bool(opts.optimize_huffman))
                board.note_wall(time.perf_counter() - t0)
                return stage_b_exec.submit(_run_b, state)
            if kind == "optf":
                with _tstage(timer, "opt: packed pull + wrap"):
                    _collect_opt_px(chunk_ids, *hw, handles)
            else:
                with _tstage(timer, "pull + host encode queue"):
                    _collect_quant(chunk_ids, *hw, handles)
            board.note_wall(time.perf_counter() - t0)
            _chunk_ok()
            return None
        except Exception as exc:
            if _is_device_error(exc):
                _chunk_failed(chunk_ids, exc)
                return None
            raise

    def _run_b(state):
        t0 = time.perf_counter()
        try:
            with _tstage(timer, "stage B: words pull + wrap"):
                _stage_b_dev(*state)
            board.note_wall(time.perf_counter() - t0)
            _chunk_ok()
        except Exception as exc:
            if _is_device_error(exc):
                _chunk_failed(state[0], exc)
                return
            raise

    try:
        for k in range(len(jobs)):
            if ctx is not None:
                ctx.raise_if_done()
            if fault["wedged"] or fault["consec"] >= 2:
                for (_h2, _w2, ids2) in jobs[k:]:
                    _chunk_failed(ids2, fault["last"])
                break
            try:
                h, w, chunk, padded, wire, stack_dev, targets = \
                    board.wait_future(futs[k], "chunk upload")
            except DeviceTimeoutError as exc:
                with flock:
                    fault["wedged"] = True
                _chunk_failed(jobs[k][2], exc)
                continue
            except Exception as exc:
                if _is_device_error(exc):  # device_put failed
                    _chunk_failed(jobs[k][2], exc)
                    futs[k] = None
                    if k + PREFETCH < len(jobs):
                        futs.append(feeder.submit(_make_stack,
                                                  jobs[k + PREFETCH]))
                    continue
                raise
            futs[k] = None
            if k + PREFETCH < len(jobs):
                futs.append(feeder.submit(_make_stack,
                                          jobs[k + PREFETCH]))
            try:
                searchq.append(_dispatch_px(h, w, chunk, padded, wire,
                                            stack_dev, targets))
            except Exception as exc:
                if not _is_device_error(exc):
                    raise
                _chunk_failed(chunk, exc)
            if len(searchq) >= SEARCHQ_DEPTH:
                e2 = searchq.pop(0)
                bfuts.append((stage_a_exec.submit(_run_a, *e2), e2[1]))
            # Backpressure: surface stage A/B errors promptly and bound
            # the number of chunks' coefficients resident in HBM.
            while len(bfuts) > 3:
                _wait_stage(bfuts.pop(0))
            _flush_ledger(False)

        while searchq:
            e2 = searchq.pop(0)
            if fault["wedged"]:
                _chunk_failed(e2[1], fault["last"])
                continue
            bfuts.append((stage_a_exec.submit(_run_a, *e2), e2[1]))
        for entry in bfuts:
            _wait_stage(entry)
        # One concurrent drain (see the coefficient fast path).
        board.drain(pending, "item redo")
        _flush_ledger(True)
        _treport(timer, "pixel-path")

        if failed and not fault["wedged"] and chunk_sz > 16 and n > 1:
            # Chunk-size backoff, as in the coefficient fast path: the
            # failure may be specific to this chunk shape's program;
            # one retry at chunk 16 recovers at batch rates.
            retry_ids = sorted(failed)

            def _remap(pairs):
                for j, r in pairs:
                    results[retry_ids[j]] = r
                    failed.discard(retry_ids[j])
                if on_chunk is not None:
                    on_chunk([(retry_ids[j], r) for j, r in pairs])

            try:
                sub = compress_images_batched(
                    ctx, [images[i] for i in retry_ids], opts,
                    workers=workers, on_chunk=_remap, chunk_size=16)
                for j, i2 in enumerate(retry_ids):
                    results[i2] = sub[j]
                failed.clear()
            except FusedChunkError as fe:
                fault["wedged"] = fault["wedged"] or fe.wedged
                fault["last"] = fe.cause
                # _remap already cleared the items that made it.

        if failed:
            raise FusedChunkError(failed, fault["last"],
                                  wedged=fault["wedged"])
    finally:
        # A wedged device means threads stuck on dead pulls — don't
        # join them (see the coefficient fast path's finally).
        wait = not fault["wedged"]
        feeder.shutdown(wait=wait, cancel_futures=True)
        stage_a_exec.shutdown(wait=wait, cancel_futures=True)
        stage_b_exec.shutdown(wait=wait, cancel_futures=True)
        pool.shutdown(wait=wait, cancel_futures=True)
    return results  # type: ignore[return-value]
