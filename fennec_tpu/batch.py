"""Batch compression engine.

Reference model (batch.go:58-166): a worker pool over files with
order-preserving results, per-item error capture (one bad file never aborts
the batch), cooperative cancellation (in-flight items finish), and a
progress callback.

Device mapping: host worker threads do file I/O + entropy coding (they release
the GIL inside zlib/C++), while all array math funnels through the single
device queue — host decode overlaps device compute naturally.  The fully
fused mega-batch path (bucketed shapes, vmapped bisection, mesh-sharded
batches) lives in parallel/batched.py and is used by compress_batch
automatically when items share options and the batch is large.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional

from .api import compress_file
from .types import (
    CanceledError,
    Context,
    Format,
    Options,
    Result,
    human_bytes,
)


@dataclasses.dataclass
class BatchItem:
    """One file to compress (reference batch.go:11-18)."""

    src: str
    dst: str
    opts: Optional[Options] = None


@dataclasses.dataclass
class BatchResult:
    """Result for a single batch item (reference batch.go:21-30)."""

    item: BatchItem
    result: Optional[Result] = None
    err: Optional[Exception] = None
    index: int = 0


@dataclasses.dataclass
class BatchOptions:
    """Batch configuration (reference batch.go:33-41).

    fused: None (auto) routes homogeneous standard-mode batches of 8+
    items through the device mega-batch engine (engine/batched.py);
    True forces it for homogeneous batches (no per-item opts — lockstep
    device search needs one Options for the whole batch, so
    heterogeneous batches always use the per-file pool), False forces
    the per-file worker pool.
    """

    workers: int = 0  # 0 = os.cpu_count()
    default_opts: Options = dataclasses.field(default_factory=Options)
    on_item: Optional[Callable[[int, int], None]] = None
    fused: Optional[bool] = None
    # Resume support (beyond the reference, SURVEY §5 "optional nicety"):
    # skip items whose dst already exists and is non-empty.
    skip_existing: bool = False


def compress_batch(ctx: Optional[Context], items: List[BatchItem],
                   batch_opts: Optional[BatchOptions] = None
                   ) -> List[BatchResult]:
    """Compress many files concurrently; results keep input order
    (reference batch.go:58-128).  Cancellation skips not-yet-started items
    (they get the context error); in-flight items finish."""
    if not items:
        return []
    batch_opts = batch_opts or BatchOptions()

    homogeneous = all(it.opts is None for it in items)
    use_fused = batch_opts.fused
    if use_fused is None:
        use_fused = homogeneous and len(items) >= 8
    if use_fused and homogeneous:
        # Standard mode uses the mega-batch engine; target-size mode uses
        # the batched lockstep search (engine/targetsize_batched.py).
        return _compress_batch_fused(ctx, items, batch_opts)

    workers = batch_opts.workers if batch_opts.workers > 0 \
        else (os.cpu_count() or 1)
    workers = min(workers, len(items))

    results: List[Optional[BatchResult]] = [None] * len(items)
    completed = 0
    lock = threading.Lock()

    def work(idx: int) -> None:
        nonlocal completed
        item = items[idx]
        if ctx is not None and ctx.done():
            results[idx] = BatchResult(item=item, err=ctx.err(), index=idx)
            return
        if batch_opts.skip_existing and _dst_done(item.dst):
            results[idx] = BatchResult(item=item, result=None, index=idx)
            return
        opts = item.opts if item.opts is not None \
            else batch_opts.default_opts
        try:
            res = compress_file(ctx, item.src, item.dst, opts)
            results[idx] = BatchResult(item=item, result=res, index=idx)
        except Exception as e:  # per-item capture (batch.go:108-113)
            results[idx] = BatchResult(item=item, err=e, index=idx)
        if batch_opts.on_item is not None:
            with lock:
                completed += 1
                c = completed
            batch_opts.on_item(c, len(items))

    with ThreadPoolExecutor(max_workers=workers) as pool:
        list(pool.map(work, range(len(items))))

    return [r for r in results if r is not None]


def _dst_done(dst: str) -> bool:
    try:
        return os.path.getsize(dst) > 0
    except OSError:
        return False


def _compress_batch_fused(ctx: Optional[Context], items: List[BatchItem],
                          batch_opts: BatchOptions) -> List[BatchResult]:
    """Mega-batch path: parallel host decode → device-batched lockstep
    quality search → parallel host entropy encode + write."""
    from .codecs import decode_image
    from .engine.batched import (
        compress_images_batched,
        compress_jpeg_bytes_batched,
    )
    from .exif import Orientation, apply_orientation, read_orientation
    from .image import to_nrgba

    opts = batch_opts.default_opts
    n = len(items)
    results: List[BatchResult] = [
        BatchResult(item=it, index=i) for i, it in enumerate(items)]
    raw: List[Optional[bytes]] = [None] * n
    orients: List[int] = [1] * n
    sizes = [0] * n

    skipped = [False] * n

    # Streaming writer state: batched engines call _write_now (via
    # on_chunk) as each device chunk's results become final, so files
    # land on disk and OnItem ticks DURING the batch instead of in one
    # burst at the end (reference batch.go:108-124 fires per completed
    # item).  Errored items tick too — the per-file pool's work() fires
    # OnItem after its per-item except, so a progress bar still reaches
    # n/n on a batch with undecodable files.
    written = [False] * n
    progress = {"completed": 0}
    write_lock = threading.Lock()

    def _tick() -> None:
        if batch_opts.on_item is not None:
            with write_lock:
                progress["completed"] += 1
                c = progress["completed"]
            batch_opts.on_item(c, n)

    def load(i: int):
        if ctx is not None and ctx.done():
            results[i].err = ctx.err()
            return
        if batch_opts.skip_existing and _dst_done(items[i].dst):
            skipped[i] = True
            return
        try:
            with open(items[i].src, "rb") as f:
                data = f.read()
            raw[i] = data
            sizes[i] = len(data)
            orients[i] = int(read_orientation(data))
        except Exception as e:
            results[i].err = e
            _tick()

    workers = batch_opts.workers if batch_opts.workers > 0 \
        else (os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=min(workers, n)) as pool:
        list(pool.map(load, range(n)))

    live = [i for i in range(n)
            if results[i].err is None and not skipped[i]]

    def _write_now(i: int, res) -> None:
        res.original_size = sizes[i]
        res.compute_stats()
        try:
            with open(items[i].dst, "wb") as f:
                f.write(res.compressed_data)
            results[i].result = res
        except Exception as e:
            results[i].err = e
        written[i] = True
        _tick()

    if live:
        from .engine.batched import qualify_jpeg_bytes

        sub_opts = dataclasses.replace(opts, auto_orient=False)
        try:
            compressed_by_index = {}
            pixel_items = list(live)
            # All-device JPEG→JPEG fast path, grouped by geometry: every
            # upright qualifying JPEG goes through the coefficient path;
            # the rest (PNGs, rotated, odd layouts) take the pixel path.
            if opts.format == Format.JPEG and opts.target_size == 0:
                groups = {}
                rest = []
                for i in live:
                    upright = (orients[i] <= int(Orientation.NORMAL)
                               or not opts.auto_orient)
                    key = qualify_jpeg_bytes(raw[i]) if upright else None
                    if key is not None:
                        groups.setdefault(key, []).append(i)
                    else:
                        rest.append(i)
                for key, idxs in groups.items():
                    def chunk_done(pairs, idxs=idxs):
                        for j, r in pairs:
                            _write_now(idxs[j], r)
                    rs = compress_jpeg_bytes_batched(
                        ctx, [raw[i] for i in idxs], sub_opts,
                        on_chunk=chunk_done, qualify_key=key,
                        workers=batch_opts.workers)
                    if rs is None:
                        rest.extend(idxs)
                        continue
                    for i, r in zip(idxs, rs):
                        compressed_by_index[i] = r
                pixel_items = rest
            if os.environ.get("FENNEC_DEBUG_BATCH"):
                print(f"fennec: fused batch coef-fastpath="
                      f"{len(compressed_by_index)} pixel="
                      f"{len(pixel_items)}", flush=True)
            if pixel_items:
                decoded = []
                decodable = []
                for i in pixel_items:
                    try:
                        img = decode_image(raw[i])
                        if opts.auto_orient and \
                                orients[i] > int(Orientation.NORMAL):
                            img = apply_orientation(
                                to_nrgba(img), Orientation(orients[i]))
                    except Exception as e:
                        # Per-item capture (batch.go:108-113): one
                        # undecodable file must not degrade the whole
                        # fused batch.
                        results[i].err = e
                        _tick()
                        continue
                    decoded.append(img)
                    decodable.append(i)
                def pixel_chunk_done(pairs):
                    for j, r in pairs:
                        _write_now(decodable[j], r)
                pixel_results = compress_images_batched(
                    ctx, decoded, sub_opts, workers=batch_opts.workers,
                    on_chunk=pixel_chunk_done)
                for i, r in zip(decodable, pixel_results):
                    compressed_by_index[i] = r
            live = [i for i in live if results[i].err is None]
            compressed = [compressed_by_index[i] for i in live]
        except CanceledError as e:
            # Normal cancellation, not an engine failure: in-flight
            # chunks already streamed via _write_now; every remaining
            # item gets the context error, like the per-file pool's
            # not-yet-started items (batch.go:93-99).  No fallback pool,
            # no warning.
            err = ctx.err() if ctx is not None and ctx.done() else e
            for i in range(n):
                if not written[i] and not skipped[i] \
                        and results[i].err is None:
                    results[i].err = err
            return results
        except Exception as e:
            import warnings

            if getattr(e, "wedged", False):
                # The device stopped responding mid-batch
                # (FusedChunkError.wedged): retrying through the device
                # would hang per item.  Fail the unfinished items
                # honestly — the reference's pool reports per-item
                # errors the same way when workers die (batch.go:108).
                unfinished = [i for i in range(n)
                              if not written[i] and not skipped[i]
                              and results[i].err is None]
                warnings.warn(
                    f"fennec: device unresponsive mid-batch ({e!r}); "
                    f"failing {len(unfinished)} unfinished item(s) "
                    f"without device retry", RuntimeWarning)
                for i in unfinished:
                    results[i].err = e
                return results
            warnings.warn(
                f"fennec: fused batch path failed ({e!r}); falling back "
                f"to the per-file pool (set FENNEC_DEBUG_BATCH=1 for a "
                f"traceback)", RuntimeWarning)
            if os.environ.get("FENNEC_DEBUG_BATCH"):
                import traceback

                traceback.print_exc()
            # Fall back to the per-file pool — but only for items not
            # already streamed to disk by _write_now, and with OnItem
            # continuing from the streamed count (a full restart would
            # re-fire the callback from 1 and double-count; the reference
            # fires exactly once per item, batch.go:108-124).
            fallback = dataclasses.replace(batch_opts, fused=False)
            # Items already resolved (streamed, per-item error already
            # ticked, or skipped) must not re-run — a retry would fire
            # OnItem twice for them.
            pending_idx = [i for i in range(n)
                           if not written[i] and not skipped[i]
                           and results[i].err is None]
            if not pending_idx:
                return results
            if batch_opts.on_item is not None:
                base = progress["completed"]
                cb = batch_opts.on_item
                fallback = dataclasses.replace(
                    fallback,
                    on_item=lambda c, _t, _b=base, _cb=cb: _cb(_b + c, n))
            sub = compress_batch(ctx, [items[i] for i in pending_idx],
                                 fallback)
            for i, br in zip(pending_idx, sub):
                results[i].result, results[i].err = br.result, br.err
            return results
        # Most items were already streamed to disk by _write_now as their
        # chunks completed; this sweep covers whatever remains (paths that
        # return without chunk callbacks, e.g. all-PNG early returns).
        for j, i in enumerate(live):
            if not written[i]:
                _write_now(i, compressed[j])
    return results


@dataclasses.dataclass
class BatchSummary:
    """Aggregate statistics (reference batch.go:130-137)."""

    total: int = 0
    succeeded: int = 0
    failed: int = 0
    total_saved: int = 0
    avg_ssim: float = 0.0

    def __str__(self) -> str:
        return (f"Batch: {self.succeeded}/{self.total} succeeded | "
                f"{human_bytes(self.total_saved)} saved | "
                f"Avg SSIM: {self.avg_ssim:.4f}")


def summarize(results: List[BatchResult]) -> BatchSummary:
    """Aggregate batch results (reference batch.go:140-158)."""
    s = BatchSummary(total=len(results))
    ssim_sum = 0.0
    scored = 0
    for r in results:
        if r.err is not None:
            s.failed += 1
            continue
        s.succeeded += 1
        if r.result is not None:
            s.total_saved += r.result.original_size - r.result.compressed_size
            ssim_sum += r.result.ssim
            scored += 1
    # Items skipped via skip_existing count as succeeded but carry no
    # Result; averaging over them would dilute avg_ssim toward zero.
    if scored > 0:
        s.avg_ssim = ssim_sum / scored
    return s
