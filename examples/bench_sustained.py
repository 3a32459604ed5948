"""Sustained-scale CompressBatch benchmark: the BASELINE.md north-star
workload (one CompressBatch over N mixed 500x500 photos, file -> file).

Run:  python examples/bench_sustained.py [n_files]   (default 10000)

Reports sustained images/sec end to end, per-chunk p50/p99 wall time,
and the host process RSS ceiling, so throughput decay or memory growth
at scale is visible.  Reference equivalent:
CompressBatch over files, batch.go:58-128 at ~22 images/sec/core (M2).
"""

import json
import os
import resource
import sys
import tempfile
import threading
import time


def main() -> None:
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 10000

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench  # noqa: E402  (repo-root benchmark helpers)
    from fennec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import fennec_tpu as fennec

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        srcs = bench.write_jpeg_fixtures(tmp, n_files)
        gen_s = time.perf_counter() - t0
        print(f"fixtures: {n_files} files in {gen_s:.1f}s", flush=True)

        outdir = os.path.join(tmp, "out")
        os.makedirs(outdir)
        items = [fennec.BatchItem(
            src=s, dst=os.path.join(outdir, f"o{i}.jpg"))
            for i, s in enumerate(srcs)]
        bopts = fennec.BatchOptions(
            fused=True,
            default_opts=fennec.Options(format=fennec.Format.JPEG))

        # Warm the chunk shapes on a small prefix (compiles are not the
        # sustained number), then run the full batch once, cold-start to
        # last byte written.  The tail chunk (n % chunk) pads to its own
        # power-of-two program, so warm that shape separately or its XLA
        # compile lands inside the timed run.  Use the engine's actual
        # chunk size (FENNEC_BATCH_CHUNK-configurable), not a literal.
        from fennec_tpu.engine.batched import BATCH_CHUNK
        fennec.compress_batch(
            None, items[:max(256, 4 * BATCH_CHUNK)], bopts)
        tail = n_files % BATCH_CHUNK
        if tail:
            fennec.compress_batch(None, items[:tail], bopts)

        # on_item fires once per written file; bucket completions into
        # 128-item windows so the latency stream tracks steady-state
        # chunk cadence rather than individual writes.
        WINDOW = 128
        chunk_marks = []
        done_prev = [0, time.perf_counter()]
        mark_lock = threading.Lock()

        def on_item(completed: int, total: int) -> None:
            # compress_batch may invoke on_item from worker threads on
            # the error/fallback paths; the window bookkeeping must not
            # race.
            with mark_lock:
                if completed - done_prev[0] < WINDOW and completed < total:
                    return
                now = time.perf_counter()
                chunk_marks.append((completed - done_prev[0],
                                    now - done_prev[1]))
                done_prev[0], done_prev[1] = completed, now

        bopts.on_item = on_item
        t0 = time.perf_counter()
        res = fennec.compress_batch(None, items, bopts)
        dt = time.perf_counter() - t0

        summ = fennec.summarize(res)
        rates = sorted(n / s for n, s in chunk_marks if n > 0 and s > 0)
        per_chunk = sorted(s for n, s in chunk_marks if n > 0)
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is kilobytes on Linux but bytes on macOS.
        rss_mb = maxrss / (1024.0 * 1024.0) if sys.platform == "darwin" \
            else maxrss / 1024.0
        out = {
            "n_files": n_files,
            "sustained_images_per_sec": round(n_files / dt, 2),
            "elapsed_s": round(dt, 1),
            "succeeded": summ.succeeded,
            "failed": summ.failed,
            "avg_ssim": round(summ.avg_ssim, 4),
            "saved_mb": round(summ.total_saved / 2**20, 1),
            "chunk_p50_s": round(per_chunk[len(per_chunk) // 2], 3)
            if per_chunk else None,
            "chunk_p99_s": round(
                per_chunk[min(len(per_chunk) - 1,
                              int(len(per_chunk) * 0.99))], 3)
            if per_chunk else None,
            "chunk_rate_min": round(rates[0], 1) if rates else None,
            "chunk_rate_max": round(rates[-1], 1) if rates else None,
            "host_rss_mb": round(rss_mb, 1),
        }
        print(json.dumps(out))


if __name__ == "__main__":
    main()
