"""fennec-tpu benchmark — prints ONE JSON line.  Needs a GPU.

Headline metric: CompressBatch file→file (Balanced preset, 500×500
photographic JPEGs) in images/sec/chip — the BASELINE.json north-star
workload, end to end: read + entropy-decode inputs, all-on-device
reconstruct → SSIM-guided bisection → re-quantize, optimized-Huffman
encode, write outputs.  The in-memory CompressImage rate rides along in
the detail field.

Baseline: the reference does ~22 images/sec/core for CompressImage
(Balanced, 500×500) on Apple M2 (BASELINE.md: 45 ms/image).
"""

import json
import os
import time

import numpy as np

BASELINE_IMAGES_PER_SEC = 22.0  # reference README.md:317 → 1 / 45ms


def photo_batch(b, w, h, seed=0):
    """Photographic-looking batch: smooth gradients + low-freq noise.

    Fully vectorized — per-image Python loops cost ~1s/image at 500² on a
    single-core host.
    """
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([
        (x * 255 / w), (y * 255 / h), ((x + y) * 255 / (w + h))],
        axis=-1).astype(np.float32)  # (h, w, 3)
    bh, bw = h // 8 + 1, w // 8 + 1
    noise = rng.normal(0, 10, (b, bh, bw, 3)).astype(np.float32)
    noise = noise.repeat(8, axis=1).repeat(8, axis=2)[:, :h, :w]
    tint = rng.uniform(-30, 30, (b, 1, 1, 3)).astype(np.float32)
    out = np.empty((b, h, w, 4), dtype=np.float32)
    out[..., :3] = np.clip(base[None] + noise + tint, 0, 255)
    out[..., 3] = 255.0
    return out


def write_jpeg_fixtures(tmp, n_files, w=500, h=500, quality=92):
    """Write n_files JPEG inputs using ONE batched device pass per chunk
    of 32 (one dispatch per chunk instead of one per image)."""
    import jax
    import jax.numpy as jnp

    from fennec_tpu.codecs.jpeg import (
        assemble_jpeg,
        encode_scan_from_quantized,
        forward_dct_device,
    )
    from fennec_tpu.ops.dct import all_quality_tables, quantize_blocks

    qtabs = all_quality_tables()[quality]

    # qt rides as an argument, not a closure, so the program does not
    # embed a device array as a constant.
    @jax.jit
    def encode_batch(imgs, qt_dev):
        def one(im):
            cy, ccb, ccr = forward_dct_device(im.astype(jnp.float32), True)
            return jnp.concatenate([
                quantize_blocks(cy, qt_dev[0]),
                quantize_blocks(ccb, qt_dev[1]),
                quantize_blocks(ccr, qt_dev[1])], axis=0).astype(jnp.int16)
        return jax.vmap(one)(imgs)

    ph, pw = h + (-h) % 16, w + (-w) % 16
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16)
    paths = []
    chunk = 32
    for start in range(0, n_files, chunk):
        count = min(chunk, n_files - start)
        imgs = photo_batch(count, w, h, seed=start).astype(np.uint8)
        if count < chunk:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[:1], chunk - count, axis=0)])
        packed = np.asarray(encode_batch(
            jnp.asarray(imgs), jnp.asarray(qtabs, dtype=jnp.float32)))
        for j in range(count):
            i = start + j
            qy = packed[j, :ny].astype(np.int32)
            qcb = packed[j, ny:ny + nc].astype(np.int32)
            qcr = packed[j, ny + nc:].astype(np.int32)
            scan = encode_scan_from_quantized(qy, qcb, qcr, ph, pw, True)
            data = assemble_jpeg(w, h, qtabs, scan, True)
            path = os.path.join(tmp, f"in{i}.jpg")
            with open(path, "wb") as f:
                f.write(data)
            paths.append(path)
    return paths


def require_gpu():
    """Return the JAX devices, or exit non-zero unless they are GPUs.
    Prints the device kind and count first, so every result names the
    device it was measured on."""
    import jax

    devs = jax.devices()
    print(f"device: platform={devs[0].platform} "
          f"kind={devs[0].device_kind} count={len(devs)}", flush=True)
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"bench: needs a GPU, JAX found {devs[0].platform!r}")
    return devs


def main():
    from fennec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    platform = require_gpu()[0].platform

    B, W, H = 32, 500, 500
    imgs_np = photo_batch(B, W, H).astype(np.uint8)

    import fennec_tpu as fennec
    from fennec_tpu.engine.batched import compress_images_batched

    # ── North-star workload FIRST: CompressBatch over real files ──
    import tempfile

    # 512 files (8 pipelined chunks): enough to measure the steady-state
    # pipeline rate rather than the 2-chunk ramp — the BASELINE.md
    # north-star workload is a 10k-photo batch, so steady state is the
    # faithful number (examples/bench_sustained.py runs the 10k).
    batch_n = 512
    with tempfile.TemporaryDirectory() as tmp:
        srcs = write_jpeg_fixtures(tmp, batch_n)
        bopts = fennec.BatchOptions(
            fused=True,
            default_opts=fennec.Options(format=fennec.Format.JPEG))

        def run_batch(tag):
            its = [fennec.BatchItem(
                src=s, dst=os.path.join(tmp, f"{tag}{i}.jpg"))
                for i, s in enumerate(srcs)]
            t0 = time.perf_counter()
            res = fennec.compress_batch(None, its, bopts)
            dt = time.perf_counter() - t0
            ok = sum(1 for r in res if r.err is None)
            return dt, ok, res

        run_batch("w")  # warm every chunk shape
        # Best-of-N with adaptive N: at least 3 passes, then keep going
        # while the best keeps improving ≥3% and a 150 s wall budget
        # remains.  The best pass measures the pipeline, the median a
        # typical run.  Both are reported.
        passes = []
        budget_t0 = time.perf_counter()
        t = 0
        while True:
            passes.append(run_batch(f"o{t}"))
            t += 1
            if t < 3:
                continue
            spent = time.perf_counter() - budget_t0
            if spent > 150 or t >= 8:
                break
            best = min(p[0] for p in passes)
            prev_best = min(p[0] for p in passes[:-1])
            if not (best < prev_best * 0.97):
                break
        passes.sort(key=lambda p: p[0])
        dt, ok, res = passes[0]
        median_dt = passes[len(passes) // 2][0]
        batch_ips = batch_n / dt
        median_ips = batch_n / median_dt
        batch_ssim = fennec.summarize(res).avg_ssim

    # In-memory phase: the public pixel-path engine (device search +
    # entropy coding on the arm backend.device_entropy_default picks).
    rounds = 8
    images = [imgs_np[i % B] for i in range(B * rounds)]
    opts = fennec.Options(format=fennec.JPEG)
    compress_images_batched(None, images[:B * 2], opts)  # warm chunks

    # Best of 3, same policy as the file phase above.
    total_images = len(images)
    elapsed = float("inf")
    for _ in range(3):
        start = time.perf_counter()
        rs = compress_images_batched(None, images, opts)
        elapsed = min(elapsed, time.perf_counter() - start)
    total_bytes = sum(r.compressed_size for r in rs)
    in_memory_ips = total_images / elapsed
    mean_ssim = float(np.mean([r.ssim for r in rs[:B]]))
    avg_bytes = int(total_bytes / total_images)

    from fennec_tpu.engine import batched as _eb
    from fennec_tpu.ops import jpeg_emit as _je

    result = {
        "metric": "compress_batch_balanced_500px_images_per_sec",
        "value": round(batch_ips, 2),
        "unit": "images/sec/chip",
        "vs_baseline": round(batch_ips / BASELINE_IMAGES_PER_SEC, 2),
        "detail": {
            "platform": platform,
            "batch_files": batch_n,
            "batch_succeeded": ok,
            "best_images_per_sec": round(batch_ips, 2),
            "median_images_per_sec": round(median_ips, 2),
            "batch_mean_ssim": round(batch_ssim, 4),
            "in_memory_images_per_sec": round(in_memory_ips, 2),
            "in_memory_mean_ssim": round(mean_ssim, 4),
            "avg_bytes": avg_bytes,
            # The engine defaults this number was measured under, so a
            # stray env override or a changed default is visible in the
            # record.
            "engine_config": {
                "chunk": _eb.BATCH_CHUNK,
                "stage_workers": _eb.STAGE_WORKERS,
                "fused_opt": _eb.FUSED_OPT,
                "emit_lwords": _je.EMIT_LWORDS,
                "pixel_wire": _eb.PIXEL_WIRE,
                "upload": os.environ.get("FENNEC_UPLOAD", "auto"),
            },
        },
    }
    if ok < batch_n:
        # A partially-failed batch is a DEGRADED run, not a slow one —
        # say so outright instead of letting a 0-success pass masquerade
        # as a throughput number (the round-3 bench did exactly that).
        result["note"] = (
            f"DEGRADED: only {ok}/{batch_n} files succeeded — the "
            f"throughput value measures a failing run; see stderr "
            f"warnings")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
