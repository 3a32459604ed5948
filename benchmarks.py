"""Extended benchmark suite (reference fennec_test.go:1127-1199 has 8 Go
benchmarks; BASELINE.json lists the configs).  Prints one JSON line
per benchmark.  `bench.py` remains the driver's single headline metric.

Usage: python benchmarks.py [name ...]   (default: all)
"""

import json
import os
import sys
import time

import numpy as np

from bench import photo_batch
from fennec_tpu.utils.compile_cache import enable_compile_cache


def _time(fn, warmup=1, iters=5):
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters


def bench_ssim_fast_1080p():
    """SSIMFast on 1920×1080 pairs, batched device-resident (BASELINE
    config 1 throughput; parity itself is tests/test_parity_1080p.py)."""
    import jax
    import jax.numpy as jnp

    from fennec_tpu.ops.color import luminance_device
    from fennec_tpu.ops.resize import box_downsample_device, box_resize_weights
    from fennec_tpu.ops.ssim import ssim_fast_dims, windowed_ssim_device

    B, W, H = 16, 1920, 1080
    dw, dh = ssim_fast_dims(W, H)
    wh, wv = box_resize_weights(W, H, dw, dh)
    wh_d = jnp.asarray(wh)
    wv_d = jnp.asarray(wv)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8))
    b = jnp.asarray(
        np.clip(np.asarray(a).astype(np.int16) + 6, 0, 255).astype(np.uint8))

    @jax.jit
    def eval_batch(x, y):
        def one(im1, im2):
            d1 = box_downsample_device(im1, wh_d, wv_d)
            d2 = box_downsample_device(im2, wh_d, wv_d)
            return windowed_ssim_device(luminance_device(d1),
                                        luminance_device(d2))
        return jax.vmap(one)(x, y)

    dt = _time(lambda: np.asarray(eval_batch(a, b)))
    ips = B / dt
    return {"metric": "ssim_fast_1080p_evals_per_sec_chip",
            "value": round(ips, 1), "unit": "evals/sec/chip",
            "vs_baseline": round(ips / 125.0, 2)}


def bench_ssim_fast_4k_batched():
    """Batched 4K SSIM evals/sec/chip (device arrays resident)."""
    import jax.numpy as jnp

    from fennec_tpu.ops.color import luminance_device
    from fennec_tpu.ops.resize import box_resize_weights
    from fennec_tpu.ops.ssim import ssim_fast_dims

    B, W, H = 16, 3840, 2160
    # SSIMFast path downsamples 4K → ≤512 first; model that cost too.
    from fennec_tpu.ops.resize import box_downsample_device
    dw, dh = ssim_fast_dims(W, H)
    wh, wv = box_resize_weights(W, H, dw, dh)
    wh_d = jnp.asarray(wh)
    wv_d = jnp.asarray(wv)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.integers(0, 256, (B, H, W, 4),
                                 dtype=np.uint8), dtype=jnp.float32)
    b = jnp.clip(a + 5.0, 0, 255)

    import jax

    @jax.jit
    def eval_batch(x, y):
        def one(im1, im2):
            d1 = box_downsample_device(im1, wh_d, wv_d)
            d2 = box_downsample_device(im2, wh_d, wv_d)
            from fennec_tpu.ops.ssim import windowed_ssim_device
            return windowed_ssim_device(luminance_device(d1),
                                        luminance_device(d2))
        return jax.vmap(one)(x, y)

    dt = _time(lambda: np.asarray(eval_batch(a, b)))
    ips = B / dt
    return {"metric": "ssim_fast_4k_evals_per_sec_chip", "value": round(ips, 1),
            "unit": "evals/sec/chip", "vs_baseline": round(ips / 50.0, 2)}


def bench_lanczos_resize():
    """Lanczos-3 4032×3024 → 1920px + Gaussian blur σ=2, batched
    device-resident (BASELINE config 2: megapixels/sec)."""
    import jax
    import jax.numpy as jnp

    from fennec_tpu.ops.effects import _gaussian_blur_device
    from fennec_tpu.ops.filters import gaussian_blur_kernel
    from fennec_tpu.ops.resize import lanczos_resize_device, resize_weights

    B, W, H = 4, 4032, 3024
    wh, wv = resize_weights(W, H, 1920, 1440)
    wh_d, wv_d = jnp.asarray(wh), jnp.asarray(wv)
    kern = jnp.asarray(gaussian_blur_kernel(2.0), dtype=jnp.float32)
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.integers(0, 256, (B, H, W, 4), dtype=np.uint8))

    @jax.jit
    def run(x):
        def one(im):
            return _gaussian_blur_device(
                lanczos_resize_device(im, wh_d, wv_d), kern)
        return jax.vmap(one)(x)

    # Force completion via a 4-byte readback (a full-output transfer
    # would pollute the resident metric).
    dt = _time(lambda: np.asarray(run(imgs)[0, 0, 0, 0]), iters=3)
    mpix = B * W * H / 1e6
    return {"metric": "lanczos_resize_blur_megapixels_per_sec_chip",
            "value": round(mpix / dt, 1), "unit": "MP/sec/chip",
            "vs_baseline": round((mpix / dt) / 83.0, 2)}


def bench_ms_ssim_4k():
    """MS-SSIM 5-scale on 4K pair + AdaptiveSharpen (BASELINE config 3)."""
    from fennec_tpu.ops import adaptive_sharpen, ms_ssim

    img = photo_batch(1, 3840, 2160)[0].astype(np.uint8)
    sharp = adaptive_sharpen(img, 0.3)
    dt = _time(lambda: ms_ssim(img, sharp), iters=3)
    return {"metric": "ms_ssim_4k_evals_per_sec", "value": round(1 / dt, 2),
            "unit": "evals/sec", "vs_baseline": None}


def bench_compress_balanced_100():
    """CompressBytes Balanced on a 100-photo set (BASELINE config 4)."""
    from fennec_tpu.engine.batched import compress_images_batched
    from fennec_tpu.types import Format, Options

    imgs = [photo_batch(1, 640, 480, seed=i)[0].astype(np.uint8)
            for i in range(100)]
    opts = Options(format=Format.JPEG)
    # Warm every chunk shape the timed run will use (compiles are
    # environment-dependent and cached; don't time them).
    compress_images_batched(None, imgs, opts)

    t0 = time.perf_counter()
    results = compress_images_batched(None, imgs, opts)
    dt = time.perf_counter() - t0
    ips = len(imgs) / dt
    mean_ssim = float(np.mean([r.ssim for r in results]))
    return {"metric": "compress_balanced_640px_images_per_sec",
            "value": round(ips, 1), "unit": "images/sec/chip",
            "vs_baseline": round(ips / 22.0, 2),
            "detail": {"mean_ssim": round(mean_ssim, 4)}}


def bench_target_size():
    """Full four-strategy target-size engine, 500×500 → 20 KB
    (reference TargetSize runs its encoder once per bisection step;
    here every probe is one fused device dispatch)."""
    from fennec_tpu.types import Format, Options

    import fennec_tpu as fennec

    img = photo_batch(1, 500, 500)[0].astype(np.uint8)
    opts = Options(format=Format.JPEG, target_size=20_000)
    fennec.compress_image(None, img, opts)  # warm/compile

    t0 = time.perf_counter()
    n = 4
    for _ in range(n):
        r = fennec.compress_image(None, img, opts)
    dt = (time.perf_counter() - t0) / n
    assert r.compressed_size <= 20_000
    return {"metric": "target_size_500px_images_per_sec",
            "value": round(1 / dt, 2), "unit": "images/sec/chip",
            "detail": {"bytes": r.compressed_size,
                       "quality": r.jpeg_quality}}


def bench_target_size_batch(n: int = 32):
    """Batched lockstep target-size engine over a 500×500 bucket
    (engine/targetsize_batched.py): vmapped S1 bisection + lockstep S3
    scale probes — dispatch count is per-GROUP, not per-image."""
    from fennec_tpu.engine.batched import compress_images_batched
    from fennec_tpu.types import Format, Options

    imgs = [photo_batch(1, 500, 500, seed=i)[0].astype(np.uint8)
            for i in range(n)]
    opts = Options(format=Format.JPEG, target_size=20_000)
    compress_images_batched(None, imgs, opts)  # warm/compile

    t0 = time.perf_counter()
    results = compress_images_batched(None, imgs, opts)
    dt = time.perf_counter() - t0
    ips = n / dt
    over = sum(1 for r in results if r.compressed_size > 20_000)
    return {"metric": "target_size_batch_500px_images_per_sec",
            "value": round(ips, 2), "unit": "images/sec/chip",
            "detail": {"n": n, "over_target": over,
                       "mean_quality": round(float(np.mean(
                           [r.jpeg_quality for r in results])), 1)}}


def bench_analyze():
    """Analyze 1000×1000 (reference: ~5ms on M2, README.md:318)."""
    from fennec_tpu.analyze import analyze

    img = photo_batch(1, 1000, 1000)[0].astype(np.uint8)
    dt = _time(lambda: analyze(img))
    return {"metric": "analyze_1mp_per_sec", "value": round(1 / dt, 1),
            "unit": "analyses/sec", "vs_baseline": round((1 / dt) / 200.0, 2)}


def bench_gaussian_blur():
    """GaussianBlur σ=2 on 500×500 (reference: ~3ms on M2, README.md:319)."""
    from fennec_tpu.ops import gaussian_blur

    img = photo_batch(1, 500, 500)[0].astype(np.uint8)
    dt = _time(lambda: gaussian_blur(img, 2.0))
    return {"metric": "gaussian_blur_500px_per_sec",
            "value": round(1 / dt, 1), "unit": "ops/sec",
            "vs_baseline": round((1 / dt) / 333.0, 2)}


def bench_adaptive_sharpen():
    """AdaptiveSharpen on 500×500 (reference benchmark set)."""
    from fennec_tpu.ops import adaptive_sharpen

    img = photo_batch(1, 500, 500)[0].astype(np.uint8)
    dt = _time(lambda: adaptive_sharpen(img, 0.5))
    return {"metric": "adaptive_sharpen_500px_per_sec",
            "value": round(1 / dt, 1), "unit": "ops/sec",
            "vs_baseline": None}


def bench_compress_batch_files(n_files: int = 200):
    """CompressBatch over real files: decode → search → encode → write
    (BASELINE config 5, scaled to n_files for wall-clock sanity)."""
    import tempfile

    import fennec_tpu as fennec

    with tempfile.TemporaryDirectory() as tmp:
        from bench import write_jpeg_fixtures

        srcs = write_jpeg_fixtures(tmp, n_files)
        items = [fennec.BatchItem(
            src=s, dst=os.path.join(tmp, f"out{i}.jpg"))
            for i, s in enumerate(srcs)]

        # format=JPEG routes the all-device coefficient fast path
        # (AUTO needs per-image pixel analysis).  Warm the compile cache
        # on a small prefix first.
        bopts = fennec.BatchOptions(
            fused=True,
            default_opts=fennec.Options(format=fennec.Format.JPEG))
        # Warm ALL chunk shapes the timed run uses (full pass once).
        fennec.compress_batch(None, items, bopts)

        t0 = time.perf_counter()
        results = fennec.compress_batch(None, items, bopts)
        dt = time.perf_counter() - t0
        summary = fennec.summarize(results)
        ips = n_files / dt
        return {"metric": "compress_batch_files_images_per_sec",
                "value": round(ips, 1), "unit": "images/sec/chip",
                "vs_baseline": round(ips / 22.0, 2),
                "detail": {"n": n_files,
                           "succeeded": summary.succeeded,
                           "avg_ssim": round(summary.avg_ssim, 4)}}


def bench_host_yuv_convert():
    """C++ fixed-point RGB→YCbCr 4:2:0 wire conversion (host-only —
    runs without a device; the in-memory wire's feeder cost)."""
    from fennec_tpu.native import rgb_to_yuv420

    stack = photo_batch(64, 500, 500).astype(np.uint8)[..., :3]
    out = rgb_to_yuv420(stack)
    if out is None:
        return {"metric": "host_yuv420_convert_mpix_per_sec",
                "error": "native runtime unavailable"}
    dt = _time(lambda: rgb_to_yuv420(stack), warmup=1, iters=3)
    mpix = 64 * 500 * 500 / 1e6
    return {"metric": "host_yuv420_convert_mpix_per_sec",
            "value": round(mpix / dt, 1), "unit": "MP/sec/core"}


def bench_host_decode_coo():
    """C++ one-pass JPEG entropy decode into the COO upload layout
    (host-only; the batch feeder's decode half)."""
    from fennec_tpu.codecs.jpeg import encode_jpeg
    from fennec_tpu.engine.batched import qualify_jpeg_bytes
    from fennec_tpu.codecs.jpeg import decode_jpeg_to_coefs_coo

    img = photo_batch(1, 500, 500).astype(np.uint8)[0]
    data = encode_jpeg(img, 92)
    w, h, _ = qualify_jpeg_bytes(data)
    ph, pw = h + (-h) % 16, w + (-w) % 16
    nt = (ph // 8) * (pw // 8) + 2 * (ph // 16) * (pw // 16)
    dc = np.zeros(nt, np.int8)
    pos = np.zeros((nt, 16), np.uint8)
    val = np.zeros((nt, 16), np.int8)

    def run():
        assert decode_jpeg_to_coefs_coo(data, dc, pos, val,
                                        16) is not None

    dt = _time(run, warmup=2, iters=20)
    return {"metric": "host_coo_decode_files_per_sec",
            "value": round(1 / dt, 1), "unit": "files/sec/core",
            "detail": {"file_bytes": len(data)}}


ALL = {
    "host_yuv_convert": bench_host_yuv_convert,
    "host_decode_coo": bench_host_decode_coo,
    "ssim_fast_1080p": bench_ssim_fast_1080p,
    "ssim_fast_4k": bench_ssim_fast_4k_batched,
    "lanczos": bench_lanczos_resize,
    "ms_ssim_4k": bench_ms_ssim_4k,
    "compress_100": bench_compress_balanced_100,
    "analyze": bench_analyze,
    "blur": bench_gaussian_blur,
    "adaptive_sharpen": bench_adaptive_sharpen,
    "compress_batch_files": bench_compress_batch_files,
    "target_size": bench_target_size,
    "target_size_batch": bench_target_size_batch,
}


def main():
    enable_compile_cache()
    names = sys.argv[1:] or list(ALL)
    for name in names:
        try:
            print(json.dumps(ALL[name]()))
        except Exception as e:
            print(json.dumps({"metric": name, "error": str(e)}))


if __name__ == "__main__":
    main()
