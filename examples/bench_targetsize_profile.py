"""Stage profile of the batched target-size engine.

Times S1 / S3 separately and the full hit_target_size_batched, n=32 at
500x500 -> 20 KB (Format.JPEG: S2 skipped), so the win from concurrent
strategy speculation and any remaining serial term is visible.
"""

import json
import sys
import time

import numpy as np


def main() -> None:
    sys.path.insert(0, ".")
    import bench
    from fennec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import concurrent.futures

    import jax.numpy as jnp

    from fennec_tpu.engine import targetsize_batched as tb
    from fennec_tpu.types import Format, Options

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    target = 20_000
    arrs = [bench.photo_batch(1, 500, 500, seed=i)[0].astype(np.uint8)
            for i in range(n)]
    opts = Options(format=Format.JPEG, target_size=target)

    # Warm all programs once.
    tb.hit_target_size_batched(None, arrs, target, opts)

    pool = concurrent.futures.ThreadPoolExecutor(16)
    stack_dev = jnp.asarray(np.stack(arrs))
    jpeg_idx = list(range(n))
    h, w = 500, 500

    t0 = time.perf_counter()
    s1 = tb._s1_batched(pool, stack_dev, arrs, h, w, target, jpeg_idx)
    t_s1 = time.perf_counter() - t0

    t0 = time.perf_counter()
    s3 = tb._s3_batched(None, pool, stack_dev, arrs, h, w, target,
                        jpeg_idx)
    t_s3 = time.perf_counter() - t0
    pool.shutdown()

    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = tb.hit_target_size_batched(None, arrs, target, opts)
        ts.append(time.perf_counter() - t0)
    t_full = min(ts)
    over = sum(1 for r in res if len(r.data) > target)

    print(json.dumps({
        "n": n,
        "s1_s": round(t_s1, 2),
        "s3_s": round(t_s3, 2),
        "full_s_best": round(t_full, 2),
        "full_s_all": [round(t, 2) for t in ts],
        "images_per_sec": round(n / t_full, 2),
        "over_target": over,
        "s1_wins": sum(1 for r in res if r.final_w == w),
    }))


if __name__ == "__main__":
    main()
