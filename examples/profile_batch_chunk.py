"""Where a warm 64-image chunk of the batch path spends device time.

    python examples/profile_batch_chunk.py [OUT_DIR]

Needs a GPU.  Three measurements, printed and written to
OUT_DIR/profile_batch_chunk.json (default chiprun_out/):

  1. A jax.profiler trace of compress_batch on 64 warm 500x500 JPEG
     files (Balanced, fused).  Kernels are grouped by HLO module, and a
     kernel counts as SSIM when its fused computation holds an op from
     the "ssim" name scope (engine/compress._bisect_device_batch), read
     from XLA's optimized-HLO dump.
  2. The windowed SSIM of one probe alone (64 pairs at 500x500, a-side
     statistics hoisted as in the search), timed against its memory
     bound: the bytes it must read, over 3.35 TB/s.
  3. The two emission assembly routes (one-hot matmul and windowed
     gather) on the same 64-image chunk, timed and checked equal.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
N, SIDE = 64, 500


def _fusion_scopes(dump_dir: str):
    """{(module, instruction): True if its computation uses ssim ops}
    from XLA's after-optimizations HLO text dumps."""
    out = {}
    for path in glob.glob(os.path.join(dump_dir, "*after_optimizations.txt")):
        text = open(path).read()
        mod = re.search(r"^HloModule (\S+?)[,\s]", text, re.M)
        mod = mod.group(1) if mod else os.path.basename(path)
        comps, cur, name = {}, [], None
        for line in text.splitlines():
            m = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
            if m and not line.startswith(" "):
                name, cur = m.group(1), []
                continue
            if line.startswith("}"):
                if name is not None:
                    comps[name] = cur
                name = None
                continue
            if name is not None:
                cur.append(line)

        def uses_ssim(comp, seen=()):
            body = comps.get(comp, [])
            if any("/ssim/" in l for l in body):
                return True
            for l in body:
                for c in re.findall(r"calls=%?([\w.\-]+)", l):
                    if c not in seen and uses_ssim(c, seen + (comp,)):
                        return True
            return False

        for lines in comps.values():
            for l in lines:
                m = re.match(r"\s*(?:ROOT )?%?([\w.\-]+) = .*", l)
                if not m:
                    continue
                calls = re.findall(r"calls=%?([\w.\-]+)", l)
                ssim = "/ssim/" in l or any(uses_ssim(c) for c in calls)
                out[(mod, m.group(1))] = ssim
    return out


def trace_chunk(srcs, tmp: str, dump_dir: str) -> dict:
    from jax.profiler import ProfileData

    import fennec_tpu as fennec
    from fennec_tpu.utils.profiling import device_trace

    def run(tag):
        items = [fennec.BatchItem(src=s, dst=os.path.join(tmp, f"{tag}{i}"))
                 for i, s in enumerate(srcs)]
        res = fennec.compress_batch(None, items, fennec.BatchOptions(
            fused=True,
            default_opts=fennec.Options(format=fennec.Format.JPEG)))
        assert all(r.err is None for r in res)

    run("a")
    run("b")
    tdir = os.path.join(tmp, "trace")
    t0 = time.perf_counter()
    with device_trace(tdir):
        run("c")
    wall = time.perf_counter() - t0
    path = glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb"))[0]
    scopes = _fusion_scopes(dump_dir)
    per_mod = collections.Counter()
    ssim_mod = collections.Counter()
    kernels = collections.Counter()
    busy = []
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                mod = str(st.get("hlo_module", "?"))
                op = str(st.get("hlo_op", ev.name))
                per_mod[mod] += ev.duration_ns
                kernels[(mod, op)] += ev.duration_ns
                busy.append((ev.start_ns, ev.end_ns))
                if scopes.get((mod, op)):
                    ssim_mod[mod] += ev.duration_ns
    busy.sort()
    union, end = 0.0, None
    for s, e in busy:
        if end is None or s > end:
            union += e - s
            end = e
        elif e > end:
            union += e - end
            end = e
    span = (busy[-1][1] - busy[0][0]) if busy else 0
    return {
        "wall_s": wall,
        "device_busy_ms": union / 1e6,
        "device_span_ms": span / 1e6,
        "modules_ms": {k: v / 1e6 for k, v in per_mod.most_common()},
        "ssim_ms_by_module": {k: v / 1e6 for k, v in ssim_mod.items()},
        "top_kernels_ms": [[m, o, v / 1e6, bool(scopes.get((m, o)))]
                           for (m, o), v in kernels.most_common(40)],
        "hlo_dumps": len(glob.glob(os.path.join(dump_dir, "*.txt"))),
    }


def _time(fn, *args, iters=20):
    fn(*args).block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def ssim_probe_bound() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fennec_tpu.ops.ssim import ssim_map_device_pre, ssim_premaps_device

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.uniform(0, 255, (N, SIDE, SIDE)), jnp.float32)
    b = jnp.asarray(np.asarray(a) + rng.normal(0, 3, (N, SIDE, SIDE)),
                    jnp.float32)
    pre = jax.jit(jax.vmap(ssim_premaps_device))(a)

    @jax.jit
    def probe(pre, a, b):
        return jax.vmap(lambda p, x, y: jnp.mean(
            ssim_map_device_pre(p, x, y)))(pre, a, b)

    t = _time(probe, pre, a, b)
    nbytes = (pre.size + a.size + b.size) * 4
    return {"probe_ms": t * 1e3, "bytes_read": nbytes,
            "memory_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "times_bound": t / (nbytes / HBM_BYTES_PER_S)}


def assembly_routes() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from fennec_tpu.ops import jpeg_emit
    from fennec_tpu.parallel.batched import (
        batched_emit_std,
        batched_search_and_quantize,
        packed_hist_bits,
    )

    imgs = jnp.asarray(bench.photo_batch(N, SIDE, SIDE).astype(np.uint8))
    _, _, _, packed, _ = batched_search_and_quantize(
        imgs, jnp.full((N,), 0.94, jnp.float32), True)
    bits = int(np.asarray(packed_hist_bits(packed, SIDE, SIDE, True))[:, 0]
               .max())
    mw = jpeg_emit.emit_words_for_bits(bits)
    lw = jpeg_emit.EMIT_LWORDS
    out = {"max_words": mw, "lwords": lw,
           "onehot_elements": N * packed.shape[1] * mw,
           "onehot_cap": jpeg_emit.emit_onehot_cap()}
    words = {}
    saved = jpeg_emit._MATMUL_ASSEMBLE_LIMIT
    for route, limit in (("matmul", saved), ("window", 0)):
        jpeg_emit._MATMUL_ASSEMBLE_LIMIT = limit
        jax.clear_caches()

        def emit(p):
            return batched_emit_std(p, SIDE, SIDE, True, mw, lw)

        t = _time(emit, packed, iters=10)
        words[route] = np.asarray(emit(packed))
        out[f"{route}_ms"] = t * 1e3
    jpeg_emit._MATMUL_ASSEMBLE_LIMIT = saved
    out["routes_equal"] = bool(np.array_equal(words["matmul"],
                                              words["window"]))
    return out


def main() -> int:
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tmp = tempfile.mkdtemp()
    dump = os.path.join(tmp, "hlo")
    # Command buffers (CUDA graphs) would show each program as one
    # event; without them the trace has one event per kernel.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_dump_to={dump} --xla_dump_hlo_as_text"
        " --xla_dump_hlo_module_re=.*search.*"
        " --xla_gpu_enable_command_buffer=").strip()
    sys.path.insert(0, REPO)
    import jax

    import bench

    # A persistent-cache hit compiles nothing and so dumps no HLO.
    jax.config.update("jax_enable_compilation_cache", False)
    devs = bench.require_gpu()
    from chip_smoke import card_line

    report = {"device": devs[0].device_kind, "card": card_line()}
    srcs = bench.write_jpeg_fixtures(tmp, N, SIDE, SIDE)
    report["trace"] = trace_chunk(srcs, tmp, dump)
    report["ssim_probe"] = ssim_probe_bound()
    report["assembly"] = assembly_routes()
    print(json.dumps(report, indent=1))
    with open(os.path.join(out_dir, "profile_batch_chunk.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
