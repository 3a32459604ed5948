#!/usr/bin/env python3
"""Smoke test of fennec-tpu on one GPU: ops against their plain
references, then the main path and every other entry point at the sizes
users run, all in one process that holds one JAX client.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: sharded batch vs one GPU
    python chip_smoke.py --rehearse # CPU, tiny sizes, no result line

Phases (each one raises on failure; any failure exits non-zero):

  device  the platform must be "gpu" and the C++ host library must load;
  ops     SSIMFast at 1920x1080 and windowed SSIM at 500x500 against the
          float64 oracle, forward/inverse DCT against numpy float64,
          Lanczos-3 4032x3024 -> 1920 wide against float64 weights, and
          the lockstep quality search on the GPU against the CPU backend;
  batch   compress_batch on 512 500x500 JPEGs with both entropy arms:
          512/512 ok, SSIM >= 0.94, outputs decode, arms byte-identical;
  entry   compress_file (resize, target size), compress_images_batched
          and the CLI, in-process.

The last line of a full run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

BALANCED_TARGET = 0.94


@dataclasses.dataclass(frozen=True)
class Sizes:
    ssim_fast: tuple = (1920, 1080)
    ssim_win: int = 500
    dct: tuple = (1920, 1080)
    resize_src: tuple = (4032, 3024)
    resize_dst_w: int = 1920
    search_n: int = 16
    side: int = 500
    batch_n: int = 512
    in_memory_n: int = 64
    phone: tuple = (4032, 3024)
    phone_max_w: int = 1920


FULL = Sizes()
TINY = Sizes(ssim_fast=(600, 340), ssim_win=64, dct=(64, 48),
             resize_src=(96, 72), resize_dst_w=40, search_n=4, side=48,
             batch_n=8, in_memory_n=8, phone=(160, 120), phone_max_w=96)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every card, joined."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({e})"
    if r.returncode != 0:
        return f"not available (exit {r.returncode}: {r.stderr.strip()})"
    return "; ".join(x.strip() for x in r.stdout.splitlines() if x.strip())


# ── device ──────────────────────────────────────────────────────────────


def phase_device(rehearse: bool):
    import jax

    from fennec_tpu.native import native_available
    from fennec_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = jax.devices()
    log(f"device: platform={devs[0].platform} "
        f"kind={devs[0].device_kind} count={len(devs)}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {cache}")
    card = card_line()
    log(f"nvidia-smi: {card}")
    if not rehearse:
        check(devs[0].platform == "gpu",
              f"needs a GPU; JAX found platform {devs[0].platform!r}")
    check(native_available(),
          "the C++ host library (fennec_tpu/native) did not build or load")
    return devs, card


# ── ops against their plain references ──────────────────────────────────


def _photo(w: int, h: int, seed: int) -> np.ndarray:
    from bench import photo_batch

    return photo_batch(1, w, h, seed=seed)[0].astype(np.uint8)


def _perturb(img: np.ndarray, amount: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = img.astype(np.float64)
    out[..., :3] += rng.normal(0, amount, out[..., :3].shape)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _report(name: str, err: float, bound: float) -> None:
    log(f"  {name}: max |diff| = {err:.3e} (bound {bound:g})")
    check(err <= bound, f"{name}: {err:.3e} exceeds {bound:g}")


def op_ssim(sz: Sizes) -> None:
    import oracles

    from fennec_tpu.ops.color import luminance_device
    from fennec_tpu.ops.ssim import ssim_fast, windowed_ssim_device

    w, h = sz.ssim_fast
    a = _photo(w, h, 1)
    b = _perturb(a, 6.0, 2)
    got = ssim_fast(a, b)
    want = oracles.ssim_fast(a, b)
    log(f"  SSIMFast {w}x{h}: device {got:.6f} oracle {want:.6f}")
    _report(f"SSIMFast {w}x{h}", abs(got - want), 1e-4)

    n = sz.ssim_win
    a = _photo(n, n, 3)
    b = _perturb(a, 8.0, 4)
    got = float(windowed_ssim_device(
        luminance_device(np.asarray(a, np.float32)),
        luminance_device(np.asarray(b, np.float32))))
    want = oracles.windowed_ssim(oracles.luminance(a), oracles.luminance(b))
    log(f"  windowed SSIM {n}x{n}: device {got:.6f} oracle {want:.6f}")
    _report(f"windowed SSIM {n}x{n}", abs(got - want), 1e-4)


def op_dct(sz: Sizes) -> None:
    import jax.numpy as jnp

    from fennec_tpu.ops import dct as dct_ops

    w, h = sz.dct
    plane = _photo(w, h, 5)[..., 1].astype(np.float64) - 128.0
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(
        0, 2, 1, 3).reshape(-1, 8, 8)
    d = dct_ops.dct_matrix()
    want = np.einsum("ki,nij,lj->nkl", d, blocks, d).reshape(-1, 64)
    got = np.asarray(dct_ops.dct2d_blocks(
        jnp.asarray(blocks.reshape(-1, 64), jnp.float32)), np.float64)
    _report(f"forward DCT {w}x{h}", float(np.abs(got - want).max()), 1e-3)
    back = np.einsum("ki,nkl,lj->nij", d, want.reshape(-1, 8, 8),
                     d).reshape(-1, 64)
    got = np.asarray(dct_ops.idct2d_blocks(
        jnp.asarray(want, jnp.float32)), np.float64)
    _report(f"inverse DCT {w}x{h}", float(np.abs(got - back).max()), 1e-3)


def op_resize(sz: Sizes) -> None:
    from fennec_tpu.ops.filters import lanczos_weights
    from fennec_tpu.ops.resize import lanczos_resize, smart_resize_dims

    sw, sh = sz.resize_src
    dw, dh = smart_resize_dims(sw, sh, sz.resize_dst_w, 0)
    img = _photo(sw, sh, 6)
    got = lanczos_resize(img, dw, dh).astype(np.float64)
    check(got.shape == (dh, dw, 4), f"resize shape {got.shape}")
    # The float64 reference on 64 output rows spread over the image, at
    # full width (opaque input: premultiplied alpha is the identity).
    rows = np.linspace(0, dh - 1, min(64, dh)).astype(int)
    wh = lanczos_weights(dw, sw)
    wv = lanczos_weights(dh, sh)[rows]
    src = img[..., :3].astype(np.float64)
    want = np.einsum("rh,hwc->rwc", wv, src)
    want = np.clip(np.einsum("rwc,Dw->rDc", want, wh), 0.0, 255.0)
    err = float(np.abs(got[rows, :, :3] - want).max())
    # The output is rounded to integers: a correct result is within 0.5,
    # plus float32 error where the float64 value sits at a .5 tie.
    _report(f"Lanczos-3 {sw}x{sh} -> {dw}x{dh}", err, 0.5 + 1e-3)


def op_search(sz: Sizes) -> None:
    import jax
    import jax.numpy as jnp

    from bench import photo_batch
    from fennec_tpu.parallel.batched import batched_quality_search

    n, side = sz.search_n, sz.side
    imgs = photo_batch(n, side, side, seed=7).astype(np.float32)
    targets = np.full((n,), BALANCED_TARGET, np.float32)
    out = {}
    for name, dev in (("default", jax.devices()[0]),
                      ("cpu", jax.devices("cpu")[0])):
        x = jax.device_put(jnp.asarray(imgs), dev)
        t = jax.device_put(jnp.asarray(targets), dev)
        q, s, f = batched_quality_search(x, t, True)
        out[name] = (np.asarray(q), np.asarray(s), np.asarray(f))
    (qg, sg, fg), (qc, sc, fc) = out["default"], out["cpu"]
    near = (np.abs(sg - targets) < 1e-4) & (np.abs(sc - targets) < 1e-4)
    differ = qg != qc
    log(f"  lockstep search {n}x{side}^2: qualities {qg.tolist()}")
    log(f"  lockstep search: {int(differ.sum())} quality differences "
        f"from the CPU backend, {int((differ & near).sum())} of them "
        f"within 1e-4 of the target; max |SSIM diff| "
        f"{float(np.abs(sg - sc).max()):.3e}")
    check(not np.any(differ & ~near),
          f"search qualities differ from the CPU backend: {qg} vs {qc}")
    check(bool(np.all(fg == fc)), "search found-flags differ from CPU")


def phase_ops(sz: Sizes) -> None:
    log("phase ops:")
    op_ssim(sz)
    op_dct(sz)
    op_resize(sz)
    op_search(sz)


# ── the main path: compress_batch file to file ──────────────────────────


def _run_batch(srcs, out_dir: str, tag: str, **opt_kw):
    """compress_batch over srcs (fused, Balanced JPEG); returns
    (seconds, results, output bytes).  A fennec warning (the fused path
    falling back to the per-file pool) fails the phase."""
    import fennec_tpu as fennec

    items = [fennec.BatchItem(src=s, dst=os.path.join(out_dir,
                                                      f"{tag}{i}.jpg"))
             for i, s in enumerate(srcs)]
    bopts = fennec.BatchOptions(
        fused=True,
        default_opts=fennec.Options(format=fennec.Format.JPEG, **opt_kw))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        res = fennec.compress_batch(None, items, bopts)
        dt = time.perf_counter() - t0
    bad = [str(w.message) for w in caught if "fennec" in str(w.message)]
    check(not bad, f"compress_batch warned: {bad[:3]}")
    errs = [str(r.err) for r in res if r.err is not None]
    check(not errs, f"{len(errs)} items failed: {errs[:3]}")
    outs = []
    for it in items:
        with open(it.dst, "rb") as f:
            outs.append(f.read())
    return dt, res, outs


def _check_outputs(res, outs, side: int) -> None:
    from fennec_tpu.codecs.jpeg import decode_jpeg

    ssims = np.array([r.result.ssim for r in res])
    check(bool(np.all(ssims >= BALANCED_TARGET)),
          f"SSIM below {BALANCED_TARGET}: min {ssims.min():.4f}")
    for data in outs:
        img = decode_jpeg(data)
        check(img.shape == (side, side, 4), f"decoded shape {img.shape}")
    log(f"  {len(res)}/{len(res)} ok, SSIM min {ssims.min():.4f} "
        f"mean {ssims.mean():.4f}, all {len(outs)} outputs decode at "
        f"{side}x{side}")


def phase_batch(sz: Sizes, srcs, tmp: str, card: str) -> None:
    import jax

    from fennec_tpu.parallel.batched import batched_quality_search

    log(f"phase batch: compress_batch, {len(srcs)} files of "
        f"{sz.side}x{sz.side}, Balanced, fused")
    outs_by_arm, rates = {}, {}
    for arm in (False, True):
        name = "device" if arm else "host"
        _run_batch(srcs, tmp, f"w{name}", device_entropy=arm)
        dt, res, outs = _run_batch(srcs, tmp, f"o{name}",
                                   device_entropy=arm)
        rates[name] = len(srcs) / dt
        log(f"  entropy arm {name}: {len(srcs)} files in {dt:.3f} s = "
            f"{rates[name]:.2f} img/s [{card}]")
        _check_outputs(res, outs, sz.side)
        outs_by_arm[name] = outs
    same = sum(a == b for a, b in zip(outs_by_arm["host"],
                                      outs_by_arm["device"]))
    log(f"  entropy arms byte-identical: {same}/{len(srcs)}")
    check(same == len(srcs), "device and host entropy arms differ")

    n = min(64, len(srcs))
    shape = jax.ShapeDtypeStruct((n, sz.side, sz.side, 4), np.float32)
    tgt = jax.ShapeDtypeStruct((n,), np.float32)
    mem = batched_quality_search.lower(shape, tgt, True).compile() \
        .memory_analysis()
    log(f"  memory_analysis of the {n}-image search program: {mem}")


# ── the other entry points ──────────────────────────────────────────────


def phase_entry(sz: Sizes, srcs, tmp: str) -> None:
    import fennec_tpu as fennec
    from bench import photo_batch
    from fennec_tpu.cli import main as cli_main
    from fennec_tpu.codecs.jpeg import decode_jpeg, encode_jpeg
    from fennec_tpu.ops.resize import smart_resize_dims

    log("phase entry:")
    pw, ph = sz.phone
    phone = os.path.join(tmp, "phone.jpg")
    with open(phone, "wb") as f:
        f.write(encode_jpeg(photo_batch(1, pw, ph, seed=11)[0]
                            .astype(np.uint8), 92))
    dw, dh = smart_resize_dims(pw, ph, sz.phone_max_w, 0)

    out = os.path.join(tmp, "phone_out.jpg")
    t0 = time.perf_counter()
    r = fennec.compress_file(None, phone, out, fennec.Options(
        format=fennec.Format.JPEG, max_width=sz.phone_max_w))
    dt = time.perf_counter() - t0
    with open(out, "rb") as f:
        img = decode_jpeg(f.read())
    check(img.shape[:2] == (dh, dw), f"resized output {img.shape}")
    check(r.ssim >= BALANCED_TARGET, f"resized SSIM {r.ssim:.4f}")
    log(f"  compress_file {pw}x{ph} max_width={sz.phone_max_w}: "
        f"{dw}x{dh}, {r.compressed_size} B, q={r.jpeg_quality}, "
        f"SSIM {r.ssim:.4f}, {dt:.3f} s (first call, compile included)")

    budget = 100 * 1024
    out = os.path.join(tmp, "phone_budget.jpg")
    r = fennec.compress_file(None, phone, out, fennec.Options(
        format=fennec.Format.JPEG, max_width=sz.phone_max_w,
        target_size=budget))
    size = os.path.getsize(out)
    check(size <= budget, f"target_size: {size} B over {budget} B")
    log(f"  compress_file target_size={budget}: {size} B, "
        f"q={r.jpeg_quality}, SSIM {r.ssim:.4f}")

    from fennec_tpu.codecs.jpeg import decode_jpeg as _dec
    from fennec_tpu.engine.batched import compress_images_batched

    images = []
    for s in srcs[:sz.in_memory_n]:
        with open(s, "rb") as f:
            images.append(_dec(f.read()))
    rs = compress_images_batched(None, images, fennec.Options(
        format=fennec.Format.JPEG))
    ssims = np.array([x.ssim for x in rs])
    check(len(rs) == len(images) and all(x.compressed_size > 0 for x in rs),
          "compress_images_batched returned empty results")
    check(bool(np.all(ssims >= BALANCED_TARGET)),
          f"in-memory SSIM min {ssims.min():.4f}")
    log(f"  compress_images_batched {len(images)} images: SSIM min "
        f"{ssims.min():.4f}")

    out = os.path.join(tmp, "cli_q.jpg")
    rc = cli_main([srcs[0], out, "--quality", "balanced"])
    check(rc == 0 and os.path.getsize(out) > 0, f"CLI --quality rc={rc}")
    out = os.path.join(tmp, "cli_t.jpg")
    rc = cli_main([phone, out, "--target-size", "50KB",
                   "--max-width", str(sz.phone_max_w)])
    size = os.path.getsize(out) if os.path.exists(out) else -1
    check(rc == 0 and 0 < size <= 50 * 1024,
          f"CLI --target-size 50KB rc={rc} size={size}")
    log(f"  CLI --quality balanced ok; --target-size 50KB: {size} B")


# ── four cards ──────────────────────────────────────────────────────────


def phase_four(sz: Sizes, srcs, tmp: str, card: str,
               rehearse: bool) -> None:
    from fennec_tpu.parallel.batched import data_mesh

    log(f"phase four: compress_batch, {len(srcs)} files, Mesh('data') "
        f"over every device vs one device")
    outs, rates = {}, {}
    # Virtual CPU devices shard only when asked (backend.data_mesh_devices).
    on = "1" if rehearse else None
    for name, flag in (("mesh", on), ("one", "0")):
        if flag is None:
            os.environ.pop("FENNEC_MESH", None)
        else:
            os.environ["FENNEC_MESH"] = flag
        mesh = data_mesh()
        check((mesh is not None) == (name == "mesh"),
              f"{name}: data_mesh() = {mesh}")
        _run_batch(srcs, tmp, f"w{name}")
        dt, res, o = _run_batch(srcs, tmp, f"o{name}")
        rates[name] = len(srcs) / dt
        size = 1 if mesh is None else mesh.size
        log(f"  {name} ({size} device(s)): {dt:.3f} s = "
            f"{rates[name]:.2f} img/s [{card}]")
        _check_outputs(res, o, sz.side)
        outs[name] = o
    os.environ.pop("FENNEC_MESH", None)
    same = sum(a == b for a, b in zip(outs["mesh"], outs["one"]))
    log(f"  mesh vs one device byte-identical: {same}/{len(srcs)}")
    check(same == len(srcs), "sharded outputs differ from one device")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phase")
    p.add_argument("--rehearse", action="store_true",
                   help="CPU rehearsal at tiny sizes; prints no result")
    args = p.parse_args(argv)
    sz = TINY if args.rehearse else FULL

    devs, card = phase_device(args.rehearse)
    if args.four and not args.rehearse:
        check(len(devs) == 4, f"--four needs 4 devices, found {len(devs)}")
    from bench import write_jpeg_fixtures

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        srcs = write_jpeg_fixtures(tmp, sz.batch_n, sz.side, sz.side)
        log(f"fixtures: {len(srcs)} JPEGs of {sz.side}x{sz.side} in "
            f"{time.perf_counter() - t0:.1f} s")
        if args.four:
            phase_four(sz, srcs, tmp, card, args.rehearse)
        else:
            phase_ops(sz)
            phase_batch(sz, srcs, tmp, card)
            phase_entry(sz, srcs, tmp)
    if args.rehearse:
        log("rehearsal ok")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
