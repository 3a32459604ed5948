"""Target-file-size engine: four search strategies + candidate ranking.

Reference semantics (targetsize.go:26-348) with a device cost model:
the per-image forward DCT is computed once and cached; every quality probe
re-quantizes on device and pays only one host Huffman pass for the exact
byte size (the reference re-runs its full encoder per probe).

Strategies, in order (all candidates ranked by better_fit):
  S1 jpeg_quality_search   — binary search on quality, BPP-seeded bounds
  S2 quantize_strategy     — median-cut palette PNG at 256/128/64/32/16
  S3 jpeg_quality_scale_search — joint scale (binary + fixed grid) × quality
  S4 scale_search          — pure scale bisection (only if S1–S3 failed)
  fallback                 — Q=1 JPEG or best-effort PNG

Note on subsampling: the reference passes subsample=false here but its
stdlib encoder is fixed 4:2:0 anyway (io.go:157-169); fennec-tpu uses
4:2:0 in the size search to match the reference's actual byte behavior.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import png as png_codec
from ..codecs.jpeg import encode_jpeg_from_coefs, forward_dct_device
from ..image import is_opaque, to_nrgba_ref
from ..ops.quantize import apply_palette, median_cut, palette_to_nrgba
from ..ops.resize import box_downsample, lanczos_resize
from ..ops.ssim import compute_ssim_nrgba
from ..types import Context, Format, Options
from .compress import compress_png

MIN_JPEG_QUALITY = 20  # reference targetsize.go:14


@dataclasses.dataclass
class SizeResult:
    data: bytes
    format: Format
    quality: int = 0
    ssim: float = 0.0
    final_w: int = 0
    final_h: int = 0
    img: Optional[np.ndarray] = None
    # Deferred pixel fetch: batched engines keep candidate images
    # device-resident and only pull the RANKING WINNER's pixels
    # (materialize() is called on the chosen candidate).
    img_fetch: "Optional[object]" = None

    def materialize(self) -> "SizeResult":
        if self.img is None and self.img_fetch is not None:
            self.img = self.img_fetch()
        self.img_fetch = None
        return self


def _ctx_err(ctx: Optional[Context]) -> bool:
    return ctx is not None and ctx.done()


def _bpp_bounds(target_bytes: int, pixels: int) -> Tuple[int, int]:
    """Bits-per-pixel-seeded quality bounds (reference
    targetsize.go:131-143)."""
    target_bpp = target_bytes * 8 / max(1, pixels)
    lo, hi = 1, 100
    if target_bpp < 0.5:
        hi = 40
    elif target_bpp < 1.0:
        lo, hi = 10, 70
    elif target_bpp < 2.0:
        lo, hi = 30, 90
    elif target_bpp > 4.0:
        lo = 60
    return lo, hi


PROBE_LATTICE = 16


def probe_geometry(src_w: int, src_h: int, new_w: int,
                   new_h: int) -> Tuple[int, int]:
    """Snap a scale-probe geometry to a /16 lattice (capped at the source
    dims, floored at 16).

    Probes are approximations by design — the reference probes with a box
    downsample and re-verifies the winner with a real Lanczos+encode
    (targetsize.go:240-281), and the final encode here likewise re-runs the
    exact search at the exact geometry.  Snapping the PROBE geometry bounds
    the set of XLA programs the scale search can request: without it every
    binary-search midpoint mints a fresh (new_w, new_h) static shape and a
    fresh XLA compile; with it a 500² source can only ever ask
    for ~31 probe widths, all persistently cacheable."""
    def snap(v: int, cap: int) -> int:
        return min(cap, max(PROBE_LATTICE,
                            round(v / PROBE_LATTICE) * PROBE_LATTICE))

    return snap(new_w, src_w), snap(new_h, src_h)


@functools.lru_cache(maxsize=4096)
def _header_len(w: int, h: int) -> int:
    """JFIF container overhead for a 3-component 4:2:0 file — depends
    only on dimensions (DQT/DHT/SOF/SOS lengths are fixed)."""
    from ..codecs.jpeg import assemble_jpeg
    from ..ops.dct import all_quality_tables
    return len(assemble_jpeg(w, h, all_quality_tables()[50], b"", True))


@jax.jit
def _scale_probe_jit(src: jax.Array, wh: jax.Array, wv: jax.Array, *,
                     target_scan_bytes: jax.Array, lo0: jax.Array,
                     hi0: jax.Array):
    """ONE fused dispatch per scale probe: box downsample → forward DCT
    → 7-step exact-bit-count quality bisection (4:2:0, matching the
    size-search encode).  Weight matrices arrive device-resident
    (box_weights_device) — probes don't re-ship megabytes per call."""
    from ..codecs.jpeg import forward_dct_device
    from ..ops.resize import box_downsample_device
    from .size_search import size_bisect_traceable

    img = box_downsample_device(src, wh, wv)
    h, w = img.shape[0], img.shape[1]
    ph, pw = h + (-h) % 16, w + (-w) % 16
    coefs = forward_dct_device(img, True)
    return size_bisect_traceable(coefs, ph, pw, True,
                                 target_scan_bytes, lo0, hi0)


class _ScaleProber:
    """Device-resident scale probing for the joint scale×quality search.

    The reference runs a full encode per probe (targetsize.go:240-281);
    the first fennec-tpu version still paid three device round trips per
    probe (download downsampled pixels, re-upload for the DCT, bisect).
    Here the source uploads ONCE and every probe is a single fused
    dispatch.  Probes judge fit by exact scan bits + container bytes
    (0xFF stuffing excluded — it cannot be known without assembling the
    stream); the winning scale's candidate is then re-encoded and
    verified against real bytes by jpeg_quality_search, preserving the
    under-target guarantee.
    """

    def __init__(self, arr: np.ndarray):
        self.h, self.w = arr.shape[:2]
        # Ship uint8; the probe jit casts on device (4x less transfer).
        self.src = jnp.asarray(to_nrgba_ref(arr))
        self._memo: dict = {}

    def probe(self, new_w: int, new_h: int,
              target_bytes: int) -> Tuple[bool, int]:
        """(fits, quality) for encoding at ~new_w×new_h within
        target_bytes.  Geometry is snapped to the probe lattice; snapped
        repeats (bisection midpoints converging onto the same lattice
        point) are answered from a memo without a dispatch."""
        from ..ops.resize import box_weights_device

        new_w, new_h = probe_geometry(self.w, self.h, new_w, new_h)
        key = (new_w, new_h, target_bytes)
        if key in self._memo:
            return self._memo[key]
        wh, wv = box_weights_device(self.w, self.h, new_w, new_h)
        lo, hi = _bpp_bounds(target_bytes, new_w * new_h)
        budget = target_bytes - _header_len(new_w, new_h)
        q, found = _scale_probe_jit(
            self.src, wh, wv,
            target_scan_bytes=jnp.int32(max(0, budget)),
            lo0=jnp.int32(lo), hi0=jnp.int32(hi))
        self._memo[key] = (bool(found), int(q))
        return self._memo[key]


class _JpegSizer:
    """Cached forward-DCT + device size oracle for one image.

    The reference re-encodes per bisection step (targetsize.go:146-166);
    here the whole quality→size bisection is ONE device dispatch using the
    exact Huffman bit count (ops/jpeg_size.py), and the host encodes only
    the winner — verifying the real byte size, since stuffing adds a
    data-dependent handful of bytes on top of the bit count.
    """

    def __init__(self, src: np.ndarray, optimize: bool = True):
        arr = to_nrgba_ref(src)
        self.h, self.w = arr.shape[:2]
        self.optimize = optimize
        self.coefs = forward_dct_device(
            jnp.asarray(arr, dtype=jnp.float32), True)
        self._header_len = None

    def encode(self, quality: int) -> bytes:
        return encode_jpeg_from_coefs(self.coefs, self.w, self.h,
                                      quality, True,
                                      optimize=self.optimize)

    def header_len(self) -> int:
        if self._header_len is None:
            from ..codecs.jpeg import assemble_jpeg
            from ..ops.dct import all_quality_tables
            self._header_len = len(assemble_jpeg(
                self.w, self.h, all_quality_tables()[50], b"", True))
        return self._header_len

    def search(self, target_bytes: int, lo: int, hi: int
               ) -> Tuple[Optional[bytes], int]:
        """Highest quality in [lo, hi] whose encoded size fits
        target_bytes; returns (bytes, quality) or (None, 0)."""
        from .size_search import size_bisect_device

        mult = 16
        ph, pw = self.h + (-self.h) % mult, self.w + (-self.w) % mult
        best_q, found = size_bisect_device(
            self.coefs, ph, pw, True,
            target_bytes=jnp.int32(
                max(0, target_bytes - self.header_len())),
            lo0=jnp.int32(lo), hi0=jnp.int32(hi))
        if not bool(found):
            return None, 0
        q = int(best_q)
        # Verify against real bytes (stuffing); step down if needed.
        data = None
        while q >= lo:
            data = self.encode(q)
            if len(data) <= target_bytes:
                break
            q -= 1
            data = None
        if data is None:
            return None, 0
        # Optimized Huffman shrinks files below the standard-table oracle,
        # so a higher quality may fit — restore maximality by probing up.
        while q < hi:
            nxt = self.encode(q + 1)
            if len(nxt) > target_bytes:
                break
            data, q = nxt, q + 1
        return data, q


def hit_target_size(ctx: Optional[Context], original: np.ndarray,
                    target_bytes: int, opts: Options) -> SizeResult:
    """Try all applicable strategies, rank by better_fit
    (reference targetsize.go:26-75)."""
    want_png = opts.format == Format.PNG
    want_jpeg = opts.format == Format.JPEG
    can_use_jpeg = not want_png and is_opaque(original)

    candidates: List[SizeResult] = []

    if (can_use_jpeg or want_jpeg) and not _ctx_err(ctx):
        r = jpeg_quality_search(original, target_bytes)
        if r is not None and r.quality >= MIN_JPEG_QUALITY:
            candidates.append(r)

    if not want_jpeg and not _ctx_err(ctx):
        r = quantize_strategy(original, target_bytes)
        if r is not None:
            candidates.append(r)

    if (can_use_jpeg or want_jpeg) and not _ctx_err(ctx):
        r = jpeg_quality_scale_search(ctx, original, target_bytes)
        if r is not None:
            candidates.append(r)

    if not candidates and not _ctx_err(ctx):
        fmt = opts.format
        if fmt == Format.AUTO:
            fmt = Format.JPEG if can_use_jpeg else Format.PNG
        r = scale_search(ctx, original, target_bytes, fmt)
        if r is not None:
            candidates.append(r)

    if not candidates:
        return _fallback_encode(original, target_bytes,
                                can_use_jpeg or want_jpeg, opts)

    best = candidates[0]
    for c in candidates[1:]:
        if better_fit(c, best, target_bytes):
            best = c
    return best


def _fallback_encode(original: np.ndarray, target: int, use_jpeg: bool,
                     opts: Options) -> SizeResult:
    # reference targetsize.go:77-90
    h, w = original.shape[:2]
    if use_jpeg:
        sizer = _JpegSizer(original)
        data = sizer.encode(1)
        # The reference scores SSIM(original, original) here
        # (targetsize.go:77-90) — a constant ~1.0; skip the dispatch.
        return SizeResult(data=data, format=Format.JPEG, quality=1,
                          ssim=1.0, final_w=w, final_h=h, img=original)
    data = compress_png(original, opts)
    return SizeResult(data=data, format=Format.PNG, ssim=1.0,
                      final_w=w, final_h=h, img=original)


def better_fit(candidate: SizeResult, current: SizeResult,
               target: int) -> bool:
    """Under-target first, then higher SSIM, then higher quality, else
    smaller (reference targetsize.go:92-113)."""
    c_size, b_size = len(candidate.data), len(current.data)
    c_under, b_under = c_size <= target, b_size <= target
    if c_under and not b_under:
        return True
    if not c_under and b_under:
        return False
    if c_under and b_under:
        if candidate.ssim != current.ssim:
            return candidate.ssim > current.ssim
        return candidate.quality > current.quality
    return c_size < b_size


# ── Strategy 1: quality-only binary search ──────────────────────────────────


def jpeg_quality_search(src: np.ndarray, target_bytes: int,
                        skip_ssim: bool = False,
                        sizer: Optional[_JpegSizer] = None
                        ) -> Optional[SizeResult]:
    """Binary search the highest quality fitting target_bytes, with
    bits-per-pixel-seeded bounds (reference targetsize.go:125-176)."""
    arr = to_nrgba_ref(src)
    h, w = arr.shape[:2]
    lo, hi = _bpp_bounds(target_bytes, w * h)

    if sizer is None:
        sizer = _JpegSizer(arr)
    best_buf, best_q = sizer.search(target_bytes, lo, hi)
    if best_buf is None:
        return None

    best_ssim = 0.0
    if not skip_ssim:
        from ..codecs.jpeg import decode_jpeg
        decoded = decode_jpeg(best_buf)
        best_ssim = compute_ssim_nrgba(arr, decoded)

    return SizeResult(data=best_buf, format=Format.JPEG, quality=best_q,
                      ssim=best_ssim, final_w=w, final_h=h, img=arr)


# ── Strategy 2: palette quantization ────────────────────────────────────────


def quantize_strategy(src: np.ndarray,
                      target_bytes: int) -> Optional[SizeResult]:
    """Median-cut indexed PNG at descending palette sizes
    (reference targetsize.go:180-206)."""
    arr = to_nrgba_ref(src)
    h, w = arr.shape[:2]
    for max_colors in (256, 128, 64, 32, 16):
        palette = median_cut(arr, max_colors)
        indices = apply_palette(arr, palette)
        data = png_codec.encode_png_paletted(indices, palette)
        if len(data) <= target_bytes:
            quantized = palette_to_nrgba(indices, palette)
            return SizeResult(data=data, format=Format.PNG, quality=0,
                              ssim=compute_ssim_nrgba(arr, quantized),
                              final_w=w, final_h=h, img=quantized)
    return None


# ── Strategy 3: joint quality × scale search ────────────────────────────────


@dataclasses.dataclass
class _ScaleCandidate:
    scale: float
    quality: int
    size: int


def jpeg_quality_scale_search(ctx: Optional[Context], src: np.ndarray,
                              target_bytes: int) -> Optional[SizeResult]:
    # reference targetsize.go:210-232
    arr = to_nrgba_ref(src)
    orig_h, orig_w = arr.shape[:2]
    prober = _ScaleProber(arr)
    best = _find_best_scale_binary(ctx, prober, orig_w, orig_h,
                                   target_bytes)
    best = _find_best_scale_fixed(ctx, prober, orig_w, orig_h,
                                  target_bytes, best)
    if best is None:
        return None
    final_w = int(orig_w * best.scale)
    final_h = int(orig_h * best.scale)
    final_scaled = lanczos_resize(arr, final_w, final_h)
    r = jpeg_quality_search(final_scaled, target_bytes, skip_ssim=True)
    if r is None or r.quality < MIN_JPEG_QUALITY:
        return None
    r.ssim = compute_ssim_nrgba(arr, final_scaled)
    r.final_w, r.final_h = final_w, final_h
    r.img = final_scaled
    return r


def _find_best_scale_binary(ctx, prober: _ScaleProber, orig_w, orig_h,
                            target_bytes):
    # reference targetsize.go:240-262; each probe is one fused dispatch
    best = None
    lo_scale, hi_scale = 0.05, 1.0
    for _ in range(10):
        if _ctx_err(ctx):
            break
        mid = (lo_scale + hi_scale) / 2
        new_w, new_h = int(orig_w * mid), int(orig_h * mid)
        if new_w < 8 or new_h < 8:
            lo_scale = mid
            continue
        fits, q = prober.probe(new_w, new_h, target_bytes)
        if fits and q >= MIN_JPEG_QUALITY:
            best = _ScaleCandidate(mid, q, 0)
            lo_scale = mid
        else:
            hi_scale = mid
    return best


def _find_best_scale_fixed(ctx, prober: _ScaleProber, orig_w, orig_h,
                           target_bytes, best):
    # reference targetsize.go:264-281
    for scale in (0.75, 0.50, 0.375, 0.25):
        if _ctx_err(ctx):
            break
        new_w, new_h = int(orig_w * scale), int(orig_h * scale)
        if new_w < 8 or new_h < 8:
            continue
        fits, q = prober.probe(new_w, new_h, target_bytes)
        if fits and q >= MIN_JPEG_QUALITY:
            if best is None or scale > best.scale:
                best = _ScaleCandidate(scale, q, 0)
    return best


# ── Strategy 4: pure scale search ───────────────────────────────────────────


def scale_search(ctx: Optional[Context], src: np.ndarray, target_bytes: int,
                 fmt: Format) -> Optional[SizeResult]:
    # reference targetsize.go:285-313
    arr = to_nrgba_ref(src)
    orig_h, orig_w = arr.shape[:2]
    lo, hi, best_scale, best_q = 0.05, 1.0, 0.0, 0
    prober = _ScaleProber(arr) if fmt == Format.JPEG else None

    for _ in range(12):
        if _ctx_err(ctx):
            break
        mid = (lo + hi) / 2
        new_w, new_h = int(orig_w * mid), int(orig_h * mid)
        if new_w < 1 or new_h < 1:
            lo = mid
            continue
        if prober is not None and new_w >= 8 and new_h >= 8:
            ok, q = prober.probe(new_w, new_h, target_bytes)
            fits = ok and q >= MIN_JPEG_QUALITY
        else:
            fits, q = _test_scale_fits(box_downsample(arr, new_w, new_h),
                                       target_bytes, fmt)
        if fits:
            best_scale, best_q, lo = mid, q, mid
        else:
            hi = mid

    if best_scale == 0:
        return None
    final_w = int(orig_w * best_scale)
    final_h = int(orig_h * best_scale)
    return _execute_final_scale_encode(arr, fmt, best_q, final_w, final_h,
                                       target_bytes)


def _test_scale_fits(scaled: np.ndarray, target_bytes: int,
                     fmt: Format) -> Tuple[bool, int]:
    # reference targetsize.go:315-328
    if fmt == Format.JPEG:
        r = jpeg_quality_search(scaled, target_bytes, skip_ssim=True)
        if (r is not None and len(r.data) <= target_bytes
                and r.quality >= MIN_JPEG_QUALITY):
            return True, r.quality
        return False, 0
    data = png_codec.encode_png_rgba(scaled)
    return len(data) <= target_bytes, 0


def _execute_final_scale_encode(src: np.ndarray, fmt: Format, best_q: int,
                                final_w: int, final_h: int,
                                target_bytes: int) -> Optional[SizeResult]:
    # reference targetsize.go:330-348
    scaled = lanczos_resize(src, final_w, final_h)
    if fmt == Format.JPEG:
        # One sizer serves both the re-search and the fallback encode so
        # the fallback doesn't re-upload + re-DCT the same array.
        sizer = _JpegSizer(to_nrgba_ref(scaled))
        r = jpeg_quality_search(scaled, target_bytes, skip_ssim=True,
                                sizer=sizer)
        if r is not None:
            return SizeResult(data=r.data, format=Format.JPEG,
                              quality=r.quality,
                              ssim=compute_ssim_nrgba(src, scaled),
                              final_w=final_w, final_h=final_h, img=scaled)
        data = sizer.encode(best_q)
    else:
        data = png_codec.encode_png_rgba(scaled)
    return SizeResult(data=data, format=fmt, quality=best_q,
                      ssim=compute_ssim_nrgba(src, scaled),
                      final_w=final_w, final_h=final_h, img=scaled)
