"""SSIM / SSIMFast / MS-SSIM — structural similarity on device.

The reference computes, per window position, a Gaussian-weighted
mean/variance/covariance with two explicit 8×8 scalar loops sharded over
goroutines (ssim.go:73-166).  Here the five statistic maps (mu_a, mu_b,
E[a²], E[b²], E[ab]) are produced by ONE separable window pass pair over
a 5-channel stack of shifted-slice multiply-adds — XLA fuses the
element-wise SSIM formula and the mean-reduction behind it, so the whole
score is a single fused device program with no host round-trips.

Window semantics replicate the reference exactly:
  - 8×8 window over the half-open offset range [-4, 4) with Gaussian σ=1.5
    weights (ssim.go:74-77, 223-241) — NOT a centered odd window;
  - window centers y ∈ [4, h-4), x ∈ [4, w-4)  (ssim.go:110-111), which
    drops the final "valid" position in each axis;
  - Wang-et-al constants k1=0.01, k2=0.03, L=255 (ssim.go:11-17);
  - images smaller than 8px fall back to global-moment pixelSSIM
    (ssim.go:169-204);
  - SSIMFast caps the max dimension at 512 via box downsample
    (ssim.go:48-70); MS-SSIM uses 5 scales with the standard weights and
    renormalizes when scales drop below 8px (ssim.go:313-365).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..image import to_nrgba_ref
from .color import luminance_device
from .filters import gaussian_window_1d
from .resize import (
    box_downsample_device,
    box_resize_weights,
    lanczos_resize,
)

Array = Union[np.ndarray, jax.Array]

SSIM_K1 = 0.01
SSIM_K2 = 0.03
SSIM_L = 255.0
SSIM_C1 = (SSIM_K1 * SSIM_L) ** 2
SSIM_C2 = (SSIM_K2 * SSIM_L) ** 2
WINDOW_SIZE = 8
MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


# ── Device kernels ──────────────────────────────────────────────────────────


def _window_sum(x: jax.Array, g: jax.Array, axis: int,
                out_len: int) -> jax.Array:
    """Weighted sum of 8 shifted slices along `axis` — the separable
    Gaussian window as fused multiply-adds.  Eight static-slice FMAs fuse
    into one elementwise pass and keep true float32 accumulation, which
    the <1e-4 parity bound requires.
    """
    out = None
    for k in range(WINDOW_SIZE):
        sl = jax.lax.slice_in_dim(x, k, k + out_len, axis=axis)
        term = sl * g[k]
        out = term if out is None else out + term
    return out


def _sep_conv_valid(maps: jax.Array, g: jax.Array) -> jax.Array:
    """Separable windowed sums of (C, H, W) with the 8-tap 1D kernel g,
    cropped to the reference's center set: output (C, H-8, W-8)."""
    h, w = maps.shape[-2], maps.shape[-1]
    x = _window_sum(maps, g, axis=2, out_len=w - WINDOW_SIZE)
    return _window_sum(x, g, axis=1, out_len=h - WINDOW_SIZE)


def ssim_map_device(lum_a: jax.Array, lum_b: jax.Array) -> jax.Array:
    """Per-window SSIM map over centers [4, h-4) × [4, w-4).

    Inputs: (H, W) float32 luminance in [0, 255], H > 8 and W > 8.
    Output: (H-8, W-8) float32 map.
    """
    g = jnp.asarray(gaussian_window_1d(WINDOW_SIZE, 1.5), dtype=jnp.float32)
    a, b = lum_a, lum_b
    maps = jnp.stack([a, b, a * a, b * b, a * b])
    # Output positions are the reference's center set y ∈ [4, h-4),
    # x ∈ [4, w-4) (ssim.go:110-111) — one short of "valid" in each axis.
    stats = _sep_conv_valid(maps, g)
    mu_a, mu_b, raw_aa, raw_bb, raw_ab = stats
    sig_aa = raw_aa - mu_a * mu_a
    sig_bb = raw_bb - mu_b * mu_b
    sig_ab = raw_ab - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + SSIM_C1) * (2.0 * sig_ab + SSIM_C2)
    den = (mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (sig_aa + sig_bb + SSIM_C2)
    return num / den


@jax.jit
def windowed_ssim_device(lum_a: jax.Array, lum_b: jax.Array) -> jax.Array:
    """Mean windowed SSIM (reference ssim.go:73-166). Shapes must be ≥ 8
    (== 8 returns the reference's empty-window 1.0)."""
    if lum_a.shape[-2] <= WINDOW_SIZE or lum_a.shape[-1] <= WINDOW_SIZE:
        # Zero window positions (reference ssim.go:162-164) — reachable
        # via SSIMFast on extreme-aspect images whose downsample floors
        # at exactly 8px (ssim_fast_dims); the mean of an empty map is
        # NaN, so guard at trace time.
        return jnp.float32(1.0)
    return jnp.mean(ssim_map_device(lum_a, lum_b))


def ssim_premaps_device(lum_a: jax.Array) -> jax.Array:
    """Loop-invariant a-side windowed stats (mu_a, raw_aa), shape
    (2, H-8, W-8).

    The quality bisection scores SSIM against the SAME original image at
    every probe — its windowed mean/raw-second-moment never change.
    Splitting them out of the per-probe stack is bit-identical (each
    map's separable conv is an independent per-channel slice-FMA chain)
    and removes 2 of the 5 window passes from the loop body."""
    g = jnp.asarray(gaussian_window_1d(WINDOW_SIZE, 1.5), dtype=jnp.float32)
    return _sep_conv_valid(jnp.stack([lum_a, lum_a * lum_a]), g)


def ssim_map_device_pre(pre_a: jax.Array, lum_a: jax.Array,
                        lum_b: jax.Array) -> jax.Array:
    """ssim_map_device with the a-side stats precomputed
    (ssim_premaps_device) — same values, 3 window passes instead of 5."""
    g = jnp.asarray(gaussian_window_1d(WINDOW_SIZE, 1.5), dtype=jnp.float32)
    stats_b = _sep_conv_valid(
        jnp.stack([lum_b, lum_b * lum_b, lum_a * lum_b]), g)
    mu_a, raw_aa = pre_a[0], pre_a[1]
    mu_b, raw_bb, raw_ab = stats_b
    sig_aa = raw_aa - mu_a * mu_a
    sig_bb = raw_bb - mu_b * mu_b
    sig_ab = raw_ab - mu_a * mu_b
    num = (2.0 * mu_a * mu_b + SSIM_C1) * (2.0 * sig_ab + SSIM_C2)
    den = (mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (sig_aa + sig_bb + SSIM_C2)
    return num / den


@jax.jit
def pixel_ssim_device(img_a: jax.Array, img_b: jax.Array) -> jax.Array:
    """Global-moment SSIM for tiny images (reference ssim.go:169-204).

    Inputs: (H, W, 4) float or uint8; luminance over RGB, population
    statistics.
    """
    la = luminance_device(img_a.astype(jnp.float32))
    lb = luminance_device(img_b.astype(jnp.float32))
    mu_a = jnp.mean(la)
    mu_b = jnp.mean(lb)
    da = la - mu_a
    db = lb - mu_b
    sig_aa = jnp.mean(da * da)
    sig_bb = jnp.mean(db * db)
    sig_ab = jnp.mean(da * db)
    num = (2 * mu_a * mu_b + SSIM_C1) * (2 * sig_ab + SSIM_C2)
    den = (mu_a * mu_a + mu_b * mu_b + SSIM_C1) * (sig_aa + sig_bb + SSIM_C2)
    return num / den


@jax.jit
def ssim_images_device(img_a: jax.Array, img_b: jax.Array) -> jax.Array:
    """Windowed SSIM of two (H, W, 4) images (fused luminance)."""
    return windowed_ssim_device(
        luminance_device(img_a.astype(jnp.float32)),
        luminance_device(img_b.astype(jnp.float32)))


def ssim_fast_dims(w: int, h: int, max_dim: int = 512) -> Tuple[int, int]:
    """Downsample target for SSIMFast (reference ssim.go:52-60)."""
    if w <= max_dim and h <= max_dim:
        return w, h
    scale = max_dim / max(w, h)
    new_w = int(max(8, math.floor(w * scale + 0.5)))
    new_h = int(max(8, math.floor(h * scale + 0.5)))
    return new_w, new_h


@jax.jit
def ssim_fast_downsampled_device(img_a: jax.Array, img_b: jax.Array,
                                 wh: jax.Array, wv: jax.Array) -> jax.Array:
    """SSIMFast inner: box-downsample both (H,W,4) images with the given
    weight matrices, then windowed SSIM on luminance."""
    a = box_downsample_device(img_a.astype(jnp.float32), wh, wv)
    b = box_downsample_device(img_b.astype(jnp.float32), wh, wv)
    return windowed_ssim_device(luminance_device(a), luminance_device(b))


# ── Host API ────────────────────────────────────────────────────────────────


def _prep(img: Array) -> np.ndarray:
    return to_nrgba_ref(np.asarray(img))


def _device_f32(arr: np.ndarray) -> jax.Array:
    # Ship uint8 over the wire; device casts to f32 (4x less transfer).
    return jnp.asarray(arr)


def pixel_ssim(img_a: Array, img_b: Array) -> float:
    a, b = _prep(img_a), _prep(img_b)
    if a.shape[0] * a.shape[1] == 0:
        return 1.0
    return float(pixel_ssim_device(_device_f32(a), _device_f32(b)))


def ssim(img1: Array, img2: Array) -> float:
    """Full-resolution structural similarity (reference ssim.go:24-43).

    Returns a value in ~[0, 1]; 1.0 means identical. If dimensions differ,
    img2 is Lanczos-resized to img1's size first.
    """
    a, b = _prep(img1), _prep(img2)
    h, w = a.shape[:2]
    if (b.shape[0], b.shape[1]) != (h, w):
        b = lanczos_resize(b, w, h)
    if w < 8 or h < 8:
        return pixel_ssim(a, b)
    if w <= 8 or h <= 8:
        return 1.0  # zero window positions (reference ssim.go:162-164)
    return float(ssim_images_device(_device_f32(a), _device_f32(b)))


def ssim_fast(img1: Array, img2: Array, max_dim: int = 512) -> float:
    """SSIM on box-downsampled inputs capped at 512px max dimension
    (reference ssim.go:48-70).  Inputs must share dimensions."""
    a, b = _prep(img1), _prep(img2)
    h, w = a.shape[:2]
    new_w, new_h = ssim_fast_dims(w, h, max_dim)
    if (new_w, new_h) != (w, h):
        from .resize import box_weights_device

        wh, wv = box_weights_device(w, h, new_w, new_h)
        # ssim_fast_dims floors changed dims at 8, so the downsampled
        # pair always has >= 8px on both axes here.
        return float(ssim_fast_downsampled_device(
            _device_f32(a), _device_f32(b), wh, wv))
    if w < 8 or h < 8:
        return pixel_ssim(a, b)
    if w <= 8 or h <= 8:
        return 1.0
    return float(ssim_images_device(_device_f32(a), _device_f32(b)))


def _msssim_plan(w: int, h: int):
    """Static per-shape plan: effective weights (with the reference's
    renormalization, ssim.go:327-342) and the per-level image dims."""
    weights = list(MSSSIM_WEIGHTS)
    levels = len(weights)
    ww, hh = w, h
    for i in range(levels - 1):
        if min(ww, hh) < 8:
            weights = weights[: i + 1]
            s = sum(weights)
            weights = [x / s for x in weights]
            break
        ww //= 2
        hh //= 2

    dims = [(w, h)]
    for i in range(len(weights) - 1):
        nw, nh = dims[-1][0] // 2, dims[-1][1] // 2
        if nw < 8 or nh < 8:
            break
        dims.append((nw, nh))
    return weights, dims


def _ms_ssim_device_factory(w: int, h: int):
    """Build a jitted device MS-SSIM for one input shape: every scale's
    box downsample (uint8-rounded like the reference's level images),
    SSIMFast, and the weighted log combination run in ONE dispatch."""
    weights, dims = _msssim_plan(w, h)

    level_consts = []
    for i, (lw, lh) in enumerate(dims):
        fw, fh = ssim_fast_dims(lw, lh)
        fast_wts = None
        if (fw, fh) != (lw, lh):
            fast_wts = box_resize_weights(lw, lh, fw, fh)
        down_wts = None
        if i + 1 < len(dims):
            down_wts = box_resize_weights(lw, lh, dims[i + 1][0],
                                          dims[i + 1][1])
        # _msssim_plan stops emitting dims at the first sub-8 level while
        # keeping at least that many weights, so weights[i] always exists.
        level_consts.append((weights[i], (fw, fh), fast_wts, down_wts))

    @jax.jit
    def fn(a: jax.Array, b: jax.Array) -> jax.Array:  # (H, W, 4) any dtype
        total = jnp.float32(0.0)
        cur_a, cur_b = a.astype(jnp.float32), b.astype(jnp.float32)
        # _msssim_plan never emits more levels than weights.
        for wt, (fw, fh), fast_wts, down_wts in level_consts:
            if fast_wts is not None:
                sa = box_downsample_device(cur_a, jnp.asarray(fast_wts[0]),
                                           jnp.asarray(fast_wts[1]))
                sb = box_downsample_device(cur_b, jnp.asarray(fast_wts[0]),
                                           jnp.asarray(fast_wts[1]))
            else:
                sa, sb = cur_a, cur_b
            if fw < 8 or fh < 8:
                s = pixel_ssim_device(sa, sb)
            elif fw <= 8 or fh <= 8:
                s = jnp.float32(1.0)
            else:
                s = windowed_ssim_device(luminance_device(sa),
                                         luminance_device(sb))
            total = total + np.float32(wt) * jnp.log(
                jnp.maximum(s, 1e-10))
            if down_wts is not None:
                cur_a = box_downsample_device(
                    cur_a, jnp.asarray(down_wts[0]),
                    jnp.asarray(down_wts[1]))
                cur_b = box_downsample_device(
                    cur_b, jnp.asarray(down_wts[0]),
                    jnp.asarray(down_wts[1]))
        return jnp.exp(total)

    return fn


# LRU-bounded: each shape's entry pins multi-MB host weight matrices
# plus the compiled program embedding them, so long-lived processes
# scoring arbitrary geometries must not grow without limit (same failure
# class the resize weight cache bounds by bytes).
_MSSSIM_CACHE: "OrderedDict" = OrderedDict()
_MSSSIM_CACHE_MAX = 16
_msssim_cache_lock = threading.Lock()


def ms_ssim(img1: Array, img2: Array) -> float:
    """Multi-scale SSIM, 5 scales (reference ssim.go:313-365).

    The whole scale pyramid — downsampling, per-scale SSIMFast, weighted
    log combination — executes as one device program per input shape.
    """
    a, b = _prep(img1), _prep(img2)
    h, w = a.shape[:2]
    if w <= 0 or h <= 0:
        return 1.0  # empty image, same contract as ssim()/pixel_ssim()
    if (b.shape[0], b.shape[1]) != (h, w):
        b = lanczos_resize(b, w, h)
    with _msssim_cache_lock:
        fn = _MSSSIM_CACHE.get((w, h))
        if fn is not None:
            _MSSSIM_CACHE.move_to_end((w, h))
    if fn is None:
        # Build outside the lock (tracing is slow); concurrent builders
        # for the same shape just produce an identical replacement.
        fn = _ms_ssim_device_factory(w, h)
        with _msssim_cache_lock:
            _MSSSIM_CACHE[(w, h)] = fn
            while len(_MSSSIM_CACHE) > _MSSSIM_CACHE_MAX:
                _MSSSIM_CACHE.popitem(last=False)
    return float(fn(_device_f32(a), _device_f32(b)))


def compute_ssim_nrgba(a: Array, b: Array) -> float:
    """SSIMFast with automatic resize of b to a's dims
    (reference targetsize.go:563-568)."""
    aa, bb = _prep(a), _prep(b)
    if aa.shape[:2] != bb.shape[:2]:
        bb = lanczos_resize(bb, aa.shape[1], aa.shape[0])
    return ssim_fast(aa, bb)
