"""Resampling: Lanczos-3 resize and box downsample as matmuls.

Device-first design: the reference walks per-pixel weight lists in
goroutine row shards (resize.go:77-161, ssim.go:244-309).  Here a
separable resample is two dense matmuls with precomputed (dst, src)
weight matrices — large, batched work that XLA fuses with surrounding
element-wise ops.

Alpha handling matches the reference's Lanczos path: RGB is premultiplied
by alpha before filtering and un-premultiplied after, preventing color
fringing at transparency edges (resize.go:96-113).  Unlike the reference,
both passes run in float32 without an intermediate uint8 quantization
(better quality; the reference's own tests assert behavior, not bytes).

Box downsample averages each channel independently with no premultiply,
exactly like boxDownsample (ssim.go:244-309), and rounds to integer pixel
values at the end — required for SSIM-parity with the reference, which
scores downsampled uint8 images.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..image import to_nrgba_ref
from .color import clamp_u8_device
from .filters import box_weights, lanczos_weights

Array = Union[np.ndarray, jax.Array]


# ── Device kernels ──────────────────────────────────────────────────────────


@jax.jit
def lanczos_resize_device(img: jax.Array, wh: jax.Array,
                          wv: jax.Array) -> jax.Array:
    """Resize (H, W, 4) float32 [0,255] → (H', W', 4) float32 integral values.

    wh: (W', W) horizontal weights; wv: (H', H) vertical weights.
    Premultiplied-alpha filtering per reference resize.go:96-113.
    """
    img = img.astype(jnp.float32)
    alpha = img[..., 3:4]
    premul = jnp.concatenate([img[..., :3] * alpha, alpha], axis=-1)
    # Horizontal then vertical pass — two matmuls.  HIGHEST precision
    # keeps true-f32 products (a lower one may run in TF32 on the GPU,
    # visibly banding 8-bit pixel data).
    tmp = jnp.einsum("hwc,Dw->hDc", premul, wh,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    out = jnp.einsum("hwc,Dh->Dwc", tmp, wv,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    a = out[..., 3:4]
    rgb = jnp.where(a > 0.5, out[..., :3] / jnp.where(a > 0.5, a, 1.0), 0.0)
    a_out = jnp.where(a > 0.5, a, 0.0)
    return clamp_u8_device(jnp.concatenate([rgb, a_out], axis=-1))


@jax.jit
def box_downsample_device(img: jax.Array, wh: jax.Array,
                          wv: jax.Array) -> jax.Array:
    """Box-filter downsample, channels averaged independently
    (reference ssim.go:244-309), rounded to integral float32 values."""
    img = img.astype(jnp.float32)
    tmp = jnp.einsum("hwc,Dw->hDc", img, wh,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    out = jnp.einsum("hwc,Dh->Dwc", tmp, wv,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return clamp_u8_device(out)


def resize_weights(src_w: int, src_h: int, dst_w: int,
                   dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (dst_w, src_w) and (dst_h, src_h) Lanczos weight matrices."""
    return (lanczos_weights(dst_w, src_w).astype(np.float32),
            lanczos_weights(dst_h, src_h).astype(np.float32))


def box_resize_weights(src_w: int, src_h: int, dst_w: int,
                       dst_h: int) -> Tuple[np.ndarray, np.ndarray]:
    return (box_weights(dst_w, src_w).astype(np.float32),
            box_weights(dst_h, src_h).astype(np.float32))


# Device weight matrices are cached per geometry so repeated probes
# (quality/scale searches, SSIMFast loops) ship them once per process
# instead of per call (megabytes per dispatch).  The cache is
# byte-bounded, not entry-bounded: one 4K pair is tens of MB of HBM, so a
# plain lru_cache(32) could pin ~1 GB in a long-lived process.
_WEIGHT_CACHE_BUDGET = 128 * 1024 * 1024  # bytes of HBM, per process
_weight_cache: "dict[tuple, Tuple[jax.Array, jax.Array]]" = {}
_weight_cache_bytes = 0
# compress_batch's pool path reaches this cache from many worker threads
# (the lru_cache this replaced was thread-safe); unsynchronized eviction
# races can corrupt the byte counter or raise mid-pop.
_weight_cache_lock = threading.Lock()


def _weight_cache_get(key, make):
    global _weight_cache_bytes
    with _weight_cache_lock:
        hit = _weight_cache.get(key)
        if hit is not None:
            _weight_cache[key] = _weight_cache.pop(key)  # LRU bump
            return hit
    # Build outside the lock (host weight synthesis can take ~ms); a
    # concurrent duplicate build is harmless — last writer wins.
    wh, wv = make()
    pair = (jnp.asarray(wh), jnp.asarray(wv))
    size = wh.nbytes + wv.nbytes
    with _weight_cache_lock:
        if key not in _weight_cache:
            while (_weight_cache
                   and _weight_cache_bytes + size > _WEIGHT_CACHE_BUDGET):
                owh, owv = _weight_cache.pop(next(iter(_weight_cache)))
                _weight_cache_bytes -= owh.nbytes + owv.nbytes
            _weight_cache[key] = pair
            _weight_cache_bytes += size
    return pair


def clear_weight_caches() -> None:
    """Release all cached device-resident resample weight matrices (HBM
    relief hook for long-lived hosts cycling many geometries)."""
    global _weight_cache_bytes
    with _weight_cache_lock:
        _weight_cache.clear()
        _weight_cache_bytes = 0


def box_weights_device(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Device-resident box weights, cached per shape (byte-bounded LRU)."""
    return _weight_cache_get(
        ("box", src_w, src_h, dst_w, dst_h),
        lambda: box_resize_weights(src_w, src_h, dst_w, dst_h))


def lanczos_weights_device(src_w: int, src_h: int, dst_w: int, dst_h: int):
    """Device-resident Lanczos weights, cached per shape (byte-bounded)."""
    return _weight_cache_get(
        ("lanczos", src_w, src_h, dst_w, dst_h),
        lambda: resize_weights(src_w, src_h, dst_w, dst_h))


# ── Host wrappers ───────────────────────────────────────────────────────────


def _to_device_f32(img: Array) -> jax.Array:
    if isinstance(img, jax.Array) and img.dtype == jnp.float32:
        return img
    return jnp.asarray(to_nrgba_ref(np.asarray(img)), dtype=jnp.float32)


def lanczos_resize(img: Array, dst_w: int, dst_h: int) -> np.ndarray:
    """High-quality Lanczos-3 resize (reference resize.go:34-53).

    Accepts (H, W, 4) uint8 (or float) and returns (dst_h, dst_w, 4) uint8.
    """
    # jax inputs take the same normalization path as numpy: _as_uint8
    # rounds and scales [0,1] floats; a raw astype would truncate.
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    if src_w <= 0 or src_h <= 0 or dst_w <= 0 or dst_h <= 0:
        return np.zeros((max(dst_h, 0), max(dst_w, 0), 4), dtype=np.uint8)
    if src_w == dst_w and src_h == dst_h:
        return arr.copy()
    wh, wv = lanczos_weights_device(src_w, src_h, dst_w, dst_h)
    out = lanczos_resize_device(jnp.asarray(arr), wh, wv)
    return np.asarray(out, dtype=np.uint8)


def box_downsample(img: Array, dst_w: int, dst_h: int) -> np.ndarray:
    """Fast box-filter downsample (reference ssim.go:243-284)."""
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    if src_w <= 0 or src_h <= 0 or dst_w <= 0 or dst_h <= 0:
        return np.zeros((max(dst_h, 0), max(dst_w, 0), 4), dtype=np.uint8)
    wh, wv = box_weights_device(src_w, src_h, dst_w, dst_h)
    out = box_downsample_device(jnp.asarray(arr), wh, wv)
    return np.asarray(out, dtype=np.uint8)


def smart_resize_dims(src_w: int, src_h: int, max_w: int,
                      max_h: int) -> Tuple[int, int]:
    """Aspect-preserving fit-within dims; never enlarges
    (reference resize.go:12-32)."""
    if max_w <= 0:
        max_w = src_w
    if max_h <= 0:
        max_h = src_h
    if src_w <= max_w and src_h <= max_h:
        return src_w, src_h
    ratio = min(max_w / src_w, max_h / src_h)
    dst_w = int(max(1, round_half_away_py(src_w * ratio)))
    dst_h = int(max(1, round_half_away_py(src_h * ratio)))
    return dst_w, dst_h


def round_half_away_py(x: float) -> float:
    """math.Round semantics (half away from zero) for host policy code."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def smart_resize(img: Array, max_w: int, max_h: int) -> np.ndarray:
    """Resize to fit within max_w × max_h, preserving aspect ratio; returns
    the input object unchanged if it already fits (reference resize.go:12-32,
    pointer-identity no-op semantics)."""
    arr = to_nrgba_ref(np.asarray(img))
    src_h, src_w = arr.shape[:2]
    dst_w, dst_h = smart_resize_dims(src_w, src_h, max_w, max_h)
    if (dst_w, dst_h) == (src_w, src_h):
        return img
    return lanczos_resize(arr, dst_w, dst_h)
