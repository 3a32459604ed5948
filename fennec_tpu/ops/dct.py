"""8×8 block DCT / IDCT and JPEG quantization on device.

Device formulation: a block DCT C = D·B·Dᵀ over every 8×8 block is
flattened with the Kronecker identity vec(D·B·Dᵀ) = (D⊗D)·vec(B), turning
the whole-image DCT into ONE (num_blocks, 64) × (64, 64) matmul
(contraction 64, unbounded M).  IDCT is the transpose multiply.

This replaces the role of Go stdlib's scalar fixed-point FDCT/IDCT inside
the reference's encode→decode→score loop (compress.go:45-62): here the
forward DCT is computed once per image and the quality search re-quantizes
coefficients on device (see engine/compress.py).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

# ── Quantization tables (JPEG Annex K) and libjpeg-style quality scaling ────

# Standard luminance / chrominance base tables, natural (row-major) order.
STD_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

STD_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)


def scale_quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg quality scaling (also used by Go's stdlib encoder):
    scale = 5000/q for q<50 else 200-2q; entries clamped to [1, 255]."""
    q = min(100, max(1, int(quality)))
    scale = 5000 // q if q < 50 else 200 - 2 * q
    t = (base * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.int32)


@functools.lru_cache(maxsize=4)
def all_quality_tables() -> np.ndarray:
    """(101, 2, 64) int32: quant tables for qualities 0..100 (0 unused),
    [luma, chroma].  Shipped to device once so a traced quality index can
    select its tables inside a lax.while_loop."""
    out = np.zeros((101, 2, 64), dtype=np.int32)
    for q in range(1, 101):
        out[q, 0] = scale_quant_table(STD_LUMA_QUANT, q)
        out[q, 1] = scale_quant_table(STD_CHROMA_QUANT, q)
    out[0] = out[1]
    out.setflags(write=False)  # cached + shared: in-place edits would
    return out                 # corrupt every later encode


# Zigzag scan order: ZIGZAG[i] = natural index of the i-th zigzag element.
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10,
    17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

# Inverse: UNZIGZAG[natural] = zigzag position.
UNZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


# ── DCT basis ───────────────────────────────────────────────────────────────


@functools.lru_cache(maxsize=4)
def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix D (float64): coef = D @ x."""
    n = 8
    d = np.zeros((n, n), dtype=np.float64)
    for k in range(n):
        c = np.sqrt(1.0 / n) if k == 0 else np.sqrt(2.0 / n)
        for i in range(n):
            d[k, i] = c * np.cos((2 * i + 1) * k * np.pi / (2 * n))
    d.setflags(write=False)  # cached + shared
    return d


@functools.lru_cache(maxsize=4)
def dct_kron() -> np.ndarray:
    """(64, 64) float32 M with vec(D·B·Dᵀ) = M @ vec(B) (row-major vec)."""
    d = dct_matrix()
    m = np.kron(d, d).astype(np.float32)
    m.setflags(write=False)  # cached + shared
    return m


# ── Device ops ──────────────────────────────────────────────────────────────


def to_blocks(plane: jax.Array) -> jax.Array:
    """(H, W) → (H/8 * W/8, 64) row-major blocks; H, W multiples of 8."""
    h, w = plane.shape
    x = plane.reshape(h // 8, 8, w // 8, 8)
    x = jnp.transpose(x, (0, 2, 1, 3))
    return x.reshape(-1, 64)


def from_blocks(blocks: jax.Array, h: int, w: int) -> jax.Array:
    """(H/8 * W/8, 64) → (H, W)."""
    x = blocks.reshape(h // 8, w // 8, 8, 8)
    x = jnp.transpose(x, (0, 2, 1, 3))
    return x.reshape(h, w)


def dct2d_blocks(blocks: jax.Array) -> jax.Array:
    """Forward DCT of (N, 64) pixel blocks (level-shifted) → (N, 64) coefs.
    One matmul via the Kronecker-flattened basis."""
    m = jnp.asarray(dct_kron())
    return jnp.dot(blocks, m.T, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def idct2d_blocks(coefs: jax.Array) -> jax.Array:
    """Inverse DCT of (N, 64) coefficient blocks → (N, 64) pixels."""
    m = jnp.asarray(dct_kron())
    return jnp.dot(coefs, m, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)


def quantize_blocks(coefs: jax.Array, qtable: jax.Array) -> jax.Array:
    """Quantize (N, 64) float coefficients by a (64,) table.

    Round-half-away-from-zero, like Go's encoder div() — symmetric in sign.
    Returns float32 integral values (kept float for device round-trips;
    cast to int16 only when handing to the entropy coder).
    """
    q = qtable.astype(jnp.float32)
    scaled = coefs / q
    return jnp.sign(scaled) * jnp.floor(jnp.abs(scaled) + 0.5)


def dequantize_blocks(qcoefs: jax.Array, qtable: jax.Array) -> jax.Array:
    return qcoefs * qtable.astype(jnp.float32)


def pad_to_multiple(plane: jax.Array, mult_h: int, mult_w: int) -> jax.Array:
    """Edge-replicate pad (H, W) up to multiples of (mult_h, mult_w)."""
    h, w = plane.shape
    ph = (-h) % mult_h
    pw = (-w) % mult_w
    if ph == 0 and pw == 0:
        return plane
    return jnp.pad(plane, ((0, ph), (0, pw)), mode="edge")


def downsample_420(plane: jax.Array) -> jax.Array:
    """2×2 mean chroma downsample (H, W even)."""
    h, w = plane.shape
    x = plane.reshape(h // 2, 2, w // 2, 2)
    return x.mean(axis=(1, 3))


def upsample_420(plane: jax.Array) -> jax.Array:
    """2×2 replication chroma upsample (matches Go stdlib's decoder)."""
    return jnp.repeat(jnp.repeat(plane, 2, axis=0), 2, axis=1)
