"""SSIM-guided JPEG quality search (device-resident) and PNG optimizer.

The reference's hot loop (compress.go:21-87) runs encode → decode → SSIM on
the host per bisection step.  The device formulation removes every per-step
host round-trip:

  1. forward DCT coefficients are computed ONCE per image (quality-
     independent, ops/dct.py);
  2. a jitted lax.fori_loop runs the ~7-step binary search entirely on
     device — each step re-quantizes the cached coefficients at the probe
     quality (a gather from the precomputed (101,2,64) table stack + one
     element-wise pass), reconstructs via IDCT, and scores SSIMFast against
     the cached downsampled original luminance;
  3. ONE host Huffman encode materializes the winning file.

Search semantics match compress.go exactly: lo seeded by target (≥0.99→75,
≥0.97→50, ≥0.94→30, ≥0.90→15), target 1.0 clamped to 0.999, accept when
SSIM ≥ target, best initialized to Q=100/SSIM=1.0 when nothing qualifies.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import device_entropy_default
from ..codecs import png as png_codec
from ..codecs.jpeg import (
    encode_jpeg_from_coefs,
    forward_dct_device,
)
from ..image import is_grayscale, to_gray, to_nrgba_ref
from ..ops import dct as dct_ops
from ..ops.color import clamp_u8_device, ycbcr_to_rgb
from ..ops.resize import box_resize_weights
from ..ops.ssim import ssim_fast_dims
from ..types import Options

MAX_BISECT_STEPS = 7  # ceil(log2(100)) — covers any [lo, hi] ⊆ [1, 100]


def _seed_lo(target: float) -> int:
    """Quality lower-bound fast path (reference compress.go:35-43)."""
    if target >= 0.99:
        return 75
    if target >= 0.97:
        return 50
    if target >= 0.94:
        return 30
    if target >= 0.90:
        return 15
    return 1


def _reconstruct_rgb(coefs, qtab, padded_h: int, padded_w: int,
                     subsample: bool, h: int, w: int) -> jax.Array:
    """Decode-model: quantize+dequantize coefficients at a traced quality
    table, IDCT, upsample, YCbCr→RGB, clamp, crop → (h, w, 3)."""
    cy, ccb, ccr = coefs
    qy = dct_ops.dequantize_blocks(
        dct_ops.quantize_blocks(cy, qtab[0]), qtab[0])
    qcb = dct_ops.dequantize_blocks(
        dct_ops.quantize_blocks(ccb, qtab[1]), qtab[1])
    qcr = dct_ops.dequantize_blocks(
        dct_ops.quantize_blocks(ccr, qtab[1]), qtab[1])
    y = dct_ops.from_blocks(dct_ops.idct2d_blocks(qy),
                            padded_h, padded_w) + 128.0
    ch, cw = (padded_h // 2, padded_w // 2) if subsample \
        else (padded_h, padded_w)
    cb = dct_ops.from_blocks(dct_ops.idct2d_blocks(qcb), ch, cw) + 128.0
    cr = dct_ops.from_blocks(dct_ops.idct2d_blocks(qcr), ch, cw) + 128.0
    if subsample:
        cb = dct_ops.upsample_420(cb)
        cr = dct_ops.upsample_420(cr)
    ycc = jnp.stack([y[:h, :w], cb[:h, :w], cr[:h, :w]], axis=-1)
    return clamp_u8_device(ycbcr_to_rgb(ycc))


@functools.lru_cache(maxsize=8)
def _idct_basis(n: int) -> np.ndarray:
    """(n, n) float32 block-diagonal IDCT basis kron(I_{n/8}, D).

    Left/right-multiplying a coefficient PLANE (coefficients stored at
    their block positions) by kron(I, D)ᵀ / kron(I, D) performs the 8×8
    block IDCT of every block at once with NO block↔plane transposes —
    the per-probe reconstruction becomes two full-plane matmuls plus
    fused elementwise work (the (N, 64) Kronecker form pays a
    (H/8, W/8, 8, 8) transpose per probe to reassemble the plane)."""
    d = dct_ops.dct_matrix()
    return np.kron(np.eye(n // 8), d).astype(np.float32)


def _qd_plane(cp: jax.Array, q88: jax.Array) -> jax.Array:
    """Quantize+dequantize a coefficient plane at an (8, 8) table —
    per-position arithmetic identical to quantize_blocks∘dequantize_blocks
    (round half away from zero)."""
    h, w = cp.shape[-2], cp.shape[-1]
    x = cp.reshape(*cp.shape[:-2], h // 8, 8, w // 8, 8)
    q = q88[..., None, :, None, :]
    s = x / q
    r = jnp.sign(s) * jnp.floor(jnp.abs(s) + 0.5)
    return (r * q).reshape(cp.shape)


def _idct_plane(qd: jax.Array) -> jax.Array:
    """Blockwise 8×8 IDCT of a coefficient plane via the block-diagonal
    basis: X = Dᵀ·C·D per block ⇒ P = kron(I,D)ᵀ · Cp · kron(I,D)."""
    bh = jnp.asarray(_idct_basis(qd.shape[-2]))
    bw = jnp.asarray(_idct_basis(qd.shape[-1]))
    # HIGHEST: below it an f32 product may run in TF32 on the GPU, which
    # keeps ~3 decimal digits — too few for the <1e-4 SSIM parity bound
    # without a chosen-quality parity run to show otherwise.
    prec = jax.lax.Precision.HIGHEST
    t = jnp.einsum("uh,...uw->...hw", bh, qd,
                   preferred_element_type=jnp.float32,
                   precision=prec)
    return jnp.einsum("...hw,wv->...hv", t, bw,
                      preferred_element_type=jnp.float32,
                      precision=prec)


def _reconstruct_rgb_planes(cp_y, cp_cb, cp_cr, qtab, subsample: bool,
                            h: int, w: int):
    """Channel planes (r, g, b) of the decode-model reconstruction,
    computed from coefficient PLANES (see _idct_basis) — value-identical
    to _reconstruct_rgb's channels, but transpose-free and channel-planar
    (no (H, W, 3) stack is materialized).  Leading batch dims broadcast.

    This is the probe-loop hot path: everything after the two plane
    matmuls fuses into one elementwise pass."""
    y = _idct_plane(_qd_plane(cp_y, qtab[..., 0, :].reshape(
        *qtab.shape[:-2], 8, 8))) + 128.0
    qc = qtab[..., 1, :].reshape(*qtab.shape[:-2], 8, 8)
    cb = _idct_plane(_qd_plane(cp_cb, qc)) + 128.0
    cr = _idct_plane(_qd_plane(cp_cr, qc)) + 128.0
    if subsample:
        cb = jnp.repeat(jnp.repeat(cb, 2, axis=-2), 2, axis=-1)
        cr = jnp.repeat(jnp.repeat(cr, 2, axis=-2), 2, axis=-1)
    y = y[..., :h, :w]
    cbc = cb[..., :h, :w] - 128.0
    crc = cr[..., :h, :w] - 128.0
    r = clamp_u8_device(y + 1.402 * crc)
    g = clamp_u8_device(y - 0.344136286 * cbc - 0.714136286 * crc)
    b = clamp_u8_device(y + 1.772 * cbc)
    return r, g, b


def _box_down_plane(plane: jax.Array, wh: jax.Array,
                    wv: jax.Array) -> jax.Array:
    """Box-downsample one (H, W) plane with weight matrices, uint8-rounded
    (SSIMFast scores rounded pixels; reference ssim.go:48-70)."""
    tmp = jnp.einsum("hw,Dw->hD", plane, wh,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    out = jnp.einsum("hw,Dh->Dw", tmp, wv,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return jnp.clip(jnp.floor(out + 0.5), 0.0, 255.0)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _bisect_device(coefs, img_rgb_ds_lum, box_wh, box_wv,
                   padded_h: int, padded_w: int, subsample: bool,
                   h: int, w: int, *, target: jax.Array, lo0: jax.Array):
    """Device-resident quality bisection.

    Note: SSIMFast downsamples the *uint8 RGB channels* then takes
    luminance (ssim.go:57-66), so each step downsamples the three
    reconstructed RGB planes before the luminance transform.
    """
    all_tables = jnp.asarray(dct_ops.all_quality_tables(),
                             dtype=jnp.float32)  # (101, 2, 64)
    ds_h, ds_w = img_rgb_ds_lum.shape
    use_windowed = ds_h > 8 and ds_w > 8
    # Exactly-8px dims: the reference's window set is empty and
    # windowedSSIM returns 1.0 (ssim.go:162-164) — every quality accepts.
    constant_one = (ds_h == 8 or ds_w == 8) and ds_h >= 8 and ds_w >= 8
    # Static at trace time: identity box weights (image already ≤ 512px)
    # mean the downsample matmuls can be skipped entirely.
    needs_ds = (box_wh.shape[0] != w) or (box_wv.shape[0] != h)

    # The original's windowed stats never change across probes — hoist
    # them out of the bisection loop (2 of 5 window passes per probe;
    # bit-identical, ops/ssim.py:ssim_premaps_device).
    from ..ops.ssim import ssim_map_device_pre, ssim_premaps_device

    pre_a = ssim_premaps_device(img_rgb_ds_lum) if use_windowed else None

    def score(quality: jax.Array) -> jax.Array:
        qtab = jax.lax.dynamic_index_in_dim(all_tables, quality, axis=0,
                                            keepdims=False)
        rgb = _reconstruct_rgb(coefs, qtab, padded_h, padded_w,
                               subsample, h, w)
        if needs_ds:
            r = _box_down_plane(rgb[..., 0], box_wh, box_wv)
            g = _box_down_plane(rgb[..., 1], box_wh, box_wv)
            b = _box_down_plane(rgb[..., 2], box_wh, box_wv)
            lum = 0.299 * r + 0.587 * g + 0.114 * b
        else:
            lum = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                   + 0.114 * rgb[..., 2])
        if use_windowed:
            return jnp.mean(ssim_map_device_pre(pre_a, img_rgb_ds_lum,
                                                lum))
        if constant_one:
            return jnp.float32(1.0)
        # tiny image: global-moment pixelSSIM on luminance
        mu_a = jnp.mean(img_rgb_ds_lum)
        mu_b = jnp.mean(lum)
        da = img_rgb_ds_lum - mu_a
        db = lum - mu_b
        c1 = (0.01 * 255.0) ** 2
        c2 = (0.03 * 255.0) ** 2
        num = (2 * mu_a * mu_b + c1) * (2 * jnp.mean(da * db) + c2)
        den = ((mu_a ** 2 + mu_b ** 2 + c1)
               * (jnp.mean(da * da) + jnp.mean(db * db) + c2))
        return num / den

    def body(_, state):
        lo, hi, best_q, best_ssim, found = state
        active = lo <= hi
        mid = (lo + hi) // 2
        s = score(mid)
        ok = jnp.logical_and(active, s >= target)
        best_q = jnp.where(ok, mid, best_q)
        best_ssim = jnp.where(ok, s, best_ssim)
        found = jnp.logical_or(found, ok)
        hi = jnp.where(jnp.logical_and(active, ok), mid - 1, hi)
        lo = jnp.where(jnp.logical_and(active, jnp.logical_not(ok)),
                       mid + 1, lo)
        return lo, hi, best_q, best_ssim, found

    init = (lo0, jnp.int32(100), jnp.int32(100), jnp.float32(1.0),
            jnp.bool_(False))
    _, _, best_q, best_ssim, found = jax.lax.fori_loop(
        0, MAX_BISECT_STEPS, body, init)
    return best_q, best_ssim, found


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def _bisect_device_batch(cplanes, lum_orig, box_wh, box_wv,
                         padded_h: int, padded_w: int, subsample: bool,
                         h: int, w: int, *,
                         targets: jax.Array, lo0: jax.Array):
    """Batch-wise device quality bisection: all B images advance their
    binary searches in lockstep, and each probe scores the WHOLE batch
    with the premap-hoisted windowed SSIM (ops/ssim.py), which XLA fuses
    into a few elementwise passes.

    cplanes: (cp_y, cp_cb, cp_cr) coefficient PLANES, (B, ph, pw) and
    (B, ch, cw) — the per-probe reconstruction is transpose-free (see
    _idct_basis); lum_orig: (B, dh, dw); targets/lo0: (B,).  Returns
    (best_q, best_ssim, found) each (B,).
    """
    all_tables = jnp.asarray(dct_ops.all_quality_tables(),
                             dtype=jnp.float32)  # (101, 2, 64)
    ds_h, ds_w = lum_orig.shape[1], lum_orig.shape[2]
    use_windowed = ds_h > 8 and ds_w > 8
    constant_one = (ds_h == 8 or ds_w == 8) and ds_h >= 8 and ds_w >= 8
    needs_ds = (box_wh.shape[0] != w) or (box_wv.shape[0] != h)

    if use_windowed:
        from ..ops.ssim import ssim_map_device_pre, ssim_premaps_device

        with jax.named_scope("ssim"):
            pre_a = jax.vmap(ssim_premaps_device)(lum_orig)

    def score(mid: jax.Array) -> jax.Array:  # (B,) int32 → (B,) f32
        qtabs = jnp.take(all_tables, mid, axis=0)  # (B, 2, 64)
        r, g, b = _reconstruct_rgb_planes(
            cplanes[0], cplanes[1], cplanes[2], qtabs, subsample, h, w)
        if needs_ds:
            down = jax.vmap(lambda p: _box_down_plane(p, box_wh, box_wv))
            r, g, b = down(r), down(g), down(b)
        lum = 0.299 * r + 0.587 * g + 0.114 * b
        if use_windowed:
            with jax.named_scope("ssim"):
                return jax.vmap(lambda p, la, lb: jnp.mean(
                    ssim_map_device_pre(p, la, lb)))(pre_a, lum_orig, lum)
        if constant_one:
            return jnp.ones((lum.shape[0],), jnp.float32)
        mu_a = jnp.mean(lum_orig, axis=(1, 2))
        mu_b = jnp.mean(lum, axis=(1, 2))
        da = lum_orig - mu_a[:, None, None]
        db = lum - mu_b[:, None, None]
        c1 = (0.01 * 255.0) ** 2
        c2 = (0.03 * 255.0) ** 2
        num = (2 * mu_a * mu_b + c1) * (2 * jnp.mean(da * db,
                                                     axis=(1, 2)) + c2)
        den = ((mu_a ** 2 + mu_b ** 2 + c1)
               * (jnp.mean(da * da, axis=(1, 2))
                  + jnp.mean(db * db, axis=(1, 2)) + c2))
        return num / den

    def body(_, state):
        lo, hi, best_q, best_ssim, found = state
        active = lo <= hi
        mid = (lo + hi) // 2
        s = score(mid)
        ok = jnp.logical_and(active, s >= targets)
        best_q = jnp.where(ok, mid, best_q)
        best_ssim = jnp.where(ok, s, best_ssim)
        found = jnp.logical_or(found, ok)
        hi = jnp.where(jnp.logical_and(active, ok), mid - 1, hi)
        lo = jnp.where(jnp.logical_and(active, jnp.logical_not(ok)),
                       mid + 1, lo)
        return lo, hi, best_q, best_ssim, found

    bsz = lum_orig.shape[0]
    init = (lo0, jnp.full((bsz,), 100, jnp.int32),
            jnp.full((bsz,), 100, jnp.int32),
            jnp.ones((bsz,), jnp.float32),
            jnp.zeros((bsz,), jnp.bool_))
    _, _, best_q, best_ssim, found = jax.lax.fori_loop(
        0, MAX_BISECT_STEPS, body, init)
    return best_q, best_ssim, found


def _batched_search_core(imgs: jax.Array, targets: jax.Array,
                         subsample: bool):
    """Shared prep + lockstep bisection for the batch-wise search paths.
    Returns (best_q, best_ssim, found, coefs)."""
    h, w = int(imgs.shape[1]), int(imgs.shape[2])
    # Clamp only unreachable targets (>= 1.0) to 0.999, matching
    # compress.go:24-26 — targets in (0.999, 1.0) stay as requested.
    t = jnp.clip(jnp.where(targets >= 1.0, 0.999, targets), 0.0)
    imgs = imgs.astype(jnp.float32)
    coefs = jax.vmap(lambda im: forward_dct_device(im, subsample))(imgs)

    ds_w, ds_h = ssim_fast_dims(w, h)
    wh, wv = box_resize_weights(w, h, ds_w, ds_h)
    box_wh = jnp.asarray(wh)
    box_wv = jnp.asarray(wv)

    def lum_one(im):
        if (ds_w, ds_h) != (w, h):
            r = _box_down_plane(im[..., 0], box_wh, box_wv)
            g = _box_down_plane(im[..., 1], box_wh, box_wv)
            b = _box_down_plane(im[..., 2], box_wh, box_wv)
            return 0.299 * r + 0.587 * g + 0.114 * b
        return (0.299 * im[..., 0] + 0.587 * im[..., 1]
                + 0.114 * im[..., 2])

    lum_orig = jax.vmap(lum_one)(imgs)
    lo0 = jnp.where(t >= 0.99, 75,
                    jnp.where(t >= 0.97, 50,
                              jnp.where(t >= 0.94, 30,
                                        jnp.where(t >= 0.90, 15,
                                                  1)))).astype(jnp.int32)
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ch, cw = (ph // 2, pw // 2) if subsample else (ph, pw)
    # Coefficient planes once per search (one layout transpose); every
    # probe then reconstructs transpose-free (_idct_basis).
    cplanes = (
        jax.vmap(lambda c: dct_ops.from_blocks(c, ph, pw))(coefs[0]),
        jax.vmap(lambda c: dct_ops.from_blocks(c, ch, cw))(coefs[1]),
        jax.vmap(lambda c: dct_ops.from_blocks(c, ch, cw))(coefs[2]),
    )
    best_q, best_ssim, found = _bisect_device_batch(
        cplanes, lum_orig, box_wh, box_wv, ph, pw, subsample, h, w,
        targets=t, lo0=lo0)
    return best_q, best_ssim, found, coefs


def batched_quality_search_device(imgs: jax.Array, targets: jax.Array,
                                  subsample: bool = True):
    """Batch-wise quality search: (B, H, W, 4) + (B,) targets →
    (q, ssim, found) each (B,).  Semantically identical to
    jax.vmap(quality_search_device) but each probe's SSIM scores the
    whole batch in one program."""
    q, s, f, _ = _batched_search_core(imgs, targets, subsample)
    return q, s, f


def batched_quality_search_quantize_device(imgs: jax.Array,
                                           targets: jax.Array,
                                           subsample: bool = True):
    """Batch-wise quality_search_quantize_device: (B, H, W, 4) float32 →
    (q (B,), ssim (B,), found (B,), packed (B, NT, 64) int16).

    Semantically identical to jax.vmap(quality_search_quantize_device)
    but the bisection runs lockstep over the batch so each probe scores
    the whole batch in one program.
    """
    best_q, best_ssim, found, coefs = _batched_search_core(
        imgs, targets, subsample)
    final_q = jnp.where(found, best_q, 100)
    all_tables = jnp.asarray(dct_ops.all_quality_tables(),
                             dtype=jnp.float32)
    qtabs = jnp.take(all_tables, final_q, axis=0)

    def quant_one(cy, ccb, ccr, qtab):
        qy = dct_ops.quantize_blocks(cy, qtab[0])
        qcb = dct_ops.quantize_blocks(ccb, qtab[1])
        qcr = dct_ops.quantize_blocks(ccr, qtab[1])
        return jnp.concatenate([qy, qcb, qcr], axis=0).astype(jnp.int16)

    packed = jax.vmap(quant_one)(coefs[0], coefs[1], coefs[2], qtabs)
    return best_q, best_ssim, found, packed


def _batched_search_core_yuv420(yp: jax.Array, cbp: jax.Array,
                                crp: jax.Array, targets: jax.Array,
                                h: int, w: int):
    """Lockstep search from HOST-converted YCbCr 4:2:0 planes — the
    halved pixel wire (FENNEC_PIXEL_WIRE, engine/batched.py).

    yp: (B, ph, pw); cbp/crp: (B, ph/2, pw/2) — uint8 on the wire,
    already edge-padded and 2×2-mean subsampled by the feeder with the
    SAME formulas forward_dct_device applies on device
    (ops/color.rgb_to_ycbcr, ops/dct.pad_to_multiple/downsample_420).
    The uint8 quantization bounds the deviation from the RGB wire at
    ≤0.5 per DCT input sample (tests/test_pixel_wire.py pins the
    parity).  The a-side luminance is the Y plane: BT.601
    luminance IS JPEG Y, and box-downsampling Y equals combining the
    box-downsampled R/G/B planes by linearity, so the reference's
    SSIMFast semantics (ssim.go:48-70) are preserved.

    Returns (best_q, best_ssim, found, coefs) with coefs the same
    (y, cb, cr) block triple forward_dct_device yields."""
    t = jnp.clip(jnp.where(targets >= 1.0, 0.999, targets), 0.0)
    yp = yp.astype(jnp.float32)
    cbp = cbp.astype(jnp.float32)
    crp = crp.astype(jnp.float32)
    ph, pw = int(yp.shape[1]), int(yp.shape[2])

    def dct_one(y, cb, cr):
        return (dct_ops.dct2d_blocks(dct_ops.to_blocks(y - 128.0)),
                dct_ops.dct2d_blocks(dct_ops.to_blocks(cb - 128.0)),
                dct_ops.dct2d_blocks(dct_ops.to_blocks(cr - 128.0)))

    coefs = jax.vmap(dct_one)(yp, cbp, crp)

    ds_w, ds_h = ssim_fast_dims(w, h)
    wh, wv = box_resize_weights(w, h, ds_w, ds_h)
    box_wh = jnp.asarray(wh)
    box_wv = jnp.asarray(wv)

    def lum_one(y):
        y = y[:h, :w]
        if (ds_w, ds_h) != (w, h):
            return _box_down_plane(y, box_wh, box_wv)
        return y

    lum_orig = jax.vmap(lum_one)(yp)
    lo0 = jnp.where(t >= 0.99, 75,
                    jnp.where(t >= 0.97, 50,
                              jnp.where(t >= 0.94, 30,
                                        jnp.where(t >= 0.90, 15,
                                                  1)))).astype(jnp.int32)
    ch, cw = ph // 2, pw // 2
    cplanes = (
        jax.vmap(lambda c: dct_ops.from_blocks(c, ph, pw))(coefs[0]),
        jax.vmap(lambda c: dct_ops.from_blocks(c, ch, cw))(coefs[1]),
        jax.vmap(lambda c: dct_ops.from_blocks(c, ch, cw))(coefs[2]),
    )
    best_q, best_ssim, found = _bisect_device_batch(
        cplanes, lum_orig, box_wh, box_wv, ph, pw, True, h, w,
        targets=t, lo0=lo0)
    return best_q, best_ssim, found, coefs


def batched_quality_search_quantize_yuv420(yp: jax.Array,
                                           cbp: jax.Array,
                                           crp: jax.Array,
                                           targets: jax.Array,
                                           h: int, w: int):
    """batched_quality_search_quantize_device over the YCbCr 4:2:0
    wire: (q, ssim, found, packed (B, NT, 64) int16)."""
    best_q, best_ssim, found, coefs = _batched_search_core_yuv420(
        yp, cbp, crp, targets, h, w)
    final_q = jnp.where(found, best_q, 100)
    all_tables = jnp.asarray(dct_ops.all_quality_tables(),
                             dtype=jnp.float32)
    qtabs = jnp.take(all_tables, final_q, axis=0)

    def quant_one(cy, ccb, ccr, qtab):
        qy = dct_ops.quantize_blocks(cy, qtab[0])
        qcb = dct_ops.quantize_blocks(ccb, qtab[1])
        qcr = dct_ops.quantize_blocks(ccr, qtab[1])
        return jnp.concatenate([qy, qcb, qcr], axis=0).astype(jnp.int16)

    packed = jax.vmap(quant_one)(coefs[0], coefs[1], coefs[2], qtabs)
    return best_q, best_ssim, found, packed


def quality_search_device(img: jax.Array, target: jax.Array,
                          subsample: bool = True):
    """Fully traceable single-image SSIM-guided quality search.

    img: (H, W, 4) float32; target: traced scalar.  Returns
    (best_q int32, best_ssim f32, found bool).  vmap/pjit-compatible —
    this is the unit the batch engine and mesh-sharded paths build on.
    """
    h, w = img.shape[0], img.shape[1]
    # Clamp only >= 1.0 to 0.999 (compress.go:24-26); sub-1.0 targets
    # pass through so single-image and batch engines agree.
    t = jnp.clip(jnp.where(target >= 1.0, 0.999, target), 0.0)
    coefs = forward_dct_device(img, subsample)

    ds_w, ds_h = ssim_fast_dims(w, h)
    wh, wv = box_resize_weights(w, h, ds_w, ds_h)
    box_wh = jnp.asarray(wh)
    box_wv = jnp.asarray(wv)
    if (ds_w, ds_h) != (w, h):
        r = _box_down_plane(img[..., 0], box_wh, box_wv)
        g = _box_down_plane(img[..., 1], box_wh, box_wv)
        b = _box_down_plane(img[..., 2], box_wh, box_wv)
        lum_orig = 0.299 * r + 0.587 * g + 0.114 * b
    else:
        lum_orig = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])

    # Traced analogue of the quality lower-bound fast path (compress.go:35-43).
    lo0 = jnp.where(t >= 0.99, 75,
                    jnp.where(t >= 0.97, 50,
                              jnp.where(t >= 0.94, 30,
                                        jnp.where(t >= 0.90, 15, 1))))
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    return _bisect_device(coefs, lum_orig, box_wh, box_wv, ph, pw,
                          subsample, h, w, target=t,
                          lo0=lo0.astype(jnp.int32))


def decode_jpeg_image_device(in_y: jax.Array, in_cb: jax.Array,
                             in_cr: jax.Array, qtabs: jax.Array,
                             h: int, w: int, in_subsample: bool):
    """Reconstruct one image from decoded quantized coefficients.

    in_*: (N, 64) float32 quantized blocks (MCU-padded grids); qtabs:
    (2, 64) [luma, chroma] float32.  Traceable/vmappable — the decode half
    of the all-on-device batch pipeline.
    """
    mult = 16 if in_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    y = dct_ops.from_blocks(
        dct_ops.idct2d_blocks(dct_ops.dequantize_blocks(in_y, qtabs[0])),
        ph, pw) + 128.0
    ch, cw = (ph // 2, pw // 2) if in_subsample else (ph, pw)
    cb = dct_ops.from_blocks(
        dct_ops.idct2d_blocks(dct_ops.dequantize_blocks(in_cb, qtabs[1])),
        ch, cw) + 128.0
    cr = dct_ops.from_blocks(
        dct_ops.idct2d_blocks(dct_ops.dequantize_blocks(in_cr, qtabs[1])),
        ch, cw) + 128.0
    if in_subsample:
        cb = dct_ops.upsample_420(cb)
        cr = dct_ops.upsample_420(cr)
    ycc = jnp.stack([y[:h, :w], cb[:h, :w], cr[:h, :w]], axis=-1)
    rgb = clamp_u8_device(ycbcr_to_rgb(ycc))
    alpha = jnp.full((h, w, 1), 255.0, dtype=jnp.float32)
    return jnp.concatenate([rgb, alpha], axis=-1)


@functools.partial(jax.jit, static_argnums=(2,))
def quality_search_quantize_device(img: jax.Array, target: jax.Array,
                                   subsample: bool = True):
    """Search + quantize in one traced program (jitted here so the
    forward DCT inside quality_search_device and the one below CSE into a
    single pass — eager calls would otherwise dispatch the DCT twice).

    Returns (best_q, best_ssim, found, (qy, qcb, qcr) int16) where the
    coefficient blocks are quantized at the *final* quality (Q=100 when the
    target was never met, matching compress.go:82-86).  One device dispatch
    and one host transfer cover the whole encode-side device work — the
    batch engine's hot path.
    """
    h, w = img.shape[0], img.shape[1]
    best_q, best_ssim, found = quality_search_device(img, target, subsample)
    # Defensive: _bisect_device already leaves best_q=100 when nothing fit
    # (compress.go:82-86), so this where only pins the invariant.
    final_q = jnp.where(found, best_q, 100)
    coefs = forward_dct_device(img, subsample)
    all_tables = jnp.asarray(dct_ops.all_quality_tables(),
                             dtype=jnp.float32)
    qtab = jax.lax.dynamic_index_in_dim(all_tables, final_q, axis=0,
                                        keepdims=False)
    qy = dct_ops.quantize_blocks(coefs[0], qtab[0])
    qcb = dct_ops.quantize_blocks(coefs[1], qtab[1])
    qcr = dct_ops.quantize_blocks(coefs[2], qtab[1])
    # One packed (Ny+2Nc, 64) int16 array → one host transfer per batch.
    packed = jnp.concatenate([qy, qcb, qcr], axis=0).astype(jnp.int16)
    return best_q, best_ssim, found, packed


def compress_jpeg_optimal(src: np.ndarray, target_ssim: float,
                          opts: Options) -> Tuple[int, float, bytes]:
    """Find the lowest JPEG quality meeting the target SSIM
    (reference compress.go:21-87).  Returns (quality, ssim, jpeg bytes)."""
    arr = to_nrgba_ref(np.asarray(src))
    h, w = arr.shape[:2]
    if target_ssim >= 1.0:
        target_ssim = 0.999  # JPEG can't hit SSIM 1.0 (compress.go:24-26)

    subsample = bool(opts.subsample)
    img_dev = jnp.asarray(arr, dtype=jnp.float32)
    coefs = forward_dct_device(img_dev, subsample)

    # Cached SSIMFast reference: downsampled original luminance.
    from ..ops.resize import box_weights_device

    ds_w, ds_h = ssim_fast_dims(w, h)
    box_wh, box_wv = box_weights_device(w, h, ds_w, ds_h)
    if (ds_w, ds_h) != (w, h):
        r = _box_down_plane(img_dev[..., 0], box_wh, box_wv)
        g = _box_down_plane(img_dev[..., 1], box_wh, box_wv)
        b = _box_down_plane(img_dev[..., 2], box_wh, box_wv)
        lum_orig = 0.299 * r + 0.587 * g + 0.114 * b
    else:
        lum_orig = (0.299 * img_dev[..., 0] + 0.587 * img_dev[..., 1]
                    + 0.114 * img_dev[..., 2])

    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ch, cw = (ph // 2, pw // 2) if subsample else (ph, pw)
    cplanes = (dct_ops.from_blocks(coefs[0], ph, pw)[None],
               dct_ops.from_blocks(coefs[1], ch, cw)[None],
               dct_ops.from_blocks(coefs[2], ch, cw)[None])
    best_q, best_ssim, found = _bisect_device_batch(
        cplanes, lum_orig[None], box_wh, box_wv, ph, pw, subsample, h, w,
        targets=jnp.full((1,), target_ssim, jnp.float32),
        lo0=jnp.full((1,), _seed_lo(target_ssim), jnp.int32))
    best_q, best_ssim, found = best_q[0], best_ssim[0], found[0]
    quality = int(best_q)
    ssim_val = float(best_ssim)
    if not bool(found):
        # Nothing met the target: reference falls back to encoding at the
        # initial hi (Q=100) and reports bestSSIM=1.0 (compress.go:29-32,82-86).
        quality, ssim_val = 100, 1.0

    if opts.device_entropy is None:
        use_dev = device_entropy_default()
    else:
        use_dev = bool(opts.device_entropy)
    if use_dev:
        data = _encode_from_coefs_device(coefs, w, h, quality, subsample,
                                         opts.optimize_huffman)
    else:
        data = encode_jpeg_from_coefs(coefs, w, h, quality, subsample,
                                      optimize=opts.optimize_huffman)
    return quality, ssim_val, data


def _encode_from_coefs_device(coefs, w: int, h: int, quality: int,
                              subsample: bool, optimize: bool) -> bytes:
    """Single-image device Huffman emission (byte-identical to the host
    encoder): quantize at the winning quality, pull only tiny symbol
    histograms + the exact bit count, emit the bitstream on device with
    standard or per-image optimal tables, and wrap the container on the
    host.  The device→host transfer is ≈ the output file size instead of
    the quantized coefficients."""
    from ..codecs.huffopt import specs_and_tables_batch
    from ..codecs.jpeg import (
        _dht_segment_custom,
        assemble_jpeg,
        quantize_coefs_device,
    )
    from ..ops.jpeg_emit import emit_words_for_bits, finalize_scan_host
    from ..parallel.batched import (
        batched_emit_custom,
        batched_emit_std,
        packed_hist_bits,
        pull_emit_words,
    )

    from ..ops import jpeg_emit as _je

    qt = jnp.asarray(dct_ops.all_quality_tables()[quality],
                     dtype=jnp.float32)
    qy, qcb, qcr = quantize_coefs_device(coefs, qt, subsample)
    packed = jnp.concatenate([qy, qcb, qcr], axis=0).astype(jnp.int16)[None]
    # ONE pull for bits_std + both histograms (packed (B, 545) int32).
    hb = np.asarray(packed_hist_bits(packed, h, w, subsample))
    nbits = int(hb[0, 0])
    max_words = emit_words_for_bits(nbits)
    dht = None
    tabs_dev = None
    if optimize:
        specs, dc_tabs, ac_tabs = specs_and_tables_batch(
            hb[:, 1:33].reshape(-1, 2, 16).astype(np.int64),
            hb[:, 33:545].reshape(-1, 2, 256).astype(np.int64))
        tabs_dev = jnp.asarray(np.concatenate([dc_tabs, ac_tabs],
                                              axis=2))
        wb = batched_emit_custom(packed, tabs_dev, h, w, subsample,
                                 max_words, _je.EMIT_LWORDS)
        dht = _dht_segment_custom(*specs[0])
    else:
        wb = batched_emit_std(packed, h, w, subsample, max_words,
                              _je.EMIT_LWORDS)
    words_h, bits_h, bovf = pull_emit_words(wb, max_words)
    if bool(bovf[0]):
        # A block outgrew the optimistic emit buffer (exact flag, rare):
        # re-emit at the safe LWORDS width — byte-identical semantics.
        if optimize:
            wb = batched_emit_custom(packed, tabs_dev, h, w, subsample,
                                     max_words, 0)
        else:
            wb = batched_emit_std(packed, h, w, subsample, max_words, 0)
        words_h, bits_h, _ = pull_emit_words(wb, max_words)
    scan = finalize_scan_host(words_h[0], int(bits_h[0]))
    return assemble_jpeg(w, h, dct_ops.all_quality_tables()[quality],
                         scan, subsample, dht=dht)


# ── PNG optimizer ───────────────────────────────────────────────────────────


def try_palettize(img: np.ndarray,
                  max_colors: int = 256) -> Optional[Tuple[np.ndarray,
                                                           np.ndarray]]:
    """Exact color census: (indices, palette) if the image has at most
    max_colors distinct RGBA colors, else None (reference compress.go:112-153)."""
    arr = to_nrgba_ref(np.asarray(img))
    h, w = arr.shape[:2]
    flat = arr.reshape(-1, 4)
    as_u32 = flat.view(np.uint32).reshape(-1)
    uniq, inverse = np.unique(as_u32, return_inverse=True)
    if uniq.size > max_colors:
        return None
    palette = uniq.view(np.uint8).reshape(-1, 4)
    return inverse.reshape(h, w).astype(np.uint8), palette


def compress_png(img: np.ndarray, opts: Optional[Options] = None) -> bytes:
    """PNG-specific optimizations (reference compress.go:90-108):
    palettize when ≤256 colors, grayscale when R==G==B, else full RGBA —
    always at maximum compression."""
    arr = to_nrgba_ref(np.asarray(img))
    pal = try_palettize(arr, 256)
    if pal is not None:
        indices, palette = pal
        return png_codec.encode_png_paletted(indices, palette)
    if is_grayscale(arr):
        return png_codec.encode_png_gray(to_gray(arr))
    return png_codec.encode_png_rgba(arr)
