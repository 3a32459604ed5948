"""Halved YCbCr 4:2:0 pixel wire (FENNEC_PIXEL_WIRE=yuv420).

The host conversion must mirror forward_dct_device's convert + pad +
2×2-mean chroma exactly up to the uint8 wire rounding (≤0.5 per DCT
input sample), and the engine route must produce results equivalent to
the RGB wire: same chosen qualities on non-knife-edge content, SSIM
within the rounding bound, decodable output.
"""

import numpy as np
import pytest

import fennec_tpu as fennec
import fennec_tpu.engine.batched as eb
from conftest import make_test_image


def photo(w, h, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.empty((h, w, 4), np.uint8)
    base = np.stack([x * 255 / w, y * 255 / h,
                     (x + y) * 255 / (w + h)], axis=-1)
    img[..., :3] = np.clip(base + rng.normal(0, 8, (h, w, 3)), 0, 255)
    img[..., 3] = 255
    return img


class TestWireHostConversion:
    def test_matches_device_convert(self):
        """Wire planes == device's f32 convert path, rounded to u8."""
        import jax.numpy as jnp

        from fennec_tpu.ops import dct as dct_ops
        from fennec_tpu.ops.color import rgb_to_ycbcr

        img = photo(52, 36, 7)  # exercises edge padding (52→64? no: 52+12)
        h, w = img.shape[:2]
        buf = eb._yuv420_wire_host(img[None, ..., :3], h, w)

        ycc = np.asarray(rgb_to_ycbcr(
            jnp.asarray(img[..., :3], jnp.float32)))
        ph, pw = h + (-h) % 16, w + (-w) % 16
        y = np.asarray(dct_ops.pad_to_multiple(
            jnp.asarray(ycc[..., 0]), 16, 16))
        cb = np.asarray(dct_ops.downsample_420(dct_ops.pad_to_multiple(
            jnp.asarray(ycc[..., 1]), 16, 16)))
        cr = np.asarray(dct_ops.downsample_420(dct_ops.pad_to_multiple(
            jnp.asarray(ycc[..., 2]), 16, 16)))
        ny, nc = ph * pw, (ph // 2) * (pw // 2)
        got_y = buf[0, :ny].reshape(ph, pw).astype(np.float32)
        got_cb = buf[0, ny:ny + nc].reshape(ph // 2,
                                            pw // 2).astype(np.float32)
        got_cr = buf[0, ny + nc:].reshape(ph // 2,
                                          pw // 2).astype(np.float32)
        # u8 rounding is the only structural deviation; the native
        # 16.16 fixed-point pass adds ≤0.02 of coefficient error on
        # top (native/entropy.cpp fennec_rgb_to_yuv420).
        assert np.max(np.abs(got_y - y)) <= 0.53
        assert np.max(np.abs(got_cb - cb)) <= 0.53
        assert np.max(np.abs(got_cr - cr)) <= 0.53

    def test_direct_strided_matches_batch_entry(self):
        """The per-image strided entry (feeder fast path: converts
        straight from NRGBA arrays, no staging stack) must be byte-
        identical to the batch entry for every accepted layout."""
        import fennec_tpu.native as nat

        rng = np.random.default_rng(5)
        img = rng.integers(0, 256, (52, 36, 4), dtype=np.uint8)
        img[..., 3] = 255
        batch = nat.rgb_to_yuv420(np.ascontiguousarray(img[None, ..., :3]))
        if batch is None:
            pytest.skip("native runtime unavailable")
        row = np.empty(batch.shape[1], np.uint8)
        for layout in (img,                                 # RGBA, ps=4
                       np.ascontiguousarray(img[..., :3]),  # RGB, ps=3
                       img[..., :3],                        # strided view
                       img[::1, ::1][..., :3].astype(np.uint8)[::1]):
            row[:] = 0
            assert nat.rgba_to_yuv420_into(layout, row)
            assert np.array_equal(batch[0], row), layout.strides
        # Non-trivial layout (negative stride) goes through the
        # contiguous-copy fallback and still matches the flipped image.
        flipped = img[::-1, :, :3]
        batch_f = nat.rgb_to_yuv420(np.ascontiguousarray(flipped)[None])
        row[:] = 0
        assert nat.rgba_to_yuv420_into(flipped, row)
        assert np.array_equal(batch_f[0], row)

    def test_native_matches_numpy_within_1_lsb(self):
        import fennec_tpu.native as nat

        stack = np.clip(np.random.default_rng(2).normal(
            120, 60, (3, 52, 36, 3)), 0, 255).astype(np.uint8)
        native = nat.rgb_to_yuv420(stack)
        if native is None:
            pytest.skip("native runtime unavailable")
        real = nat.rgb_to_yuv420
        nat.rgb_to_yuv420 = lambda x: None
        try:
            ref = eb._yuv420_wire_host(stack, 52, 36)
        finally:
            nat.rgb_to_yuv420 = real
        d = np.abs(native.astype(np.int16) - ref.astype(np.int16))
        assert d.max() <= 1
        assert (d > 0).mean() < 0.01  # knife edges only


class TestWireEngineRoute:
    def _run(self, imgs, wire):
        opts = fennec.Options(format=fennec.JPEG, device_entropy=True,
                              optimize_huffman=True)
        old = eb.PIXEL_WIRE
        eb.PIXEL_WIRE = wire
        try:
            return eb.compress_images_batched(None, imgs, opts)
        finally:
            eb.PIXEL_WIRE = old

    def test_equivalent_to_rgb_wire(self):
        imgs = [photo(64, 48, s) for s in range(4)]
        rgb = self._run(imgs, "rgb")
        yuv = self._run(imgs, "yuv420")
        for a, b in zip(rgb, yuv):
            assert b.compressed_data  # produced
            # The wire is lossy by design (u8 plane rounding + the
            # native pass's 16.16 coefficients): a bisection landing on
            # a knife edge may move ONE quality step on tiny noisy
            # images; the preset contract — SSIM within the reference's
            # target band (fennec_test.go:233-259) — must always hold.
            assert abs(a.jpeg_quality - b.jpeg_quality) <= 1
            assert b.ssim >= 0.94 - 0.02  # Balanced band
            if a.jpeg_quality == b.jpeg_quality:
                assert a.ssim == pytest.approx(b.ssim, abs=2e-3)

    def test_decodes_correctly(self):
        import io

        from PIL import Image

        img = make_test_image(120, 88)
        rs = self._run([img], "yuv420")
        got = Image.open(io.BytesIO(rs[0].compressed_data))
        assert got.size == (120, 88)
        # Pixel-level sanity vs the source (JPEG-lossy, not exact).
        arr = np.asarray(got.convert("RGB"), np.float32)
        src = img[..., :3].astype(np.float32)
        assert np.mean(np.abs(arr - src)) < 8.0

    def test_alpha_chunks_stay_rgb(self):
        # Non-opaque chunks must not take the wire (alpha compositing
        # needs the alpha plane) — results still correct.
        img = photo(48, 48, 3)
        img[..., 3] = 200
        rs = self._run([img], "yuv420")
        assert rs[0].compressed_data

    def test_fused_opt_wire(self, monkeypatch):
        monkeypatch.setattr(eb, "FUSED_OPT", True)
        imgs = [photo(64, 48, s) for s in range(3)]
        rgb = self._run(imgs, "rgb")
        yuv = self._run(imgs, "yuv420")
        for a, b in zip(rgb, yuv):
            assert abs(a.jpeg_quality - b.jpeg_quality) <= 1
            assert b.ssim >= 0.94 - 0.02
            if a.jpeg_quality == b.jpeg_quality:
                assert a.ssim == pytest.approx(b.ssim, abs=2e-3)
