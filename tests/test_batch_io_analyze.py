"""Batch engine, file I/O, and analyzer tests
(reference batch/io/analyze test suites)."""

import os
import threading

import numpy as np
import pytest

import fennec_tpu as fennec
from conftest import (
    make_noise_image,
    make_solid_image,
    make_test_image,
    make_test_image_with_alpha,
)
from fennec_tpu.codecs import png as png_codec
from fennec_tpu.codecs.jpeg import encode_jpeg


@pytest.fixture
def image_files(tmp_path):
    paths = []
    for i, img in enumerate([
        make_test_image(96, 64),
        make_noise_image(80, 80, seed=1),
        make_test_image_with_alpha(64, 48),
    ]):
        p = tmp_path / f"img{i}.png"
        p.write_bytes(png_codec.encode_png_rgba(img))
        paths.append(str(p))
    return paths


class TestIO:
    def test_open_save_roundtrip(self, tmp_path):
        img = make_test_image(50, 40)
        p = tmp_path / "x.png"
        fennec.save(img, str(p))
        out = fennec.open_image(str(p))
        np.testing.assert_array_equal(out, img)

    def test_save_jpeg(self, tmp_path):
        img = make_noise_image(64, 64, seed=2)
        p = tmp_path / "x.jpg"
        fennec.save(img, str(p))
        out = fennec.open_image(str(p))
        assert out.shape == img.shape

    def test_save_bad_extension(self, tmp_path):
        with pytest.raises(fennec.UnsupportedFormatError):
            fennec.save(make_test_image(8, 8), str(tmp_path / "x.webp"))

    def test_open_missing_file(self):
        with pytest.raises(FileNotFoundError):
            fennec.open_image("/nonexistent/nope.png")

    def test_open_and_orient(self, tmp_path):
        from fennec_tpu.exif import Orientation, write_exif_orientation
        img = make_test_image(40, 30)
        jpeg = encode_jpeg(img, 92)
        # Inject an EXIF APP1 right after SOI.
        tagged = jpeg[:2] + write_exif_orientation(
            Orientation.ROTATE_90_CW) + jpeg[2:]
        p = tmp_path / "oriented.jpg"
        p.write_bytes(tagged)
        plain = fennec.open_image(str(p))
        oriented = fennec.open_and_orient(str(p))
        assert plain.shape == (30, 40, 4)
        assert oriented.shape == (40, 30, 4)

    def test_compress_file_applies_orientation(self, tmp_path):
        from fennec_tpu.exif import Orientation, write_exif_orientation
        img = make_noise_image(48, 32, seed=3)
        jpeg = encode_jpeg(img, 92)
        tagged = jpeg[:2] + write_exif_orientation(
            Orientation.ROTATE_90_CW) + jpeg[2:]
        src = tmp_path / "in.jpg"
        src.write_bytes(tagged)
        res = fennec.compress_file(None, str(src), str(tmp_path / "out.jpg"),
                                   fennec.Options(format=fennec.JPEG))
        assert res.final_dimensions == (32, 48)  # rotated
        res2 = fennec.compress_file(None, str(src),
                                    str(tmp_path / "out2.jpg"),
                                    fennec.Options(format=fennec.JPEG,
                                                   auto_orient=False))
        assert res2.final_dimensions == (48, 32)


class TestBatch:
    def test_empty(self):
        assert fennec.compress_batch(None, []) == []

    def test_order_preserved(self, image_files, tmp_path):
        items = [fennec.BatchItem(src=p, dst=str(tmp_path / f"out{i}.jpg"))
                 for i, p in enumerate(image_files)]
        results = fennec.compress_batch(None, items,
                                        fennec.BatchOptions(workers=2))
        assert len(results) == len(items)
        for i, r in enumerate(results):
            assert r.index == i
            assert r.item.src == image_files[i]
            assert r.err is None
            assert os.path.exists(r.item.dst)

    def test_per_item_error_capture(self, image_files, tmp_path):
        items = [
            fennec.BatchItem(src=image_files[0],
                             dst=str(tmp_path / "a.jpg")),
            fennec.BatchItem(src="/nonexistent/x.png",
                             dst=str(tmp_path / "b.jpg")),
        ]
        results = fennec.compress_batch(None, items)
        assert results[0].err is None
        assert results[1].err is not None
        s = fennec.summarize(results)
        assert s.succeeded == 1 and s.failed == 1

    def test_progress_callback_thread_safe(self, image_files, tmp_path):
        seen = []
        lock = threading.Lock()

        def on_item(completed, total):
            with lock:
                seen.append((completed, total))

        items = [fennec.BatchItem(src=p, dst=str(tmp_path / f"o{i}.jpg"))
                 for i, p in enumerate(image_files)]
        fennec.compress_batch(None, items,
                              fennec.BatchOptions(workers=3,
                                                  on_item=on_item))
        assert sorted(c for c, _ in seen) == [1, 2, 3]
        assert all(t == 3 for _, t in seen)

    def test_canceled_context(self, image_files, tmp_path):
        ctx = fennec.Context.background().with_cancel()
        ctx.cancel()
        items = [fennec.BatchItem(src=p, dst=str(tmp_path / f"c{i}.jpg"))
                 for i, p in enumerate(image_files)]
        results = fennec.compress_batch(ctx, items)
        assert all(isinstance(r.err, fennec.CanceledError) for r in results)

    def test_per_item_options(self, image_files, tmp_path):
        items = [
            fennec.BatchItem(src=image_files[1],
                             dst=str(tmp_path / "hi.jpg"),
                             opts=fennec.Options(quality=fennec.ULTRA,
                                                 format=fennec.JPEG)),
            fennec.BatchItem(src=image_files[1],
                             dst=str(tmp_path / "lo.jpg"),
                             opts=fennec.Options(quality=fennec.MAXIMUM,
                                                 format=fennec.JPEG)),
        ]
        results = fennec.compress_batch(None, items)
        assert results[0].result.compressed_size >= \
            results[1].result.compressed_size

    def test_summary_string(self, image_files, tmp_path):
        items = [fennec.BatchItem(src=image_files[0],
                                  dst=str(tmp_path / "s.jpg"))]
        s = fennec.summarize(fennec.compress_batch(None, items))
        assert "1/1 succeeded" in str(s)

    def test_summarize_excludes_skipped_from_avg_ssim(self):
        """skip_existing items (result=None, err=None) count as succeeded
        but must not dilute avg_ssim."""
        from fennec_tpu.types import Result

        item = fennec.BatchItem(src="a", dst="b")
        scored = fennec.BatchResult(
            item=item, result=Result(ssim=0.95, original_size=100,
                                     compressed_size=50), index=0)
        skipped = fennec.BatchResult(item=item, result=None, index=1)
        s = fennec.summarize([scored, skipped])
        assert s.succeeded == 2 and s.failed == 0
        assert s.avg_ssim == pytest.approx(0.95)

    def test_skip_existing(self, image_files, tmp_path):
        dst = tmp_path / "skip.jpg"
        dst.write_bytes(b"existing")
        items = [fennec.BatchItem(src=image_files[0], dst=str(dst))]
        results = fennec.compress_batch(
            None, items, fennec.BatchOptions(skip_existing=True))
        assert results[0].err is None and results[0].result is None
        assert dst.read_bytes() == b"existing"


class TestAnalyze:
    def test_solid_image(self):
        stats = fennec.analyze(make_solid_image(64, 64, 100, 150, 200))
        assert stats.width == 64 and stats.height == 64
        assert not stats.has_alpha
        assert not stats.is_grayscale
        assert stats.unique_colors == 1
        assert stats.entropy == pytest.approx(0.0, abs=1e-6)
        assert stats.edge_density == pytest.approx(0.0, abs=1e-6)
        assert stats.contrast == pytest.approx(0.0, abs=1e-4)
        assert stats.recommended_format == fennec.PNG

    def test_noise_image(self):
        stats = fennec.analyze(make_noise_image(128, 128, seed=4))
        assert stats.entropy > 6.0
        assert stats.unique_colors > 1000 or stats.unique_colors == 1024
        assert stats.recommended_format == fennec.JPEG

    def test_grayscale_detection(self):
        g = make_solid_image(32, 32, 77, 77, 77)
        stats = fennec.analyze(g)
        assert stats.is_grayscale

    def test_alpha_detection(self):
        stats = fennec.analyze(make_test_image_with_alpha(32, 32))
        assert stats.has_alpha
        assert stats.recommended_format == fennec.PNG

    def test_mean_brightness(self):
        black = fennec.analyze(make_solid_image(16, 16, 0, 0, 0))
        white = fennec.analyze(make_solid_image(16, 16, 255, 255, 255))
        assert black.mean_brightness == pytest.approx(0.0, abs=0.5)
        assert white.mean_brightness == pytest.approx(255.0, abs=0.5)

    def test_striped_high_edge_density(self):
        from conftest import make_striped_image
        stats = fennec.analyze(make_striped_image(128, 128))
        assert stats.edge_density > 0.1
        assert stats.contrast > 50

    def test_empty_image_safe(self):
        stats = fennec.analyze(np.zeros((1, 1, 4), dtype=np.uint8))
        assert stats.width == 1
