"""Fused mega-batch engine tests: equivalence with the per-image path."""

import numpy as np
import pytest

import fennec_tpu as fennec
from conftest import (
    make_noise_image,
    make_solid_image,
    make_test_image_with_alpha,
)
from fennec_tpu.codecs import png as png_codec
from fennec_tpu.engine.batched import compress_images_batched


def photo(w, h, seed):
    rng = np.random.default_rng(seed)
    img = make_noise_image(w, h, seed=seed).astype(np.int16)
    img[..., :3] = np.clip(img[..., :3] // 3 + 80 + rng.integers(-5, 5),
                           0, 255)
    img[..., 3] = 255
    return img.astype(np.uint8)


class TestCompressImagesBatched:
    def test_matches_per_image_path(self):
        imgs = [photo(64, 48, s) for s in range(5)]
        opts = fennec.Options(format=fennec.JPEG)
        batched = compress_images_batched(None, imgs, opts)
        for img, got in zip(imgs, batched):
            want = fennec.compress_image(None, img, fennec.Options(
                format=fennec.JPEG))
            assert got.jpeg_quality == want.jpeg_quality
            assert got.ssim == pytest.approx(want.ssim, abs=1e-5)
            assert got.compressed_data == want.compressed_data

    def test_mixed_shapes_bucketing(self):
        imgs = [photo(64, 48, 1), photo(32, 32, 2), photo(64, 48, 3),
                photo(32, 32, 4)]
        out = compress_images_batched(None, imgs,
                                      fennec.Options(format=fennec.JPEG))
        assert [r.final_dimensions for r in out] == \
            [(64, 48), (32, 32), (64, 48), (32, 32)]
        for r in out:
            assert r.compressed_size > 0

    def test_auto_format_routing(self):
        imgs = [make_test_image_with_alpha(40, 40),  # → PNG
                make_noise_image(64, 64, seed=9),    # → JPEG
                make_solid_image(32, 32, 5, 6, 7)]   # → PNG (few colors)
        out = compress_images_batched(None, imgs, fennec.Options())
        assert out[0].format == fennec.PNG
        assert out[1].format == fennec.JPEG
        assert out[2].format == fennec.PNG
        assert out[0].ssim == 1.0

    def test_resize_applied(self):
        out = compress_images_batched(
            None, [photo(128, 96, 1)],
            fennec.Options(format=fennec.JPEG, max_width=64))
        assert out[0].final_dimensions == (64, 48)

    def test_empty(self):
        assert compress_images_batched(None, [], fennec.Options()) == []

    def test_compress_images_workers_passthrough(self):
        # The public API must pass `workers` through to the fused engine
        # and produce identical results regardless of pool size.
        imgs = [photo(48, 48, s) for s in range(3)]
        opts = fennec.Options(format=fennec.JPEG)
        base = fennec.compress_images(None, imgs, opts)
        narrow = fennec.compress_images(None, imgs, opts, workers=1)
        for a, b in zip(base, narrow):
            assert a.compressed_data == b.compressed_data
            assert a.jpeg_quality == b.jpeg_quality


class TestFusedFileBatch:
    def test_fused_matches_pool(self, tmp_path):
        paths = []
        for i in range(8):
            p = tmp_path / f"in{i}.png"
            p.write_bytes(png_codec.encode_png_rgba(photo(48, 48, i)))
            paths.append(str(p))
        items_a = [fennec.BatchItem(src=p, dst=str(tmp_path / f"a{i}.jpg"))
                   for i, p in enumerate(paths)]
        items_b = [fennec.BatchItem(src=p, dst=str(tmp_path / f"b{i}.jpg"))
                   for i, p in enumerate(paths)]
        opts = fennec.BatchOptions(
            default_opts=fennec.Options(format=fennec.JPEG))
        ra = fennec.compress_batch(None, items_a,
                                   fennec.BatchOptions(
                                       default_opts=opts.default_opts,
                                       fused=True))
        rb = fennec.compress_batch(None, items_b,
                                   fennec.BatchOptions(
                                       default_opts=opts.default_opts,
                                       fused=False))
        for a, b in zip(ra, rb):
            assert a.err is None and b.err is None
            assert a.result.jpeg_quality == b.result.jpeg_quality
            assert a.result.compressed_size == b.result.compressed_size
            assert a.result.original_size == b.result.original_size

    def test_fused_bad_file_captured(self, tmp_path):
        good = tmp_path / "g.png"
        good.write_bytes(png_codec.encode_png_rgba(photo(32, 32, 0)))
        items = [
            fennec.BatchItem(src=str(good), dst=str(tmp_path / "g.jpg")),
            fennec.BatchItem(src="/nonexistent.png",
                             dst=str(tmp_path / "x.jpg")),
        ]
        res = fennec.compress_batch(None, items,
                                    fennec.BatchOptions(fused=True))
        assert res[0].err is None
        assert res[1].err is not None

    def test_fused_progress(self, tmp_path):
        seen = []
        paths = []
        for i in range(3):
            p = tmp_path / f"p{i}.png"
            p.write_bytes(png_codec.encode_png_rgba(photo(32, 32, i)))
            paths.append(str(p))
        items = [fennec.BatchItem(src=p, dst=str(tmp_path / f"o{i}.jpg"))
                 for i, p in enumerate(paths)]
        fennec.compress_batch(
            None, items,
            fennec.BatchOptions(fused=True,
                                on_item=lambda c, t: seen.append((c, t))))
        assert len(seen) == 3

    def test_fused_streams_writes_per_chunk(self, tmp_path, monkeypatch):
        """Files land on disk and OnItem ticks as device chunks finish,
        not in one burst after the whole batch (reference fires OnItem
        per completed item, batch.go:108-124)."""
        import os

        from fennec_tpu.engine import batched as batched_mod

        monkeypatch.setattr(batched_mod, "BATCH_CHUNK", 4)
        n = 10
        items = []
        for i in range(n):
            p = tmp_path / f"s{i}.png"
            p.write_bytes(png_codec.encode_png_rgba(photo(32, 32, i)))
            items.append(fennec.BatchItem(
                src=str(p), dst=str(tmp_path / f"d{i}.jpg")))
        on_disk_at_call = []

        def on_item(completed, total):
            assert total == n
            on_disk_at_call.append(sum(
                os.path.exists(it.dst) for it in items))

        res = fennec.compress_batch(
            None, items, fennec.BatchOptions(fused=True,
                                             on_item=on_item))
        assert all(r.err is None for r in res)
        assert len(on_disk_at_call) == n
        # The k-th callback fires with at least k files already written
        # (the callback IS the write notification), and strictly before
        # the final burst would have: the first callback must see fewer
        # than n files on disk (streaming, not end-burst).
        assert all(d >= k + 1 for k, d in enumerate(on_disk_at_call))
        assert on_disk_at_call[0] < n


class TestFusedOrientation:
    def test_exif_oriented_jpeg_in_fused_batch(self, tmp_path):
        """EXIF-rotated JPEGs must disqualify the coefficient fast path and
        come out upright via the pixel path."""
        from fennec_tpu.codecs.jpeg import encode_jpeg
        from fennec_tpu.exif import Orientation, write_exif_orientation

        img = photo(48, 32, 3)  # landscape 48x32
        data = encode_jpeg(img, 92)
        tagged = data[:2] + write_exif_orientation(
            Orientation.ROTATE_90_CW) + data[2:]
        srcs = []
        for i in range(3):
            p = tmp_path / f"r{i}.jpg"
            p.write_bytes(tagged)
            srcs.append(str(p))
        items = [fennec.BatchItem(src=s, dst=str(tmp_path / f"o{i}.jpg"))
                 for i, s in enumerate(srcs)]
        res = fennec.compress_batch(
            None, items, fennec.BatchOptions(
                fused=True,
                default_opts=fennec.Options(format=fennec.JPEG)))
        for r in res:
            assert r.err is None
            assert r.result.final_dimensions == (32, 48)  # rotated upright

    def test_no_orient_keeps_fast_path_dims(self, tmp_path):
        from fennec_tpu.codecs.jpeg import encode_jpeg
        from fennec_tpu.exif import Orientation, write_exif_orientation

        img = photo(48, 32, 3)
        data = encode_jpeg(img, 92)
        tagged = data[:2] + write_exif_orientation(
            Orientation.ROTATE_90_CW) + data[2:]
        p = tmp_path / "x.jpg"
        p.write_bytes(tagged)
        items = [fennec.BatchItem(src=str(p), dst=str(tmp_path / "y.jpg"))]
        res = fennec.compress_batch(
            None, items, fennec.BatchOptions(
                fused=True,
                default_opts=fennec.Options(format=fennec.JPEG,
                                            auto_orient=False)))
        assert res[0].err is None
        assert res[0].result.final_dimensions == (48, 32)


class TestFusedProgressContract:
    def test_progress_ticks_errored_items(self, tmp_path):
        """OnItem must reach n/n even when some files are unreadable or
        undecodable — the per-file pool ticks after its per-item except
        (batch.go:108-124), and the fused path must match."""
        seen = []
        items = []
        for i in range(3):
            p = tmp_path / f"g{i}.png"
            p.write_bytes(png_codec.encode_png_rgba(photo(32, 32, i)))
            items.append(fennec.BatchItem(
                src=str(p), dst=str(tmp_path / f"og{i}.jpg")))
        bad = tmp_path / "corrupt.png"
        bad.write_bytes(b"definitely not an image")
        items.append(fennec.BatchItem(
            src=str(bad), dst=str(tmp_path / "obad.jpg")))
        items.append(fennec.BatchItem(
            src=str(tmp_path / "missing.png"),
            dst=str(tmp_path / "omiss.jpg")))
        n = len(items)
        res = fennec.compress_batch(
            None, items,
            fennec.BatchOptions(fused=True,
                                on_item=lambda c, t: seen.append((c, t))))
        assert len(seen) == n
        assert sorted(c for c, _ in seen) == list(range(1, n + 1))
        assert all(t == n for _, t in seen)
        assert res[3].err is not None and res[4].err is not None
        assert all(res[i].err is None for i in range(3))

    def test_cancel_marks_pending_without_warning(self, tmp_path,
                                                  monkeypatch):
        """Mid-batch cancellation is a normal outcome: remaining items get
        the context error (batch.go:93-99), with NO fused-path-failed
        warning and no fallback pool re-run."""
        import warnings

        from fennec_tpu.engine import batched as batched_mod

        monkeypatch.setattr(batched_mod, "BATCH_CHUNK", 2)
        n = 12
        items = []
        for i in range(n):
            p = tmp_path / f"c{i}.png"
            p.write_bytes(png_codec.encode_png_rgba(photo(32, 32, i)))
            items.append(fennec.BatchItem(
                src=str(p), dst=str(tmp_path / f"oc{i}.jpg")))
        ctx = fennec.Context()

        def on_item(c, t):
            if c == 1:
                ctx.cancel()

        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            res = fennec.compress_batch(
                ctx, items,
                fennec.BatchOptions(fused=True, on_item=on_item))
        assert len(res) == n
        canceled = [r for r in res
                    if isinstance(r.err, fennec.CanceledError)]
        finished = [r for r in res if r.err is None and r.result is not None]
        assert canceled, "cancellation did not mark any pending item"
        assert len(canceled) + len(finished) == n


class TestDeviceFaultIsolation:
    """Injected device faults (the round-3 bench failure mode: an
    InvalidArgument out of the fused chunk program) must never lose
    items — the engine isolates the chunk, retries at a smaller chunk
    size, and batch.py's pool fallback covers whatever remains
    (reference contract: the worker pool never returns 0/N on decodable
    inputs, batch.go:58-128)."""

    def _jpeg_items(self, tmp_path, n, tag=""):
        from fennec_tpu.codecs.jpeg import encode_jpeg

        items = []
        for i in range(n):
            p = tmp_path / f"f{tag}{i}.jpg"
            p.write_bytes(encode_jpeg(photo(48, 48, i), 92))
            items.append(fennec.BatchItem(
                src=str(p), dst=str(tmp_path / f"of{tag}{i}.jpg")))
        return items

    def _patch_search_raise(self, monkeypatch, exc_factory):
        """Make every fused-chunk search dispatch raise (both upload
        formats, so the test holds whichever the chunk prep picks)."""
        import fennec_tpu.parallel.batched as pb

        def boom(*a, **k):
            raise exc_factory()

        monkeypatch.setattr(pb, "batched_search_coo", boom)
        monkeypatch.setattr(pb, "batched_decode_search_quantize_i8", boom)
        monkeypatch.setattr(pb, "batched_decode_search_opt_i8", boom)
        monkeypatch.setattr(pb, "batched_decode_search_hist_i8", boom)
        monkeypatch.setattr(pb, "batched_decode_search_emit_i8", boom)

    def test_persistent_device_fault_recovers_via_pool(
            self, tmp_path, monkeypatch):
        """Every fused dispatch raises InvalidArgument → all items must
        still complete through the per-file pool fallback."""
        import warnings

        import jax

        self._patch_search_raise(
            monkeypatch,
            lambda: jax.errors.JaxRuntimeError(
                "INVALID_ARGUMENT: injected backend error"))
        items = self._jpeg_items(tmp_path, 6)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fennec.compress_batch(
                None, items,
                fennec.BatchOptions(fused=True, default_opts=fennec.Options(
                    format=fennec.JPEG)))
        assert all(r.err is None for r in res), \
            [str(r.err)[:80] for r in res if r.err]
        import os
        assert all(os.path.exists(it.dst) for it in items)
        assert any("fused batch path failed" in str(x.message) for x in w)

    def test_transient_fault_recovers_in_engine(self, tmp_path,
                                                monkeypatch):
        """Only the FIRST chunk dispatch raises → the engine's own
        chunk-size backoff retry must land every item with NO fallback
        warning and no per-file pool."""
        import warnings

        import jax
        import fennec_tpu.parallel.batched as pb

        calls = {"n": 0}
        real_coo = pb.batched_search_coo
        real_i8 = pb.batched_decode_search_quantize_i8

        def flaky(real):
            def fn(*a, **k):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise jax.errors.JaxRuntimeError(
                        "INVALID_ARGUMENT: injected transient")
                return real(*a, **k)
            return fn

        monkeypatch.setattr(pb, "batched_search_coo", flaky(real_coo))
        monkeypatch.setattr(pb, "batched_decode_search_quantize_i8",
                            flaky(real_i8))
        items = self._jpeg_items(tmp_path, 6, tag="t")
        with warnings.catch_warnings():
            warnings.simplefilter("error", RuntimeWarning)
            res = fennec.compress_batch(
                None, items,
                fennec.BatchOptions(fused=True, default_opts=fennec.Options(
                    format=fennec.JPEG)))
        assert calls["n"] >= 2, "backoff retry never re-dispatched"
        assert all(r.err is None for r in res)

    def test_wedged_device_fails_fast_without_retry(self, tmp_path,
                                                    monkeypatch):
        """A chunk pull that hangs past FENNEC_CHUNK_TIMEOUT marks the
        device wedged: the batch returns promptly with per-item errors
        (no per-file device retries that would hang one by one, no
        0-success run misreported as progress)."""
        import time as _time
        import warnings

        from fennec_tpu.engine import batched as batched_mod
        import fennec_tpu.parallel.batched as pb

        monkeypatch.setattr(batched_mod, "BATCH_CHUNK", 2)
        monkeypatch.setattr(batched_mod, "CHUNK_TIMEOUT", 0.5)
        real_split = pb.split_packed
        state = {"hung": False}

        def hanging_split(*a, **k):
            if not state["hung"]:
                state["hung"] = True
                _time.sleep(4.0)
            return real_split(*a, **k)

        monkeypatch.setattr(pb, "split_packed", hanging_split)
        items = self._jpeg_items(tmp_path, 8, tag="w")
        t0 = _time.perf_counter()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fennec.compress_batch(
                None, items,
                fennec.BatchOptions(fused=True, default_opts=fennec.Options(
                    format=fennec.JPEG)))
        elapsed = _time.perf_counter() - t0
        assert any("unresponsive" in str(x.message) for x in w)
        failed = [r for r in res if r.err is not None]
        done = [r for r in res if r.err is None]
        # The hung chunk and everything after it error out; chunks that
        # completed before the hang may have streamed.
        assert failed, "no item carries the wedged-device error"
        assert len(failed) + len(done) == len(items)
        assert elapsed < 30.0
