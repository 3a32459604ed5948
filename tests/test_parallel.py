"""Multi-chip sharding tests on the 8-virtual-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import make_noise_image, make_test_image
from fennec_tpu.engine.compress import compress_jpeg_optimal
from fennec_tpu.ops.ssim import ssim_fast
from fennec_tpu.parallel import (
    batched_quality_search,
    batched_quality_search_sharded,
    batched_ssim,
)
from fennec_tpu.parallel.batched import batched_ssim_sharded
from fennec_tpu.parallel.mesh import (
    batch_sharding,
    data_mesh,
    data_spatial_mesh,
    make_mesh,
)
from fennec_tpu.types import Options


def batch_of_images(b, w, h):
    return np.stack([make_noise_image(w, h, seed=i) for i in range(b)])


class TestMesh:
    def test_eight_devices_available(self):
        assert len(jax.devices()) == 8

    def test_make_mesh_shapes(self):
        m = make_mesh((4, 2), ("data", "spatial"))
        assert m.axis_names == ("data", "spatial")
        assert m.devices.shape == (4, 2)

    def test_data_mesh(self):
        m = data_mesh()
        assert m.devices.size == 8

    def test_too_many_devices_raises(self):
        with pytest.raises(ValueError):
            make_mesh((16,), ("data",))


class TestBatchedSearch:
    def test_vmapped_matches_single(self):
        imgs = batch_of_images(4, 48, 48).astype(np.float32)
        targets = jnp.full((4,), 0.94, dtype=jnp.float32)
        qs, ssims, found = batched_quality_search(
            jnp.asarray(imgs), targets)
        assert qs.shape == (4,)
        # Cross-check against the host single-image path.
        q0, s0, _ = compress_jpeg_optimal(
            imgs[0].astype(np.uint8), 0.94, Options())
        assert int(qs[0]) == q0
        assert float(ssims[0]) == pytest.approx(s0, abs=1e-5)

    def test_per_image_targets(self):
        imgs = jnp.asarray(batch_of_images(2, 64, 64), dtype=jnp.float32)
        targets = jnp.asarray([0.85, 0.99], dtype=jnp.float32)
        qs, ssims, found = batched_quality_search(imgs, targets)
        assert int(qs[0]) <= int(qs[1])

    def test_sharded_matches_unsharded(self):
        mesh = data_mesh(8)
        imgs = jnp.asarray(batch_of_images(8, 32, 32), dtype=jnp.float32)
        targets = jnp.full((8,), 0.90, dtype=jnp.float32)
        q1, s1, f1 = batched_quality_search(imgs, targets)
        q2, s2, f2 = batched_quality_search_sharded(mesh, imgs, targets)
        np.testing.assert_array_equal(np.asarray(q1), np.asarray(q2))
        np.testing.assert_allclose(np.asarray(s1), np.asarray(s2),
                                   atol=1e-5)

    def test_sharded_search_emit_matches_unsharded(self):
        """The flagship search+quantize+device-emission path under a
        'data' mesh: every chip bit-packs its own shard; results must be
        byte-identical to the single-device program."""
        from fennec_tpu.ops.jpeg_emit import finalize_scan_host
        from fennec_tpu.parallel.batched import (
            batched_emit_std,
            batched_search_emit_sharded,
            batched_search_hist,
            pull_emit_words,
            split_search_small,
        )

        mesh = data_mesh(8)
        imgs = jnp.asarray(batch_of_images(8, 48, 32), dtype=jnp.float32)
        targets = jnp.full((8,), 0.90, dtype=jnp.float32)
        max_words = 2048

        small, packed = batched_search_hist(imgs, targets, True)
        q1, _s1, _f1, _bits, _dcf, _acf = split_search_small(
            np.asarray(small))
        w1, b1, _ovf1 = pull_emit_words(
            batched_emit_std(packed, 32, 48, True, max_words), max_words)
        q2, s2, f2, w2, b2 = batched_search_emit_sharded(
            mesh, imgs, targets, True, max_words)

        np.testing.assert_array_equal(np.asarray(q1), np.asarray(q2))
        np.testing.assert_array_equal(np.asarray(b1), np.asarray(b2))
        for j in range(8):
            a = finalize_scan_host(np.asarray(w1[j]), int(b1[j]))
            b = finalize_scan_host(np.asarray(w2[j]), int(b2[j]))
            assert a == b


class TestBatchedSSIM:
    def test_matches_host_ssim(self):
        a = batch_of_images(3, 40, 40).astype(np.float32)
        b = a.copy()
        b[:, :, :, :3] = np.clip(b[:, :, :, :3] + 10, 0, 255)
        got = np.asarray(batched_ssim(jnp.asarray(a), jnp.asarray(b)))
        for i in range(3):
            want = ssim_fast(a[i].astype(np.uint8), b[i].astype(np.uint8))
            assert got[i] == pytest.approx(want, abs=1e-4)

    def test_data_sharded(self):
        mesh = data_mesh(8)
        a = jnp.asarray(batch_of_images(8, 32, 32), dtype=jnp.float32)
        got = batched_ssim_sharded(mesh, a, a)
        np.testing.assert_allclose(np.asarray(got), 1.0, atol=1e-4)

    def test_data_spatial_sharded(self):
        # 4 chips on batch × 2 chips on image rows: XLA must insert the
        # halo exchange for the 8×8 SSIM windows.
        mesh = data_spatial_mesh(8, spatial=2)
        a = jnp.asarray(batch_of_images(4, 64, 64), dtype=jnp.float32)
        b = jnp.clip(a + 8.0, 0, 255)
        sharded = batched_ssim_sharded(mesh, a, b, spatial=True)
        unsharded = batched_ssim(a, b)
        np.testing.assert_allclose(np.asarray(sharded),
                                   np.asarray(unsharded), atol=1e-5)


class TestShardedSizeSearch:
    def test_matches_unsharded_bisect(self):
        # SPMD form of the target-size engine's S1: each virtual chip
        # bisects its shard; results must match the single-device path.
        from fennec_tpu.codecs.jpeg import forward_dct_device
        from fennec_tpu.engine.size_search import size_bisect_device
        from fennec_tpu.parallel.batched import batched_size_search_sharded

        mesh = data_mesh(8)
        imgs = batch_of_images(8, 48, 48)
        budget, lo, hi = 900, 1, 100
        qs, found = batched_size_search_sharded(mesh, imgs, budget, lo, hi)
        qs, found = np.asarray(qs), np.asarray(found)
        for i in range(8):
            coefs = forward_dct_device(
                jnp.asarray(imgs[i], dtype=jnp.float32), True)
            q1, f1 = size_bisect_device(
                coefs, 48, 48, True, target_bytes=jnp.int32(budget),
                lo0=jnp.int32(lo), hi0=jnp.int32(hi))
            assert bool(found[i]) == bool(f1)
            if bool(f1):
                assert int(qs[i]) == int(q1)


class TestSpatialShardedSearch:
    def test_matches_unsharded(self):
        """Full quality SEARCH (not just SSIM) with one image's rows
        sharded over 'spatial': same winning quality/SSIM/coefficients
        as the single-device program."""
        from fennec_tpu.codecs.jpeg import (
            forward_dct_device,
            quantize_coefs_device,
        )
        from fennec_tpu.engine.compress import quality_search_device
        from fennec_tpu.ops.dct import all_quality_tables
        from fennec_tpu.parallel import quality_search_spatial_sharded

        mesh = data_spatial_mesh(8, spatial=4)
        img = make_noise_image(96, 128, seed=11).astype(np.float32)
        # H=128 over 4 shards -> 32 rows each (multiple of 16).
        q, s, f, (qy, qcb, qcr) = quality_search_spatial_sharded(
            mesh, img, 0.92)
        q1, s1, f1 = quality_search_device(jnp.asarray(img),
                                           jnp.float32(0.92))
        assert int(q) == int(q1)
        assert bool(f) == bool(f1)
        assert float(s) == pytest.approx(float(s1), abs=1e-5)
        final_q = int(q) if bool(f) else 100
        coefs = forward_dct_device(jnp.asarray(img), True)
        qt = jnp.asarray(all_quality_tables()[final_q],
                         dtype=jnp.float32)
        wy, wcb, wcr = quantize_coefs_device(coefs, qt, True)
        np.testing.assert_allclose(np.asarray(qy), np.asarray(wy),
                                   atol=0)
        np.testing.assert_allclose(np.asarray(qcb), np.asarray(wcb),
                                   atol=0)
        np.testing.assert_allclose(np.asarray(qcr), np.asarray(wcr),
                                   atol=0)

    def test_bad_shard_height_raises(self):
        from fennec_tpu.parallel import quality_search_spatial_sharded

        mesh = data_spatial_mesh(8, spatial=4)
        img = make_noise_image(32, 40, seed=1).astype(np.float32)
        with pytest.raises(ValueError):
            quality_search_spatial_sharded(mesh, img, 0.92)


class TestSpatialShardedAtScale:
    """The sharded paths past toy shapes — value parity
    at the sizes that motivate spatial sharding (multi-K-pixel images
    where one chip's HBM budget / latency matters)."""

    def _photo(self, h, w, seed=7):
        # Photographic content (smooth gradients + blocky noise), not
        # white noise — quality searches on noise saturate at Q=100 and
        # prove nothing about probe parity.
        rng = np.random.default_rng(seed)
        y, x = np.mgrid[0:h, 0:w]
        base = np.stack([x * 255 / w, y * 255 / h,
                         (x + y) * 255 / (w + h)], axis=-1)
        noise = rng.normal(0, 12, (h // 8 + 1, w // 8 + 1, 3))
        noise = noise.repeat(8, axis=0).repeat(8, axis=1)[:h, :w]
        img = np.empty((h, w, 4), np.float32)
        img[..., :3] = np.clip(base + noise, 0, 255)
        img[..., 3] = 255.0
        return img

    @pytest.mark.slow
    def test_search_parity_2048px(self):
        """Spatially-sharded full quality search on a 2048x2048 photo:
        identical winner vs the unsharded program (ssim.go:47's 4K-class
        use case)."""
        from fennec_tpu.engine.compress import quality_search_device
        from fennec_tpu.parallel import quality_search_spatial_sharded

        mesh = data_spatial_mesh(8, spatial=4)  # 512 rows per shard
        img = self._photo(2048, 2048)
        q, s, f, _coefs = quality_search_spatial_sharded(mesh, img, 0.92)
        q1, s1, f1 = quality_search_device(jnp.asarray(img),
                                           jnp.float32(0.92))
        assert int(q) == int(q1)
        assert bool(f) == bool(f1)
        assert float(s) == pytest.approx(float(s1), abs=1e-5)

    @pytest.mark.slow
    def test_sharded_ssim_parity_4k(self):
        """dpxsp windowed SSIM at 4K (3840x2160): sharded vs unsharded
        scores agree to fp32 tolerance."""
        mesh = data_spatial_mesh(8, spatial=2)
        a = np.stack([self._photo(2160, 3840, seed=3),
                      self._photo(2160, 3840, seed=4)])
        b = np.clip(a + 6.0, 0, 255)
        sharded = batched_ssim_sharded(mesh, jnp.asarray(a),
                                       jnp.asarray(b), spatial=True)
        unsharded = batched_ssim(jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(sharded),
                                   np.asarray(unsharded), atol=1e-5)
