"""Production batch engines on a multi-device mesh.

When more than one device is present, compress_batch /
compress_images_batched shard every chunk's batch axis over a
Mesh('data') — the multi-device analogue of the reference's CompressBatch
goroutine pool saturating all cores (batch.go:58-128).  FENNEC_MESH=1
forces the mesh path on the suite's 8-virtual-device CPU backend;
results must be BYTE-identical to the single-device dispatch path.
"""

import os

import numpy as np
import pytest

import fennec_tpu as fennec
from conftest import make_noise_image, make_test_image
from fennec_tpu.codecs.jpeg import encode_jpeg
from fennec_tpu.engine.batched import (
    compress_images_batched,
    compress_jpeg_bytes_batched,
)
from fennec_tpu.parallel.batched import data_mesh


@pytest.fixture
def mesh_env(monkeypatch):
    monkeypatch.setenv("FENNEC_MESH", "1")


def _photo_images(n, w=80, h=96):
    rng = np.random.default_rng(7)
    imgs = []
    for _ in range(n):
        im = np.clip(rng.normal(128, 40, (h, w, 4)), 0, 255).astype(
            np.uint8)
        im[..., 3] = 255
        imgs.append(im)
    return imgs


class TestDataMesh:
    def test_disabled_by_default_on_cpu(self):
        # CPU multi-device backends need the explicit opt-in.
        os.environ.pop("FENNEC_MESH", None)
        assert data_mesh() is None

    def test_forced_on(self, mesh_env):
        mesh = data_mesh()
        assert mesh is not None and mesh.size == 8
        assert mesh.axis_names == ("data",)

    def test_disable_flag_wins(self, monkeypatch):
        monkeypatch.setenv("FENNEC_MESH", "0")
        assert data_mesh() is None


class TestPixelPathMesh:
    @pytest.mark.parametrize("device_entropy", [True, False])
    def test_identical_to_unsharded(self, monkeypatch, device_entropy):
        imgs = _photo_images(10)
        opts = fennec.Options(format=fennec.Format.JPEG,
                              device_entropy=device_entropy)
        monkeypatch.setenv("FENNEC_MESH", "0")
        base = compress_images_batched(None, imgs, opts)
        monkeypatch.setenv("FENNEC_MESH", "1")
        sharded = compress_images_batched(None, imgs, opts)
        for a, b in zip(base, sharded):
            assert a.compressed_data == b.compressed_data
            assert a.jpeg_quality == b.jpeg_quality

    def test_tail_smaller_than_mesh(self, mesh_env):
        # 3 images < 8 devices: the chunk pads up to one image/shard.
        imgs = _photo_images(3)
        opts = fennec.Options(format=fennec.Format.JPEG)
        rs = compress_images_batched(None, imgs, opts)
        assert all(r.compressed_size > 0 for r in rs)


class TestCoefPathMesh:
    """The coefficient fast path (compress_batch's JPEG→JPEG route)
    under the mesh: every upload format × emission kind."""

    @pytest.mark.parametrize("device_entropy,optimize", [
        (True, True),    # "opt": two-stage device emission
        (True, False),   # "emit": standard-table device emission
        (False, True),   # "quant": host Huffman
    ])
    def test_smooth_coo_identical(self, monkeypatch, device_entropy,
                                  optimize):
        datas = [encode_jpeg(make_test_image(80, 96), q)
                 for q in (88, 92, 95) for _ in range(3)]
        opts = fennec.Options(format=fennec.Format.JPEG,
                              device_entropy=device_entropy,
                              optimize_huffman=optimize)
        monkeypatch.setenv("FENNEC_MESH", "0")
        base = compress_jpeg_bytes_batched(None, datas, opts)
        monkeypatch.setenv("FENNEC_MESH", "1")
        sharded = compress_jpeg_bytes_batched(None, datas, opts)
        for a, b in zip(base, sharded):
            assert a.compressed_data == b.compressed_data

    def test_noise_dense_identical(self, monkeypatch):
        # Noisy content routes the dense i8 upload format; its
        # exception lists exercise the per-shard index rebasing.
        datas = [encode_jpeg(make_noise_image(80, 96, seed=i), 90)
                 for i in range(9)]
        opts = fennec.Options(format=fennec.Format.JPEG,
                              device_entropy=True)
        monkeypatch.setenv("FENNEC_MESH", "0")
        base = compress_jpeg_bytes_batched(None, datas, opts)
        monkeypatch.setenv("FENNEC_MESH", "1")
        sharded = compress_jpeg_bytes_batched(None, datas, opts)
        for a, b in zip(base, sharded):
            assert a.compressed_data == b.compressed_data

    @pytest.mark.parametrize("device_entropy", [True, False])
    def test_distinct_photos_identical(self, monkeypatch, device_entropy):
        # Distinct photographic inputs: every image carries its own
        # |v| > 127 exception rows, which each shard must keep to its
        # own images (rows of earlier shards arrive with negative
        # rebased indices and must be dropped, not wrapped).
        from bench import photo_batch

        imgs = photo_batch(8, 48, 48, seed=5).astype(np.uint8)
        datas = [encode_jpeg(im, 92) for im in imgs]
        opts = fennec.Options(format=fennec.Format.JPEG,
                              device_entropy=device_entropy)
        monkeypatch.setenv("FENNEC_MESH", "0")
        base = compress_jpeg_bytes_batched(None, datas, opts)
        monkeypatch.setenv("FENNEC_MESH", "1")
        sharded = compress_jpeg_bytes_batched(None, datas, opts)
        for a, b in zip(base, sharded):
            assert a.compressed_data == b.compressed_data

    def test_compress_batch_entry(self, mesh_env, tmp_path):
        # The real production entry point end to end: files in,
        # files out, over the mesh.
        srcs = []
        for i in range(5):
            p = tmp_path / f"in{i}.jpg"
            p.write_bytes(encode_jpeg(make_test_image(80, 96), 92))
            srcs.append(str(p))
        items = [fennec.BatchItem(src=s,
                                  dst=str(tmp_path / f"out{i}.jpg"))
                 for i, s in enumerate(srcs)]
        bopts = fennec.BatchOptions(
            fused=True,
            default_opts=fennec.Options(format=fennec.Format.JPEG))
        res = fennec.compress_batch(None, items, bopts)
        assert all(r.err is None for r in res)
        assert all((tmp_path / f"out{i}.jpg").stat().st_size > 0
                   for i in range(5))
