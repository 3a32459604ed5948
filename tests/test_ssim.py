"""SSIM family tests: metric properties (as in reference fennec_test.go:82-163)
plus float64-oracle golden parity (<1e-4, per BASELINE.md)."""

import numpy as np
import pytest

import oracles
from conftest import (
    make_noise_image,
    make_solid_image,
    make_striped_image,
    make_test_image,
)
from fennec_tpu.ops import ms_ssim, pixel_ssim, ssim, ssim_fast

PARITY_TOL = 1e-4


def perturb(img, amount=12, seed=3):
    rng = np.random.default_rng(seed)
    noise = rng.integers(-amount, amount + 1, size=img.shape[:2] + (3,))
    out = img.copy()
    out[..., :3] = np.clip(img[..., :3].astype(int) + noise, 0, 255)
    return out.astype(np.uint8)


class TestSSIMProperties:
    def test_identical_is_one(self):
        img = make_test_image(64, 64)
        assert ssim(img, img) == pytest.approx(1.0, abs=1e-4)

    def test_black_vs_white_low(self):
        black = make_solid_image(32, 32, 0, 0, 0)
        white = make_solid_image(32, 32, 255, 255, 255)
        assert ssim(black, white) < 0.1

    def test_perturbed_in_range(self):
        img = make_test_image(96, 96)
        s = ssim(img, perturb(img))
        assert 0.5 <= s < 0.9999

    def test_symmetric(self):
        a = make_test_image(48, 48)
        b = perturb(a)
        assert ssim(a, b) == pytest.approx(ssim(b, a), abs=1e-5)

    def test_size_mismatch_resizes(self):
        a = make_test_image(64, 64)
        b = make_test_image(32, 32)
        s = ssim(a, b)
        assert 0.0 < s <= 1.0

    def test_tiny_image_pixel_path(self):
        a = make_solid_image(4, 4, 100, 100, 100)
        b = make_solid_image(4, 4, 100, 100, 100)
        assert ssim(a, b) == pytest.approx(1.0, abs=1e-6)

    def test_more_noise_lower_ssim(self):
        img = make_test_image(96, 96)
        s_small = ssim(img, perturb(img, amount=5))
        s_big = ssim(img, perturb(img, amount=40))
        assert s_big < s_small


class TestSSIMParity:
    """Device f32 vs float64 oracle — the BASELINE parity bound."""

    @pytest.mark.parametrize("shape", [(40, 40), (64, 48), (120, 90),
                                       (9, 9), (33, 17)])
    def test_windowed_parity_random(self, shape):
        h, w = shape
        a = make_noise_image(w, h, seed=1)
        b = perturb(a, amount=20, seed=2)
        got = ssim(a, b)
        want = oracles.windowed_ssim(oracles.luminance(a),
                                     oracles.luminance(b))
        assert got == pytest.approx(want, abs=PARITY_TOL)

    def test_windowed_parity_gradient(self):
        a = make_test_image(100, 80)
        b = perturb(a, amount=10)
        got = ssim(a, b)
        want = oracles.windowed_ssim(oracles.luminance(a),
                                     oracles.luminance(b))
        assert got == pytest.approx(want, abs=PARITY_TOL)

    def test_pixel_ssim_parity(self):
        a = make_noise_image(6, 5, seed=7)
        b = make_noise_image(6, 5, seed=8)
        assert pixel_ssim(a, b) == pytest.approx(
            oracles.pixel_ssim(a, b), abs=PARITY_TOL)

    def test_ssim_fast_parity_with_downsample(self):
        a = make_noise_image(700, 500, seed=4)
        b = perturb(a, amount=15, seed=5)
        got = ssim_fast(a, b)
        want = oracles.ssim_fast(a, b)
        assert got == pytest.approx(want, abs=PARITY_TOL)

    def test_ssim_fast_no_downsample_matches_ssim(self):
        a = make_test_image(128, 128)
        b = perturb(a)
        assert ssim_fast(a, b) == pytest.approx(ssim(a, b), abs=1e-6)


class TestSSIMFast:
    def test_identical(self):
        img = make_test_image(600, 600)
        assert ssim_fast(img, img) == pytest.approx(1.0, abs=1e-4)

    def test_large_image_downsampled_close_to_full(self):
        img = make_test_image(800, 600)
        b = perturb(img, amount=8)
        fast = ssim_fast(img, b)
        assert 0.3 < fast <= 1.0

    def test_extreme_aspect_floors_at_8px(self):
        # 2000x30 downsamples to (512, 8): the reference's window set is
        # empty → SSIM 1.0 (ssim.go:162-164).  Regression: this routed
        # into the windowed path and produced NaN.
        img = make_test_image(2000, 30)
        b = perturb(img, amount=10)
        v = ssim_fast(img, b)
        assert v == pytest.approx(1.0)

        from fennec_tpu.parallel.batched import batched_ssim_fast
        import numpy as np

        vs = batched_ssim_fast(np.stack([img, b]), np.stack([b, img]))
        assert np.allclose(vs, 1.0)


class TestMSSSIM:
    def test_identical_is_one(self):
        img = make_test_image(128, 128)
        assert ms_ssim(img, img) == pytest.approx(1.0, abs=1e-3)

    def test_black_vs_white_low(self):
        black = make_solid_image(64, 64, 0, 0, 0)
        white = make_solid_image(64, 64, 255, 255, 255)
        assert ms_ssim(black, white) < 0.1

    def test_perturbed_in_range(self):
        img = make_striped_image(128, 128)
        s = ms_ssim(img, perturb(img))
        assert 0.3 < s < 0.9999

    def test_small_image_weight_renormalization(self):
        # 32px: only ~3 scales survive before dims drop below 8.
        img = make_test_image(32, 32)
        s = ms_ssim(img, perturb(img, amount=6))
        assert 0.0 < s <= 1.0


class TestBoxDownsampleParity:
    @pytest.mark.parametrize("src,dst", [
        ((100, 80), (50, 40)),
        ((101, 83), (37, 29)),
        ((640, 480), (512, 384)),
    ])
    def test_parity(self, src, dst):
        from fennec_tpu.ops.resize import box_downsample
        (sw, sh), (dw, dh) = src, dst
        img = make_noise_image(sw, sh, seed=11)
        got = box_downsample(img, dw, dh)
        want = oracles.box_downsample(img, dw, dh)
        # f32 matmul vs f64 loop: allow off-by-one on rounding boundaries.
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01


class TestMSSSIMParity:
    @pytest.mark.parametrize("shape", [(64, 64), (96, 72), (33, 47)])
    def test_oracle_parity(self, shape):
        w, h = shape
        a = make_noise_image(w, h, seed=21)
        b = perturb(a, amount=18, seed=22)
        got = ms_ssim(a, b)
        want = oracles.ms_ssim(a, b)
        assert got == pytest.approx(want, abs=2e-4)

    def test_oracle_parity_gradient(self):
        a = make_test_image(120, 90)
        b = perturb(a, amount=8, seed=30)
        assert ms_ssim(a, b) == pytest.approx(oracles.ms_ssim(a, b),
                                              abs=2e-4)


def test_ms_ssim_empty_image_contract():
    """Zero-area inputs return 1.0 like ssim()/pixel_ssim(), not NaN."""
    from fennec_tpu.ops.ssim import ms_ssim

    z = np.zeros((0, 0, 4), dtype=np.uint8)
    assert ms_ssim(z, z) == 1.0


def test_lanczos_resize_jax_input_normalized():
    """jax.Array inputs take the same uint8 normalization as numpy:
    [0,1] floats scale to 0..255 and values round, not truncate."""
    import jax.numpy as jnp
    from fennec_tpu.ops.resize import lanczos_resize

    a01 = np.full((16, 16, 4), 0.8, dtype=np.float32)
    a01[..., 3] = 1.0
    out_np = lanczos_resize(a01, 8, 8)
    out_jax = lanczos_resize(jnp.asarray(a01), 8, 8)
    np.testing.assert_array_equal(out_np, out_jax)
    assert out_jax[..., 0].max() > 0  # not all-black


class TestWindowedSSIMOracle:
    """The windowed scorer the quality search uses, against the float64
    oracle on noise pairs, at odd and even shapes."""

    @pytest.mark.parametrize("shape", [(32, 32), (64, 48), (130, 100)])
    def test_matches_oracle(self, shape):
        from fennec_tpu.ops.color import luminance_device
        from fennec_tpu.ops.ssim import windowed_ssim_device

        h, w = shape
        for i in range(3):
            a = make_noise_image(w, h, seed=i)
            b = np.clip(a.astype(int) + (i + 1) * 5, 0, 255).astype(np.uint8)
            got = float(windowed_ssim_device(
                luminance_device(np.asarray(a, np.float32)),
                luminance_device(np.asarray(b, np.float32))))
            want = oracles.windowed_ssim(oracles.luminance(a),
                                         oracles.luminance(b))
            assert got == pytest.approx(want, abs=PARITY_TOL)

    def test_identical_is_one(self):
        from fennec_tpu.ops.color import luminance_device
        from fennec_tpu.ops.ssim import windowed_ssim_device

        lum = luminance_device(np.asarray(make_test_image(40, 40),
                                          np.float32))
        assert float(windowed_ssim_device(lum, lum)) == pytest.approx(
            1.0, abs=1e-5)
