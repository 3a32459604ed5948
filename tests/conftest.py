"""Test configuration: force the CPU backend with 8 virtual devices.

Multi-chip sharding paths are tested against a fake 8-device CPU mesh
(the standard JAX pattern for testing pjit/shard_map without hardware).
The program itself runs on the GPU: `python chip_smoke.py` drives it
there, and tests marked `gpu` skip unless a GPU is present.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_cpu_parallel_codegen_split_count" not in flags:
    # The XLA:CPU thunk runtime's parallel LLVM codegen segfaults
    # deterministically under this suite's compile volume (crashes inside
    # backend_compile_and_load / _cache_write / _cache_read once enough
    # large programs compiled in-process); serial codegen is stable.
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags
# FENNEC_TEST_GPU=1 leaves JAX on its default platform, for the tests
# marked `gpu` (`FENNEC_TEST_GPU=1 python -m pytest -m gpu -n 0 tests/`).
ON_GPU = bool(os.environ.get("FENNEC_TEST_GPU"))
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"

import pathlib
import sys

import jax

# Set the platform through the config as well as the environment, so
# that a JAX already initialised by an earlier import in the process
# still gives the suite the CPU backend.
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# Persistent compile cache: the suite is compile-dominated (hundreds of
# shape-specialized programs), and very large in-process LLVM JIT volume
# has been observed to segfault XLA CPU in long custom test orderings —
# cached executables sidestep both.  It follows JAX_COMPILATION_CACHE_DIR
# where that is set, and is <repo>/.jax_cache/ otherwise
# (fennec_tpu.utils.compile_cache).  FENNEC_TEST_NO_CACHE=1 disables it.
#
# STALE-CACHE HAZARD: entries AOT-compiled under a different
# XLA_FLAGS/target-feature set load with "cpu_aot_loader ... machine
# feature ... not supported" errors and can ABORT the process
# mid-execution.  If the suite starts crashing workers while those
# loader errors appear, delete the cache directory.
if not os.environ.get("FENNEC_TEST_NO_CACHE"):
    from fennec_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=0.5)

import numpy as np
import pytest


# ── Shared image generators (mirroring reference fennec_test.go:20-76) ──────


def make_test_image(w: int, h: int) -> np.ndarray:
    """RGB gradient test image (reference fennec_test.go:20-32)."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = (x * 255 // max(w, 1)).astype(np.uint8)
    img[..., 1] = (y * 255 // max(h, 1)).astype(np.uint8)
    img[..., 2] = ((x + y) * 255 // max(w + h, 1)).astype(np.uint8)
    img[..., 3] = 255
    return img


def make_test_image_with_alpha(w: int, h: int) -> np.ndarray:
    img = make_test_image(w, h)
    y, x = np.mgrid[0:h, 0:w]
    img[..., 3] = ((x + y) * 255 // max(w + h, 1)).astype(np.uint8)
    return img


def make_solid_image(w: int, h: int, r: int, g: int, b: int) -> np.ndarray:
    img = np.zeros((h, w, 4), dtype=np.uint8)
    img[..., 0] = r
    img[..., 1] = g
    img[..., 2] = b
    img[..., 3] = 255
    return img


def make_striped_image(w: int, h: int) -> np.ndarray:
    """Vertical stripes — sharp edges (reference fennec_test.go:58-76)."""
    img = np.zeros((h, w, 4), dtype=np.uint8)
    x = np.arange(w)
    stripe = ((x // 8) % 2 == 0)
    img[:, stripe, :3] = 230
    img[:, ~stripe, :3] = 25
    img[..., 3] = 255
    return img


def make_noise_image(w: int, h: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    img[..., 3] = 255
    return img


@pytest.fixture
def gradient_image():
    return make_test_image(64, 48)


@pytest.fixture
def gpu():
    """The GPU device for tests marked `gpu`; skips without one."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: FENNEC_TEST_GPU=1 python -m pytest "
                    "-m gpu -n 0 tests/")
    return jax.devices()[0]


# ── Fast lane (-m "not slow") ───────────────────────────────────────────
# The measured-slowest tests (full-suite --durations run, round 5; all
# >40 s on the 1-core host) are centrally marked slow here so
# `pytest -m "not slow"` gives a <6-minute regression lane without
# touching every file.  Some files also carry explicit @pytest.mark.slow
# decorations; both routes compose.
_SLOW_TESTS = {
    "test_sharded_ssim_parity_4k",                  # 698s
    "test_large_photo_targetsize",                  # 194s
    "test_small_width_matches_default_on_normal_content",  # 179s
    "test_scale_divergence_lockstep",               # 167s
    "test_matches_real_histograms",                 # 133s
    "test_examples_run_clean",                      # 128s
    "test_end_to_end_files",                        # 124s
    "test_matches_per_image_auto",                  # 113s
    "test_solid_image_emission",                    # 113s
    "test_search_parity_2048px",                    # 101s
    "test_ssim_fast_parity_with_downsample",        # 95s
    "test_coef_path_byte_identical",                # 93s
    "test_device_emission_matches_host_encoder",    # 92s × several
    "test_matches_per_image_jpeg",                  # 92s
    "test_under_target_when_achievable",            # 74s
    "test_matches_scan_bits",                       # 69s
    "test_mixed_alpha_routing",                     # 65s
    "test_resize_then_target",                      # 62s
    "test_all_coefficients_maximal",                # 55s
    "test_exact_bits_modulo_stuffing",              # 51s
    "test_target_size",                             # 50s (CLI e2e)
    "test_quality_flag",                            # 50s (CLI e2e)
    "test_identical_to_unsharded",                  # 48s
    "test_routing_and_contracts",                   # 48s
    "test_impossible_target_fallback",              # 47s
    "test_fibonacci_long_codes",                    # 46s
    "test_inputs_generator_deterministic",          # 44s
    "test_random_sparse",                           # 42s
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        base = item.name.split("[")[0]
        if base in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
