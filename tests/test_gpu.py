"""Tests that need a GPU.  They skip elsewhere; run them on a GPU host
with `FENNEC_TEST_GPU=1 python -m pytest -m gpu -n 0 tests/`."""

import pytest

import chip_smoke


@pytest.mark.gpu
def test_op_parity_on_gpu(gpu):
    """chip_smoke's op phase at full widths: SSIM, DCT, Lanczos-3 and the
    lockstep search, each against its plain reference."""
    chip_smoke.phase_ops(chip_smoke.FULL)
