"""Go-reference golden parity.

Every other parity test in this suite asserts against float64 numpy
oracles RE-DERIVED from reading the Go source — a shared misreading
would pass.  This test instead compares against values produced by
RUNNING the actual reference (tests/golden/main.go) on byte-identical
PNG inputs (tests/golden/gen_inputs.py).

No Go toolchain exists in this build image, so tests/golden_go.json
cannot be generated here; when it is absent the test SKIPS with
generation instructions.  Committing the generator + this consumer
keeps the parity contract executable anywhere a Go toolchain exists.
"""

import json
import os

import numpy as np
import pytest

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_go.json")
INPUTS = os.path.join(os.path.dirname(__file__), "golden", "inputs")


def _load_inputs():
    from fennec_tpu.codecs.png import decode_png

    imgs = {}
    for name in os.listdir(INPUTS):
        if name.endswith(".png"):
            with open(os.path.join(INPUTS, name), "rb") as f:
                imgs[name[:-4]] = decode_png(f.read())
    return imgs


needs_golden = pytest.mark.skipif(
    not os.path.exists(GOLDEN),
    reason="tests/golden_go.json absent — generate with a Go toolchain: "
           "cd tests/golden && python gen_inputs.py && go mod init golden "
           "&& go mod edit -replace github.com/shamspias/fennec=<ref> "
           "&& go mod tidy && go run . > ../golden_go.json")


@needs_golden
class TestGoGolden:
    @pytest.fixture(scope="class")
    def golden(self):
        with open(GOLDEN) as f:
            return json.load(f)

    @pytest.fixture(scope="class")
    def inputs(self):
        return _load_inputs()

    def test_ssim(self, golden, inputs):
        import fennec_tpu as fennec

        for key, want in golden["ssim"].items():
            a, b = key.split("|")
            got = fennec.ssim(inputs[a], inputs[a] if b == "self"
                              else inputs[b])
            assert abs(got - want) < 1e-4, (key, got, want)

    def test_ssim_fast(self, golden, inputs):
        import fennec_tpu as fennec

        for key, want in golden["ssim_fast"].items():
            a, b = key.split("|")
            got = fennec.ssim_fast(inputs[a], inputs[b])
            assert abs(got - want) < 1e-4, (key, got, want)

    def test_ms_ssim(self, golden, inputs):
        import fennec_tpu as fennec

        for key, want in golden["ms_ssim"].items():
            a, b = key.split("|")
            got = fennec.ms_ssim(inputs[a], inputs[b])
            assert abs(got - want) < 1e-4, (key, got, want)

    def test_analyze(self, golden, inputs):
        import fennec_tpu as fennec

        for name, want in golden["analyze"].items():
            st = fennec.analyze(inputs[name])
            assert st.width == want["width"]
            assert st.height == want["height"]
            assert st.has_alpha == want["has_alpha"]
            assert st.is_grayscale == want["is_grayscale"]
            assert st.unique_colors == want["unique_colors"]
            assert abs(st.entropy - want["entropy"]) < 1e-3
            assert abs(st.edge_density - want["edge_density"]) < 1e-3
            assert abs(st.mean_brightness
                       - want["mean_brightness"]) < 0.5
            assert abs(st.contrast - want["contrast"]) < 0.5


def test_inputs_generator_deterministic(tmp_path):
    """gen_inputs.py output is bit-stable (the parity pack's premise)."""
    import subprocess
    import sys

    env = dict(os.environ, FENNEC_FORCE_CPU="1", JAX_PLATFORMS="cpu")
    script = os.path.join(os.path.dirname(__file__), "golden",
                          "gen_inputs.py")
    if not os.path.isdir(INPUTS):
        subprocess.run([sys.executable, script], check=True, env=env,
                       capture_output=True)
    # Regenerate into a scratch copy and compare one fixture.
    import shutil

    probe = "gradient_256x192.png"
    src = os.path.join(INPUTS, probe)
    assert os.path.exists(src)
    before = open(src, "rb").read()
    shutil.copy(src, tmp_path / probe)
    subprocess.run([sys.executable, script], check=True, env=env,
                   capture_output=True)
    after = open(src, "rb").read()
    assert before == after
