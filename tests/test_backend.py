"""Platform choices (fennec_tpu.backend), the compile cache's directory,
and chip_smoke.py refusing to run without a GPU."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from fennec_tpu import backend
from fennec_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parent.parent


class _Dev:
    def __init__(self, platform, stats=None):
        self.platform = platform
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.fixture
def fake_platform(monkeypatch):
    """Pretend JAX runs on `platform` with `n` devices."""
    def set_platform(platform, n=1, stats=None):
        devs = [_Dev(platform, stats) for _ in range(n)]
        monkeypatch.setattr(backend.jax, "default_backend",
                            lambda: platform)
        monkeypatch.setattr(backend.jax, "devices", lambda *a: devs)
        monkeypatch.delenv("FENNEC_MESH", raising=False)
        backend.emit_onehot_cap.cache_clear()
        return devs

    yield set_platform
    backend.emit_onehot_cap.cache_clear()


class TestPlatformChoices:
    def test_gpu(self, fake_platform):
        fake_platform("gpu", stats={"bytes_limit": 60 << 30})
        assert backend.device_entropy_default() is True
        assert backend.data_mesh_devices() is None  # one device
        assert backend.emit_onehot_cap() == (60 << 30) // 8

    def test_multi_gpu(self, fake_platform, monkeypatch):
        devs = fake_platform("gpu", n=4)
        assert backend.data_mesh_devices() == devs
        monkeypatch.setenv("FENNEC_MESH", "0")
        assert backend.data_mesh_devices() is None

    def test_cpu(self, fake_platform, monkeypatch):
        devs = fake_platform("cpu", n=8)
        assert backend.device_entropy_default() is False
        # Virtual CPU devices shard only when asked.
        assert backend.data_mesh_devices() is None
        monkeypatch.setenv("FENNEC_MESH", "1")
        assert backend.data_mesh_devices() == devs
        # No memory limit reported: the fixed 4 GiB cap.
        assert backend.emit_onehot_cap() == 1 << 31


def _cache_dir_in_fresh_process(env_dir):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import jax\n"
            "from fennec_tpu.utils.compile_cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.split()


class TestCompileCache:
    def test_follows_env(self, tmp_path):
        want = str(tmp_path / "cache")
        assert _cache_dir_in_fresh_process(want) == [want, want]

    def test_fixed_in_checkout_path(self):
        want = str(REPO / ".jax_cache")
        assert compile_cache.CACHE_DIR == want
        assert _cache_dir_in_fresh_process(None) == [want, want]


class TestChipSmokeRefuses:
    def _run(self, script, cwd):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        return subprocess.run([sys.executable, str(script)], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=300)

    def test_without_gpu(self):
        r = self._run(REPO / "chip_smoke.py", REPO)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
        assert "needs a GPU" in r.stderr

    def test_without_the_repo(self, tmp_path):
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        r = self._run(tmp_path / "chip_smoke.py", tmp_path)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
