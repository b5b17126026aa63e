"""Process set-up shared by the entry points: the device peak table, the
compile-cache placement, the GPU check, and chip_smoke.py's refusal to
report from anything but a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from fastlanes_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                       ("NVIDIA H100 PCIe", 2.0e12)])
def test_peak_of_known_kind(kind, peak):
    assert runtime.peak_hbm_bytes_per_s(kind) == peak


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_peak_of_unknown_kind_raises(kind):
    with pytest.raises(ValueError, match="no peak bandwidth"):
        runtime.peak_hbm_bytes_per_s(kind)


def test_checkout_is_repo_root():
    assert os.path.samefile(runtime.CHECKOUT, REPO)


@pytest.fixture
def cache_config():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_in_checkout_when_env_unset(monkeypatch, tmp_path,
                                                  cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.configure_compile_cache(str(tmp_path))
    assert path == os.path.join(str(tmp_path), ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    # a fixed path: the same root gives the same directory every time
    assert runtime.configure_compile_cache(str(tmp_path)) == path


def test_compile_cache_env_is_left_to_jax(monkeypatch, tmp_path,
                                          cache_config):
    env_dir = str(tmp_path / "from_env")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache(str(tmp_path)) == env_dir
    assert jax.config.jax_compilation_cache_dir == before


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        runtime.require_gpu(jax.devices("cpu"))
    with pytest.raises(RuntimeError):
        runtime.require_gpu([])


def _run_smoke(cwd):
    # chip_smoke.py asks for the cuda backend itself; hiding every card
    # makes it find none on any host
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    """Without a GPU the smoke test fails before any phase and prints no
    result line."""
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.gpu
def test_running_gpu_has_a_peak():
    """The card the suite runs on is in the peak table."""
    runtime.require_gpu(jax.devices())
    assert runtime.peak_hbm_bytes_per_s(jax.devices()[0].device_kind) > 0
