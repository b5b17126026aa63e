"""Test harness config.

Tests run on a virtual 8-device CPU mesh so sharding paths are exercised
without multi-device hardware. Tests marked `gpu` need an NVIDIA GPU and
skip elsewhere; run them on a card with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other backends)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs an NVIDIA GPU; JAX runs on "
                    f"{jax.devices()[0].platform}")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xFA57)


def width_sweep():
    """All (dtype, width) configs, mirroring the reference's exhaustive
    round-trip sweep (reference bitpacking.rs:273-315: 9+17+33+65 = 126)."""
    from fastlanes_tpu.core import layout

    return [(dt, w) for dt in layout.DTYPES for w in range(layout.bit_width(dt) + 1)]


def width_sample():
    """A cheaper representative sample: W in {0, 1, 3, T/2, T-1, T} per dtype."""
    from fastlanes_tpu.core import layout

    out = []
    for dt in layout.DTYPES:
        t = layout.bit_width(dt)
        for w in sorted({0, 1, 3, t // 2, t - 1, t}):
            out.append((dt, w))
    return out


def ref_pattern(dtype, width, n_blocks=1):
    """The reference crate's test pattern: values[i] = i % (1 << (W % T))
    (reference bitpacking.rs:281)."""
    from fastlanes_tpu.core import layout

    t = layout.bit_width(dtype)
    mod = 1 << (width % t)
    i = np.arange(n_blocks * layout.BLOCK, dtype=np.uint64)
    return (i % mod).astype(layout.np_dtype(dtype)).reshape(n_blocks, layout.BLOCK)


def random_values(rng, dtype, width, n_blocks=2):
    """Random W-bit values (plus full-range values when W == T)."""
    from fastlanes_tpu.core import layout

    t = layout.bit_width(dtype)
    hi = 1 << min(width, t)
    vals = rng.integers(0, hi, size=(n_blocks, layout.BLOCK), dtype=np.uint64)
    return vals.astype(layout.np_dtype(dtype))


@pytest.fixture(autouse=True, scope="module")
def _fresh_xla_compiler_state():
    """Drop the in-process executable caches at each module boundary: it
    keeps the compiler state a full-suite worker accumulates small (XLA's
    CPU backend has crashed compiling late in long runs)."""
    import jax

    jax.clear_caches()
    yield
