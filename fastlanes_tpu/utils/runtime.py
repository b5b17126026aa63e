"""Process set-up shared by the entry points: the GPU check, the compile
cache and the device peak table that rates are divided by."""

from __future__ import annotations

import os

#: the checkout that holds this package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: device memory bandwidth in bytes/s by `device_kind` (NVIDIA's H100 data
#: sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s)
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_hbm_bytes_per_s(device_kind: str) -> float:
    """Published memory bandwidth of `device_kind`; an unknown kind raises
    (a rate is never divided by a guessed peak)."""
    try:
        return PEAK_HBM_BYTES_PER_S[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak bandwidth recorded for device kind {device_kind!r}; "
            f"known: {sorted(PEAK_HBM_BYTES_PER_S)}") from None


def configure_compile_cache(root: str = CHECKOUT) -> str:
    """Keep JAX's persistent compile cache at `<root>/.jax_cache`, unless
    JAX_COMPILATION_CACHE_DIR is set: JAX reads that variable itself and
    no other directory is set here. Returns the directory in use."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(devices) -> None:
    """Refuse to measure anywhere but on an NVIDIA GPU."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "no device"
        raise RuntimeError(f"needs an NVIDIA GPU; JAX found {found!r}")
