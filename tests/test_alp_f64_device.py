"""Conformance of the x64-free f64 ALP device decode.

The wire spec's decode is ONE correctly rounded IEEE f64 division
v = i / 10^(e-f) (alp.py module docstring); the device emulates that single
rounding in the uint32 limb domain (_div_pow10_f64_limbs). These tests pin
the emulation bit-exactly against numpy's IEEE division over random,
adversarial (near-halfway), and structural corner cases — on the CPU
backend, which runs the same uint32 op sequence as any accelerator.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastlanes_tpu import alp


def _limbs(i64: np.ndarray):
    b = np.ascontiguousarray(i64.astype(np.int64)).view(np.uint32).reshape(-1, 2)
    return jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1])


def _run_div(i64: np.ndarray, d: int) -> np.ndarray:
    lo, hi = _limbs(i64)
    olo, ohi = jax.jit(alp._div_pow10_f64_limbs, static_argnums=2)(lo, hi, d)
    bits = (np.asarray(ohi, np.uint64) << np.uint64(32)) | np.asarray(olo, np.uint64)
    return bits.view(np.float64)


def _expect(i64: np.ndarray, d: int) -> np.ndarray:
    return (i64.astype(np.float64) / np.float64(10.0 ** d)).astype(np.float64)


@pytest.mark.parametrize("d", list(range(19)))
def test_div_pow10_f64_random(d, rng):
    n = 20000
    mag = rng.integers(0, 53, n)
    i = (rng.integers(0, 1 << 62, n, dtype=np.int64) >> (62 - mag)).astype(np.int64)
    i = np.clip(i, 0, 2 ** 52)
    sign = rng.integers(0, 2, n, dtype=np.int64) * 2 - 1
    i = i * sign
    got = _run_div(i, d)
    want = _expect(i, d)
    bad = got.view(np.uint64) != want.view(np.uint64)
    assert not bad.any(), (
        f"d={d}: {bad.sum()} mismatches, first i={i[bad][0]} "
        f"got={got[bad][0]!r} want={want[bad][0]!r}")


@pytest.mark.parametrize("d", [0, 1, 2, 5, 9, 13, 18])
def test_div_pow10_f64_adversarial(d, rng):
    """Near-halfway quotients: i built so i/5^d sits close to a rounding
    boundary — i = round(m * 5^d / 2^k) +- {0,1,2} for random 53-bit m."""
    F = 5 ** d
    n = 4000
    m = rng.integers(1 << 52, 1 << 53, n, dtype=np.int64)
    k = int(F).bit_length()
    cand = (np.asarray([(int(mm) * F) >> (k + 1) for mm in m], dtype=np.int64))
    out = []
    for delta in (-2, -1, 0, 1, 2):
        out.append(np.clip(cand + delta, -(2 ** 52), 2 ** 52))
    i = np.unique(np.concatenate(out))
    got = _run_div(i, d)
    want = _expect(i, d)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))


def test_div_pow10_f64_corners():
    cases = []
    for d in range(19):
        F = 10 ** d
        cases += [(0, d), (1, d), (-1, d), (2 ** 52, d), (-(2 ** 52), d)]
        if F <= 2 ** 52:
            cases += [(F, d), (F - 1, d), (F + 1, d), (-F, d)]
        cases += [(5 ** d if 5 ** d <= 2 ** 52 else 2 ** 52, d)]
        cases += [(3, d), (7, d), (10 ** min(d, 15) * 3 % (2 ** 52), d)]
    for i_val, d in cases:
        i = np.array([i_val], np.int64)
        got = _run_div(i, d)
        want = _expect(i, d)
        assert got.view(np.uint64)[0] == want.view(np.uint64)[0], (
            f"i={i_val} d={d}: got {got[0]!r} want {want[0]!r}")


def test_decode_device_f64_limb_image_matches_np(rng):
    """decode_device on the (..., 2) limb image (x64 OFF — the x64-free form)
    reproduces decode_np bit-exactly, exceptions included."""
    n = 8192
    ints = rng.integers(-(1 << 40), 1 << 40, n, dtype=np.int64)
    refv = int(ints.min())
    shifted = (ints - refv).astype(np.uint64)
    e, f = 7, 2
    exc_pos = np.sort(rng.choice(n, 37, replace=False)).astype(np.uint32)
    exc_val = rng.normal(size=37).astype(np.float64)
    want = alp.decode_np(shifted, e, f, refv, np.float64, exc_pos, exc_val)
    limbs = shifted.view(np.uint32).reshape(n, 2)
    got = np.asarray(alp.decode_device(jnp.asarray(limbs), e, f, refv,
                                       np.float64, exc_pos, exc_val))
    assert got.dtype == np.uint32 and got.shape == (n, 2)
    got_f = got.copy().view(np.uint64).reshape(n).view(np.float64)
    assert np.array_equal(got_f.view(np.uint64), want.view(np.uint64))


def test_f64_file_device_decode_x64_free(tmp_path, rng):
    """End-to-end: f64 ALP column written by fio, decoded on device with
    x64 OFF -> exact f64 bit image."""
    from fastlanes_tpu import fio, fio_device

    assert not jax.config.read("jax_enable_x64")
    vals = (rng.integers(-10 ** 6, 10 ** 6, 4096) / 100.0).astype(np.float64)
    vals[7] = np.nan
    vals[100] = np.inf
    vals[200] = -0.0
    path = str(tmp_path / "col64.flt")
    fio.write_file(path, vals)
    hdr = fio.read_header(path)
    assert hdr["chunks"][0]["codec"] in ("alp", "alprd")
    got = np.asarray(fio_device.read_file_device(path))
    assert got.dtype == np.uint32 and got.shape == (vals.size, 2)
    got_f = got.copy().view(np.uint64).reshape(-1).view(np.float64)
    assert np.array_equal(got_f.view(np.uint64), vals.view(np.uint64))
