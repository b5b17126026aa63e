"""NumPy-oracle conformance: exhaustive (dtype × width) round-trip sweep
(reference bitpacking.rs:273-315, 126 configs), fused-vs-unfused delta
(delta.rs:80-107), FoR semantics (ffor.rs:66-88), and golden sha256 vectors
for the README example and delta pipeline (SURVEY.md §8)."""

import hashlib

import numpy as np
import pytest

from fastlanes_tpu.core import layout
from fastlanes_tpu.ref import numpy_ref as ref

from conftest import ref_pattern, random_values, width_sweep


@pytest.mark.parametrize("dt,w", width_sweep())
def test_round_trip_sweep(dt, w, rng):
    """pack -> unpack round trip + every unpack_single index (ref test pattern)."""
    values = ref_pattern(dt, w, n_blocks=2)
    packed = ref.pack(values, w, dt)
    assert packed.shape == (2, layout.packed_len(dt, w))
    assert packed.dtype == layout.np_dtype(dt)
    out = ref.unpack(packed, w, dt)
    np.testing.assert_array_equal(out, values)

    # all 1024 indices at once (vectorized unpack_single)
    singles = ref.unpack_single(packed, w, np.arange(1024), dt)
    np.testing.assert_array_equal(singles, values)


@pytest.mark.parametrize("dt,w", width_sweep())
def test_round_trip_random(dt, w, rng):
    values = random_values(rng, dt, w, n_blocks=2)
    packed = ref.pack(values, w, dt)
    out = ref.unpack(packed, w, dt)
    np.testing.assert_array_equal(out, values)


@pytest.mark.parametrize("dt,w", width_sweep())
def test_golden_sweep_sha256(dt, w):
    """Every (dtype, width) config's packed bytes pinned as sha256, input =
    the reference crate's test pattern values[i] = i % (1 << (W % T))
    (reference bitpacking.rs:281; 9+17+33+65 = 124 configs). The pins were
    generated from the NumPy oracle — four independent implementations agree
    on them (oracle, XLA ops, C++ host codec), and
    tools/rust_goldens makes them machine-checkable against the actual Rust
    crate the moment a cargo toolchain is available."""
    import json
    import os

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_sweep_sha256.json")) as f:
        pins = json.load(f)
    t = layout.bit_width(dt)
    values = ref_pattern(dt, w, n_blocks=1)
    packed = ref.pack(values, w, dt)
    digest = hashlib.sha256(packed[0].astype(f"<u{t // 8}").tobytes()).hexdigest()
    assert digest == pins[f"{dt}_w{w}"]


def test_pack_masks_high_bits(rng):
    """Packing values wider than W keeps only the low W bits (macros.rs:74-76)."""
    w = 5
    values = rng.integers(0, 1 << 16, size=(1, 1024), dtype=np.uint64).astype(np.uint16)
    packed = ref.pack(values, w, "u16")
    out = ref.unpack(packed, w, "u16")
    np.testing.assert_array_equal(out, values & np.uint16((1 << w) - 1))


def test_golden_readme_example():
    """README example (u16, W=3, values[i] = i % 8): packed length 192,
    first-8-words cycle and sha256 from SURVEY.md §8."""
    values = (np.arange(1024) % 8).astype(np.uint16)[None]
    packed = ref.pack(values, 3, "u16")
    assert packed.shape == (1, 192)
    expect_cycle = np.array([0, 37449, 9362, 46811, 18724, 56173, 28086, 65535], dtype=np.uint16)
    np.testing.assert_array_equal(packed[0, :8], expect_cycle)
    digest = hashlib.sha256(packed[0].astype("<u2").tobytes()).hexdigest()
    assert digest == "f949547d2b920f409dc21441e8ce7d412965a9ff3eac94d551362f689372db20"
    np.testing.assert_array_equal(ref.unpack(packed, 3, "u16"), values)


def test_golden_delta_pipeline():
    """Delta pipeline (u16, W=15, values[i] = i/8, zero base), delta.rs:80-96:
    packed length 960 and sha256 from SURVEY.md §8."""
    values = (np.arange(1024) // 8).astype(np.uint16)[None]
    base = np.zeros(64, dtype=np.uint16)
    transposed = ref.transpose(values)
    deltas = ref.delta(transposed, base)
    packed = ref.pack(deltas, 15, "u16")
    assert packed.shape == (1, 960)
    digest = hashlib.sha256(packed[0].astype("<u2").tobytes()).hexdigest()
    assert digest == "5185857a43fed531c32020253fb0c165e8fd8fa423455769c8e96f181bae7848"

    # Fused kernel equals transposed input (delta.rs:97-100)
    fused = ref.undelta_pack(packed, base, 15, "u16")
    np.testing.assert_array_equal(fused, transposed)
    # Unfused kernel agrees (delta.rs:102-106)
    unfused = ref.undelta(ref.unpack(packed, 15, "u16"), base)
    np.testing.assert_array_equal(unfused, transposed)
    # Full round trip back to original order
    np.testing.assert_array_equal(ref.untranspose(fused), values)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_delta_roundtrip_random(dt, rng):
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    values = random_values(rng, dt, t, n_blocks=3)
    base = random_values(rng, dt, t, n_blocks=3)[:, :nl]
    transposed = ref.transpose(values)
    deltas = ref.delta(transposed, base, dt)
    np.testing.assert_array_equal(ref.undelta(deltas, base, dt), transposed)
    # full-width pack keeps everything
    packed = ref.pack(deltas, t, dt)
    np.testing.assert_array_equal(ref.undelta_pack(packed, base, t, dt), transposed)
    np.testing.assert_array_equal(ref.untranspose(transposed, dt), values)


def test_ffor_semantics(rng):
    """reference ffor.rs:66-88: unpack(for_pack(v, 10)) == (v - 10) mod 2^W."""
    w = 15
    values = (np.arange(1024, dtype=np.uint64) % (1 << w)).astype(np.uint16)[None]
    packed = ref.for_pack(values, 10, w, "u16")
    unpacked = ref.unpack(packed, w, "u16")
    expect = (values - np.uint16(10)) & np.uint16((1 << w) - 1)
    np.testing.assert_array_equal(unpacked, expect)
    # fused decode round-trips exactly wherever v - 10 fits in W bits
    ok = values >= 10
    restored = ref.unfor_pack(packed, 10, w, "u16")
    np.testing.assert_array_equal(restored[ok], values[ok])


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_ffor_roundtrip_all_dtypes(dt, rng):
    t = layout.bit_width(dt)
    w = t // 2
    reference = 1 << (w - 2)
    base_vals = random_values(rng, dt, w - 1, n_blocks=2)
    values = base_vals + layout.np_dtype(dt).type(reference)
    packed = ref.for_pack(values, reference, w, dt)
    np.testing.assert_array_equal(ref.unfor_pack(packed, reference, w, dt), values)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_transpose_roundtrip(dt, rng):
    values = random_values(rng, dt, layout.bit_width(dt), n_blocks=2)
    tr = ref.transpose(values, dt)
    assert not np.array_equal(tr, values)
    np.testing.assert_array_equal(ref.untranspose(tr, dt), values)
    np.testing.assert_array_equal(ref.transpose(ref.untranspose(values, dt), dt), values)


def test_unpack_single_scalar_and_batch(rng):
    values = random_values(rng, "u32", 16, n_blocks=2)
    packed = ref.pack(values, 16, "u32")
    for i in (0, 1, 17, 511, 1023):
        np.testing.assert_array_equal(ref.unpack_single(packed, 16, i, "u32"), values[:, i])
    # 1-D packed (single block) with scalar index -> scalar
    single = ref.unpack_single(packed[0], 16, 14, "u32")
    assert single == values[0, 14]
    with pytest.raises(IndexError):
        ref.unpack_single(packed, 16, 1024, "u32")


def test_shape_validation():
    with pytest.raises(ValueError):
        ref.pack(np.zeros((2, 1000), np.uint16), 3, "u16")
    with pytest.raises(ValueError):
        ref.unpack(np.zeros((2, 100), np.uint16), 3, "u16")
    with pytest.raises(ValueError):
        ref.delta(np.zeros((1, 1024), np.uint16), np.zeros(32, np.uint16))
