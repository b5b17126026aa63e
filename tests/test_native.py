"""C++ host codec conformance vs the NumPy oracle (independent implementations
must agree bit-for-bit across the full sweep)."""

import numpy as np
import pytest

from fastlanes_tpu import native
from fastlanes_tpu.core import layout
from fastlanes_tpu.ref import numpy_ref as ref

from conftest import random_values, width_sample, width_sweep

pytestmark = pytest.mark.skipif(not native.available(), reason="g++ build failed")


@pytest.mark.parametrize("dt,w", width_sweep())
def test_native_pack_unpack_sweep(dt, w, rng):
    values = random_values(rng, dt, w, n_blocks=3)
    gold = ref.pack(values, w, dt)
    got = native.pack(values, w, dt)
    np.testing.assert_array_equal(got, gold)
    out = native.unpack(gold, w, dt)
    np.testing.assert_array_equal(out, values)


@pytest.mark.parametrize("dt,w", width_sample())
def test_native_unpack_single(dt, w, rng):
    values = random_values(rng, dt, w, n_blocks=2)
    packed = native.pack(values, w, dt)
    idx = np.array([0, 5, 99, 1023])
    got = native.unpack_single(packed, w, idx, dt)
    np.testing.assert_array_equal(got, values[:, idx])


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_native_delta_and_fused(dt, rng):
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    values = np.sort(random_values(rng, dt, t, n_blocks=2), axis=1)
    base = random_values(rng, dt, t, n_blocks=2)[:, :nl]
    transposed = ref.transpose(values, dt)

    got_t = native.transpose(values, dt)
    np.testing.assert_array_equal(got_t, transposed)
    np.testing.assert_array_equal(native.untranspose(got_t, dt), values)

    deltas = native.delta(transposed, base, dt)
    np.testing.assert_array_equal(deltas, ref.delta(transposed, base, dt))
    np.testing.assert_array_equal(native.undelta(deltas, base, dt), transposed)

    for w in (t // 2, t):
        gold_packed = ref.pack(ref.delta(transposed, base, dt), w, dt)
        got_packed = native.delta_pack(transposed, base, w, dt)
        np.testing.assert_array_equal(got_packed, gold_packed)
        gold_dec = ref.undelta_pack(gold_packed, base, w, dt)
        np.testing.assert_array_equal(native.undelta_pack(got_packed, base, w, dt), gold_dec)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_native_ffor(dt, rng):
    t = layout.bit_width(dt)
    w = max(1, t // 2)
    values = random_values(rng, dt, t, n_blocks=2)
    reference = int(rng.integers(0, 1 << min(t - 1, 63)))
    gold = ref.for_pack(values, reference, w, dt)
    np.testing.assert_array_equal(native.for_pack(values, reference, w, dt), gold)
    np.testing.assert_array_equal(native.unfor_pack(gold, reference, w, dt),
                                  ref.unfor_pack(gold, reference, w, dt))


def test_native_golden_readme():
    values = (np.arange(1024) % 8).astype(np.uint16)[None]
    packed = native.pack(values, 3, "u16")
    import hashlib

    digest = hashlib.sha256(packed[0].astype("<u2").tobytes()).hexdigest()
    assert digest == "f949547d2b920f409dc21441e8ce7d412965a9ff3eac94d551362f689372db20"


def test_native_bad_width():
    with pytest.raises(ValueError):
        native.pack(np.zeros((1, 1024), np.uint8), 9, "u8")


def test_native_out_buffers(rng):
    """Preallocated out= buffers (IO pipelines reuse them; a fresh np.empty
    per call page-faults its extent) round-trip bit-exact and validate."""
    from fastlanes_tpu import native

    if not native.available():
        pytest.skip("native codec unavailable")
    vals = rng.integers(0, 8, (16, 1024), np.int64).astype(np.uint32)
    pbuf = np.empty((16, layout.packed_len("u32", 3)), np.uint32)
    obuf = np.empty((16, 1024), np.uint32)
    p = native.pack(vals, 3, "u32", out=pbuf)
    assert p is pbuf
    o = native.unpack(pbuf, 3, "u32", out=obuf)
    assert o is obuf
    np.testing.assert_array_equal(obuf, vals)
    with pytest.raises(ValueError, match="C-contiguous"):
        native.unpack(pbuf, 3, "u32", out=np.empty((16, 1024), np.uint16))


@pytest.mark.parametrize("dt,w", width_sweep())
def test_native_golden_pins(dt, w):
    """Explicit pin linkage: the C++ host codec's packed
    bytes for the reference test pattern match tests/golden_sweep_sha256.json
    DIRECTLY — not just transitively through the oracle. Together with
    test_numpy_ref.test_golden_sweep_sha256 (oracle) and the ops sweep
    tests this closes the three-way independent-implementation triangle on
    every one of the 124 pinned configs (reference bitpacking.rs:273-315)."""
    import hashlib
    import json
    import os

    from conftest import ref_pattern

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_sweep_sha256.json")) as f:
        pins = json.load(f)
    t = layout.bit_width(dt)
    values = ref_pattern(dt, w, n_blocks=1)
    packed = native.pack(values, w, dt)
    digest = hashlib.sha256(
        packed[0].astype(f"<u{t // 8}").tobytes()).hexdigest()
    assert digest == pins[f"{dt}_w{w}"]


def test_native_nt_threshold_paths(rng):
    """The non-temporal streaming-store decode (>= 512 blocks, 64B-aligned
    output) must be byte-identical to the classic path across codecs."""
    n = 600  # crosses kNTMinBlocks
    for dt in ("u8", "u16", "u32", "u64"):
        w = 3
        vals = random_values(rng, dt, w, n_blocks=n)
        packed = ref.pack(vals, w, dt)
        out = native.unpack(packed, w, dt)  # aligned alloc -> NT path
        np.testing.assert_array_equal(out, vals)
        # unaligned caller buffer must still work (classic path)
        raw = np.empty(n * 1024 * vals.dtype.itemsize + 64, np.uint8)
        off = (-raw.ctypes.data) % 64 + vals.dtype.itemsize
        ubuf = raw[off:off + n * 1024 * vals.dtype.itemsize]
        ubuf = ubuf.view(vals.dtype).reshape(n, 1024)
        np.testing.assert_array_equal(native.unpack(packed, w, dt, out=ubuf), vals)
        # fused decodes through the NT dispatch
        tr = ref.transpose(vals, dt)
        base = np.ascontiguousarray(tr[:, :layout.lanes(dt)])
        deltas = ref.delta(tr, base, dt)
        pd = ref.pack(deltas, w, dt)
        np.testing.assert_array_equal(
            native.undelta_pack(pd, base, w, dt),
            ref.undelta_pack(pd, base, w, dt))
        np.testing.assert_array_equal(
            native.unfor_pack(ref.pack(vals, w, dt), 0, w, dt),
            ref.unfor_pack(ref.pack(vals, w, dt), 0, w, dt))
