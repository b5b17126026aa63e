"""Wire-format pins and cross-path coverage for the zdelta codec and the
container features layered on it."""

import hashlib

import numpy as np

from fastlanes_tpu import fio, fio_table
from fastlanes_tpu.models.codecs import ZDeltaCodec
from fastlanes_tpu.parallel import mesh as pmesh
from fastlanes_tpu.ref import numpy_ref as ref


def _golden_inputs():
    rng = np.random.default_rng(0x5EED)
    steps = rng.integers(-3, 20, (2, 1024), np.int64)
    return (np.cumsum(steps, axis=1) + 1000).astype(np.uint16)


def test_zdelta_wire_golden():
    """Pin the zdelta chunk bytes: transpose -> delta(row-0 base) ->
    zigzag -> pack(u16). Any layout/transform change breaks this hash."""
    values = _golden_inputs()
    tr = ref.transpose(values, "u16")
    base = np.ascontiguousarray(tr[:, :64])
    d = ref.delta(tr, base, "u16").view(np.int16)
    zz = ((d << 1) ^ (d >> 15)).view(np.uint16)
    assert int(zz.max()).bit_length() == 6
    packed = ref.pack(zz, 6, "u16")
    assert hashlib.sha256(np.ascontiguousarray(packed).tobytes()).hexdigest() == \
        "8d2626a3006a5bac7dd968d3f83ba587db851155ae1db03a1fd7470d74d92f64"
    assert hashlib.sha256(base.tobytes()).hexdigest() == \
        "4196a32893b6747fae45a7e17c21221277d6abf2b1361eb1df9b349c2860d6cc"
    # the driver must produce the identical payload
    enc = ZDeltaCodec("u16").encode(values)
    assert enc.width == 6
    np.testing.assert_array_equal(np.asarray(enc.payload), packed)
    np.testing.assert_array_equal(np.asarray(enc.params["base"]), base)


def test_mixed_codec_chunks_in_one_file(tmp_path, rng):
    """Chunks pick codecs independently: sorted / offset / noisy-sorted
    sections of one column land as delta / ffor / zdelta."""
    sorted_part = np.sort(rng.integers(0, 1 << 28, 2048, np.int64)).astype(np.uint32)
    offset_part = (rng.integers(0, 16, 2048, np.int64) + (1 << 30)).astype(np.uint32)
    noisy_part = (np.cumsum(rng.integers(-3, 20, 2048, np.int64)) + 10_000).astype(np.uint32)
    col = np.concatenate([sorted_part, offset_part, noisy_part])
    path = str(tmp_path / "mixed.flt")
    header = fio.write_file(path, col, chunk_blocks=2)
    codecs = [c["codec"] for c in header["chunks"]]
    assert codecs == ["delta", "ffor", "zdelta"]
    np.testing.assert_array_equal(fio.read_file(path), col)


def test_table_column_on_mesh(tmp_path, rng):
    """Meshed device decode of one table column (8-dev CPU mesh)."""
    from fastlanes_tpu import fio_device

    col = (np.cumsum(rng.integers(-3, 20, 16 * 1024, np.int64)) + 5000).astype(np.uint32)
    path = str(tmp_path / "t.flt")
    fio_table.write_table(path, {"walk": col}, chunk_blocks=8)
    mesh = pmesh.make_mesh(8)
    got = np.asarray(fio_device.read_column_device(path, "walk", mesh=mesh))
    np.testing.assert_array_equal(got, col)


def test_rle_wire_golden():
    """RLE chunk bytes pinned (FORMAT.md rle layout): deterministic run
    pattern -> payload sha256 must never change without a version bump."""
    import hashlib

    vals = np.repeat(np.arange(80, dtype=np.uint32) * 1000, 26)[:2048].reshape(2, 1024)
    meta, payload = fio._encode_chunk(vals, "u32", "rle")
    assert meta["codec"] == "rle" and meta["n_runs"] == 80
    assert hashlib.sha256(payload).hexdigest() == (
        "cd31ae957db76044613319d686c2347f8c62e39e1278033a1aafb6539b5567f7")
    np.testing.assert_array_equal(fio._decode_chunk(meta, payload, 2, "u32"), vals)


def test_alp_wire_golden():
    """ALP chunk bytes pinned: 2-decimal f32 ramp -> e=2, f=0, zero
    exceptions, fixed payload sha256."""
    import hashlib

    prices = ((np.arange(2048) % 977) / 100.0).astype(np.float32).reshape(2, 1024)
    meta, payload = fio._encode_chunk_float(prices, "u32", "alp")
    assert (meta["codec"], meta["e"], meta["f"], meta["n_exc"]) == ("alp", 2, 0, 0)
    assert meta["width"] == 10
    assert hashlib.sha256(payload).hexdigest() == (
        "9d9be0891895810e95d0f8ef5c1c52e7ea0c64aa3e09e7a024712c654f5d79f2")
    out = fio._decode_chunk(meta, payload, 2, "u32")
    np.testing.assert_array_equal(out.view(np.uint32), prices.view(np.uint32))


def test_alprd_wire_golden():
    """ALP_RD chunk bytes pinned: exact-binary f64 values (deterministic,
    no RNG stream dependence) -> fixed cut/dict/payload."""
    import hashlib

    i = np.arange(2048)
    doubles = (((i % 911) + 1) * (2.0 ** -(i % 13))).astype(np.float64).reshape(2, 1024)
    meta, payload = fio._encode_chunk_float(doubles, "u64", "alprd")
    assert (meta["codec"], meta["width"], meta["idx_width"],
            meta["n_exc"], len(meta["dict"])) == ("alprd", 54, 3, 0, 6)
    assert hashlib.sha256(payload).hexdigest() == (
        "77cb2e50c3774c1f9816fdf9a1ae7f5baf9680dc35b323556d00aab150abc3ef")
    out = fio._decode_chunk(meta, payload, 2, "u64")
    np.testing.assert_array_equal(out.view(np.uint64), doubles.view(np.uint64))
