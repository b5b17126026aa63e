"""ALP float compression: exact-roundtrip spec, exception handling, device
decode bit-equality, FLT file integration. (Beyond-parity surface — the Rust
reference crate is integer-only.)"""

import numpy as np
import pytest

from fastlanes_tpu import alp, cli, fio


def _decimal_data(rng, dtype, digits=2, n=4096, scale=1000):
    """Price-like data: `digits` decimal places — ALP's sweet spot."""
    cents = rng.integers(-scale * 10 ** digits, scale * 10 ** digits, n)
    return (cents / 10 ** digits).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alp_roundtrip_decimal(rng, dtype):
    values = _decimal_data(rng, dtype).reshape(4, 1024)
    enc = alp.encode_np(values)
    # decimal data encodes with few/no exceptions and a tight width
    assert len(enc["exc_pos"]) < values.size * 0.01
    assert enc["width"] <= 26
    out = alp.decode_np(enc["ints"], enc["e"], enc["f"], enc["reference"],
                        dtype, enc["exc_pos"], enc["exc_val"])
    np.testing.assert_array_equal(out, values)  # bitwise


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alp_random_mantissas_still_exact(rng, dtype):
    """Full-entropy floats: everything becomes an exception, output still
    bit-exact (this is what 'lossless' means in ALP)."""
    values = rng.standard_normal(2048).astype(dtype) * dtype(1e17)
    enc = alp.encode_np(values)
    out = alp.decode_np(enc["ints"], enc["e"], enc["f"], enc["reference"],
                        dtype, enc["exc_pos"], enc["exc_val"])
    np.testing.assert_array_equal(out, values)


def test_alp_nan_inf_negzero(rng):
    values = _decimal_data(rng, np.float32, n=1024)
    values[7] = np.nan
    values[100] = np.inf
    values[200] = -np.inf
    values[300] = -0.0
    enc = alp.encode_np(values)
    out = alp.decode_np(enc["ints"], enc["e"], enc["f"], enc["reference"],
                        np.float32, enc["exc_pos"], enc["exc_val"])
    # bit-level equality (NaN payloads, signed zero)
    np.testing.assert_array_equal(out.view(np.uint32), values.view(np.uint32))


def test_alp_device_decode_matches_numpy(rng):
    values = _decimal_data(rng, np.float32).reshape(4, 1024)
    enc = alp.encode_np(values)
    host = alp.decode_np(enc["ints"], enc["e"], enc["f"], enc["reference"],
                         np.float32, enc["exc_pos"], enc["exc_val"])
    dev = np.asarray(alp.decode_device(
        np.asarray(enc["ints"]), enc["e"], enc["f"], enc["reference"],
        np.float32, enc["exc_pos"], enc["exc_val"]))
    np.testing.assert_array_equal(dev.view(np.uint32), host.view(np.uint32))


def test_alp_choose_ef_decimal(rng):
    sample = _decimal_data(rng, np.float64, digits=3, n=2048)
    e, f = alp.choose_ef(sample)
    assert e - f == 3  # three decimal places -> scale by 10^3


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fio_alp_file_roundtrip(tmp_path, rng, dtype):
    path = str(tmp_path / "f.flt")
    values = _decimal_data(rng, dtype, n=5000)  # ragged flat column
    header = fio.write_file(path, values)
    assert header["vtype"] == ("f32" if dtype == np.float32 else "f64")
    assert all(c["codec"] == "alp" for c in header["chunks"])
    out = fio.read_file(path)
    assert out.dtype == dtype
    np.testing.assert_array_equal(out, values)
    # compression happened (decimal data is far from full-entropy)
    import os
    assert os.path.getsize(path) < values.nbytes * 0.7


def test_fio_alp_block_range_and_single(tmp_path, rng):
    path = str(tmp_path / "f.flt")
    values = _decimal_data(rng, np.float32, n=8 * 1024).reshape(8, 1024)
    values[3, 500] = np.float32(np.pi)  # guaranteed exception
    fio.write_file(path, values, chunk_blocks=4)
    got = fio.read_blocks(path, 2, 5)
    np.testing.assert_array_equal(got, values[2:5])
    assert fio.read_single(path, 3, 500) == np.float32(np.pi)
    assert fio.read_single(path, 6, 123) == values[6, 123]


def test_fio_alp_rejects_bad_combos(tmp_path, rng):
    path = str(tmp_path / "x.flt")
    fvals = _decimal_data(rng, np.float32, n=1024)
    with pytest.raises(ValueError, match="wire dtype"):
        fio.write_file(path, fvals, dtype="u32")
    with pytest.raises(ValueError, match="alp"):
        fio.write_file(path, fvals, codec="delta")
    with pytest.raises(ValueError, match="float"):
        fio.write_file(path, np.arange(1024, dtype=np.uint32), codec="alp")


def test_fio_alp_device_read(tmp_path, rng):
    """Device decode of an ALP file (f32 native; f64 under x64 jax)."""
    from fastlanes_tpu import fio_device

    path = str(tmp_path / "f.flt")
    v32 = _decimal_data(rng, np.float32, n=5000)
    fio.write_file(path, v32)
    got = np.asarray(fio_device.read_file_device(path))
    np.testing.assert_array_equal(got.view(np.uint32), v32.view(np.uint32))

    import jax

    v64 = _decimal_data(rng, np.float64, n=3000)
    fio.write_file(path, v64)
    jax.config.update("jax_enable_x64", True)
    try:
        got = np.asarray(fio_device.read_file_device(path))
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_array_equal(got.view(np.uint64), v64.view(np.uint64))


def test_fio_alp_device_read_sharded(tmp_path, rng):
    from fastlanes_tpu import fio_device, parallel

    path = str(tmp_path / "f.flt")
    values = _decimal_data(rng, np.float32, n=16 * 1024).reshape(16, 1024)
    values[5, 77] = np.float32(np.e)  # exception
    fio.write_file(path, values, chunk_blocks=8)
    mesh = parallel.make_mesh()
    got = np.asarray(fio_device.read_file_device(path, mesh=mesh))
    np.testing.assert_array_equal(got.view(np.uint32), values.view(np.uint32))


def test_fio_table_float_columns(tmp_path, rng):
    from fastlanes_tpu import fio_table

    path = str(tmp_path / "t.flt")
    cols = {
        "price": _decimal_data(rng, np.float64, n=3000),
        "qty": rng.integers(0, 1000, 3000, np.int64).astype(np.uint32),
        "temp": _decimal_data(rng, np.float32, digits=1, n=3000),
    }
    header = fio_table.write_table(path, cols)
    assert header["columns"]["price"]["vtype"] == "f64"
    assert header["columns"]["temp"]["vtype"] == "f32"
    out = fio_table.read_table(path)
    for name, arr in cols.items():
        assert out[name].dtype == arr.dtype
        np.testing.assert_array_equal(out[name], arr)


@pytest.mark.parametrize("d", [0, 1, 2, 3, 7, 10])
def test_div_pow10_correctly_rounded(rng, d):
    """The integer-domain division kernel == IEEE f32 division, bitwise
    (the device decode divides in the integer domain so no backend's
    float divide rounding can change the decoded bits)."""
    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.alp import _div_pow10_f32_device

    xs = np.concatenate([
        np.arange(-3000, 3001, dtype=np.int64),
        rng.integers(-(1 << 24) + 1, 1 << 24, 200_000),
        np.array([0, 1, -1, (1 << 24) - 1, -(1 << 24) + 1], np.int64),
    ]).astype(np.int32)
    want = (xs.astype(np.float32) / np.float32(10.0 ** d)).astype(np.float32)
    got = np.asarray(jax.jit(
        lambda x: _div_pow10_f32_device(x, d))(jnp.asarray(xs)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_alp_codec_driver(rng):
    from fastlanes_tpu.models import ALPCodec, get_codec

    values = _decimal_data(rng, np.float32, n=4 * 1024).reshape(4, 1024)
    values[2, 17] = np.float32(1.0) / 3  # exception
    codec = ALPCodec("f32")
    enc = codec.encode(values)
    assert enc.codec == "alp" and enc.dtype == "u32"
    assert enc.packed_bytes < values.nbytes
    out = np.asarray(codec.decode(enc))
    np.testing.assert_array_equal(out.view(np.uint32), values.view(np.uint32))
    # registry access
    assert type(get_codec("alp", "f32")) is ALPCodec
    with pytest.raises(ValueError, match="f32"):
        ALPCodec("u32")
    with pytest.raises(ValueError, match="float32"):
        ALPCodec("f32").encode(values.astype(np.float64))


def test_cli_alp_roundtrip(tmp_path, rng, capsys):
    import json

    raw, flt, out = tmp_path / "f.npy", tmp_path / "f.flt", tmp_path / "o.npy"
    values = _decimal_data(rng, np.float64, n=3000)
    np.save(raw, values)
    assert cli.main(["compress", str(raw), str(flt)]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["ratio"] > 1.4
    assert cli.main(["decompress", str(flt), str(out)]) == 0
    capsys.readouterr()
    got = np.load(out)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, values)
    cli.main(["get", str(flt), "1", "333"])
    printed = float(capsys.readouterr().out.strip())
    assert printed == float(values[1024 + 333])


# ---------------------------------------------------------------------------
# ALP_RD: the left/right-split fallback for non-decimal floats


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alprd_roundtrip(rng, dtype):
    # real-double-like data: random mantissas, correlated exponents
    values = (rng.standard_normal(4096) * 1000).astype(dtype)
    enc = alp.rd_encode_np(values)
    out = alp.rd_decode_np(enc["left_idx"], enc["rights"], enc["dict"],
                           enc["right_bits"], dtype,
                           enc["exc_pos"], enc["exc_left"])
    t = np.dtype(dtype).itemsize * 8
    u = np.uint32 if t == 32 else np.uint64
    np.testing.assert_array_equal(out.view(u), values.view(u))
    # the left dictionary captures the exponent clustering
    assert len(enc["dict"]) <= 8
    assert len(enc["exc_pos"]) < values.size * 0.2


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_alprd_device_matches_host(rng, dtype):
    import jax.numpy as jnp

    values = (rng.standard_normal(2048) * 1e6).astype(dtype)
    enc = alp.rd_encode_np(values)
    host = alp.rd_decode_np(enc["left_idx"], enc["rights"], enc["dict"],
                            enc["right_bits"], dtype,
                            enc["exc_pos"], enc["exc_left"])
    if dtype == np.float64:
        rights_dev = jnp.asarray(np.ascontiguousarray(enc["rights"])
                                 .view(np.uint32).reshape(-1, 2))
        dev = np.asarray(alp.rd_decode_device(
            jnp.asarray(enc["left_idx"]), rights_dev, enc["dict"],
            enc["right_bits"], dtype, enc["exc_pos"], enc["exc_left"]))
        np.testing.assert_array_equal(
            np.ascontiguousarray(dev).view(np.uint64)[..., 0],
            host.view(np.uint64))
    else:
        dev = np.asarray(alp.rd_decode_device(
            jnp.asarray(enc["left_idx"]), jnp.asarray(enc["rights"]),
            enc["dict"], enc["right_bits"], dtype,
            enc["exc_pos"], enc["exc_left"]))
        np.testing.assert_array_equal(dev.view(np.uint32), host.view(np.uint32))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fio_alprd_file_roundtrip(tmp_path, rng, dtype):
    import os

    path = str(tmp_path / "rd.flt")
    values = (rng.standard_normal(5000) * 42).astype(dtype)
    # auto: random mantissas blow plain ALP's exception budget -> RD
    header = fio.write_file(path, values)
    assert {c["codec"] for c in header["chunks"]} == {"alprd"}
    out = fio.read_file(path)
    t = np.dtype(dtype).itemsize * 8
    u = np.uint32 if t == 32 else np.uint64
    np.testing.assert_array_equal(out.view(u), values.view(u))
    # compresses despite full-entropy mantissas (left dictionary)
    assert os.path.getsize(path) < values.nbytes * 0.95
    # forced codec + random access
    fio.write_file(path, values, codec="alprd")
    assert fio.read_single(path, 1, 100) == values[1024 + 100]


def test_fio_alprd_device_read(tmp_path, rng):
    from fastlanes_tpu import fio_device, parallel

    path = str(tmp_path / "rd.flt")
    values = (rng.standard_normal(4096) * 7).astype(np.float32)
    fio.write_file(path, values, codec="alprd")
    got = np.asarray(fio_device.read_file_device(path))
    np.testing.assert_array_equal(got.view(np.uint32), values.view(np.uint32))
    mesh = parallel.make_mesh()
    got = np.asarray(fio_device.read_file_device(path, mesh=mesh))
    np.testing.assert_array_equal(got.view(np.uint32), values.view(np.uint32))


def test_fio_alprd_f64_device_limb_image(tmp_path, rng):
    """f64 ALP_RD device decode is x64-FREE: returns the (..., 2) uint32
    limb image of the float64 bits."""
    from fastlanes_tpu import fio_device

    path = str(tmp_path / "rd64.flt")
    values = (rng.standard_normal(3000) * 1e9).astype(np.float64)
    fio.write_file(path, values, codec="alprd")
    got = np.asarray(fio_device.read_file_device(path))
    assert got.dtype == np.uint32 and got.shape[-1] == 2
    np.testing.assert_array_equal(
        np.ascontiguousarray(got).view(np.float64)[..., 0], values)


def test_alprd_wide_left_f64(rng):
    """Lefts wider than 16 bits: doubles whose top 32 bits cluster (<=8
    patterns differing BELOW the top 16 bits) should cut at right_bits=32,
    packing rights at half the old floor; rare wide lefts ride the u32
    exception lane."""
    common = np.asarray([0x3FF00000 + k * 0x111 for k in range(8)], np.uint64)
    rare = np.asarray([0x40100000 + k * 0x7 for k in range(4)], np.uint64)
    n = 4096
    hi = common[rng.integers(0, len(common), n)]
    hi[rng.choice(n, 16, replace=False)] = rare[rng.integers(0, len(rare), 16)]
    bits = (hi << np.uint64(32)) | rng.integers(0, 1 << 32, n, np.int64).astype(np.uint64)
    values = bits.view(np.float64)
    enc = alp.rd_encode_np(values)
    assert enc["right_bits"] == 32  # the wide cut wins
    assert len(enc["exc_pos"]) == np.isin(hi, rare).sum()
    out = alp.rd_decode_np(enc["left_idx"], enc["rights"], enc["dict"],
                           enc["right_bits"], np.float64,
                           enc["exc_pos"], enc["exc_left"])
    np.testing.assert_array_equal(out.view(np.uint64), values.view(np.uint64))
    # wire roundtrip: exc_left stored as u32 (left part is 32 bits)
    meta, payload = fio._encode_chunk_float(values.reshape(4, 1024), "u64",
                                            "alprd")
    assert meta["width"] == 32 and fio._alprd_exc_left_dtype(meta) == "<u4"
    dec = fio._decode_chunk(meta, payload, 4, "u64")
    np.testing.assert_array_equal(dec.reshape(-1).view(np.uint64), bits)


def test_alprd_wide_left_f64_device(tmp_path, rng):
    """Device decode of a wide-left f64 ALP_RD file (x64-free limb image)."""
    from fastlanes_tpu import fio_device

    common = np.asarray([0x40500000 + k * 0x29 for k in range(6)], np.uint64)
    n = 3000
    hi = common[rng.integers(0, len(common), n)]
    bits = (hi << np.uint64(32)) | rng.integers(0, 1 << 32, n, np.int64).astype(np.uint64)
    values = bits.view(np.float64)
    path = str(tmp_path / "wide.flt")
    fio.write_file(path, values, codec="alprd")
    hdr = fio.read_header(path)
    assert hdr["chunks"][0]["width"] == 32
    got = np.asarray(fio_device.read_file_device(path))
    assert got.dtype == np.uint32 and got.shape[-1] == 2
    np.testing.assert_array_equal(
        np.ascontiguousarray(got).view(np.float64)[..., 0], values)
    np.testing.assert_array_equal(fio.read_file(path).view(np.uint64), bits)


def test_alprd_wide_left_f32(rng):
    """f32 wide lefts (> 16 bits): low-precision floats with 7 random
    mantissa low bits cut at right_bits=7."""
    common = (np.arange(8, dtype=np.uint32) * np.uint32(0x9E3)
              + np.uint32(0x3DCC << 7))
    n = 2048
    bits = (common[rng.integers(0, 8, n)] << np.uint32(7)) | \
        rng.integers(0, 1 << 7, n).astype(np.uint32)
    values = bits.view(np.float32)
    enc = alp.rd_encode_np(values)
    assert enc["right_bits"] == 7
    out = alp.rd_decode_np(enc["left_idx"], enc["rights"], enc["dict"],
                           enc["right_bits"], np.float32,
                           enc["exc_pos"], enc["exc_left"])
    np.testing.assert_array_equal(out.view(np.uint32), bits)
    meta, payload = fio._encode_chunk_float(values.reshape(2, 1024), "u32",
                                            "alprd")
    assert fio._alprd_exc_left_dtype(meta) == "<u4"
    dec = fio._decode_chunk(meta, payload, 2, "u32")
    np.testing.assert_array_equal(dec.reshape(-1).view(np.uint32), bits)
