#!/usr/bin/env python
"""End-to-end tour of fastlanes_tpu — run with no arguments.

Covers the README example of the reference crate (u16 W=3 pack/unpack/
unpack_single, reference README.md:14-47), the composed codec drivers, the
FLT file format with device-side decode, and sharded execution on whatever
mesh is available. Works on CPU or GPU.
"""

import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")

import jax

from fastlanes_tpu.models.codecs import DeltaCodec, auto_encode, get_codec
from fastlanes_tpu.ops import bitpack, dispatch, single
from fastlanes_tpu.parallel import mesh as pmesh, shard as psh
from fastlanes_tpu import fio, fio_device


def main():
    print(f"devices: {jax.devices()}")

    # 1. The reference README example: u16, W=3, values 0..7 repeating.
    values = (np.arange(1024, dtype=np.uint16) % 8).reshape(1, 1024)
    packed = np.asarray(bitpack.pack(values, 3, "u16"))
    assert packed.shape == (1, 192)  # 1024*3/16 words
    out = np.asarray(bitpack.unpack(packed, 3, "u16"))
    assert np.array_equal(out, values)
    one = int(np.asarray(single.unpack_single(packed, 3, 14, "u16")).reshape(-1)[0])
    assert one == values[0, 14]
    print("1. u16 W=3 pack/unpack/unpack_single round-trip ok")

    # 2. Runtime-width dispatch (the unchecked_* API of the reference).
    w = 11
    vals = np.random.default_rng(0).integers(0, 1 << w, (128, 1024),
                                             np.int64).astype(np.uint32)
    p = dispatch.unchecked_pack(w, vals, "u32")
    assert np.array_equal(np.asarray(dispatch.unchecked_unpack(w, p, "u32")), vals)
    print("2. runtime-width dispatch ok")

    # 3. Codec drivers with automatic selection.
    sorted_vals = np.sort(vals, axis=1)
    enc = auto_encode(sorted_vals, "u32")
    dec = np.asarray(get_codec(enc.codec, "u32").decode(enc))
    assert np.array_equal(dec, sorted_vals)
    print(f"3. auto_encode picked {enc.codec} W={enc.width} "
          f"(ratio {enc.compression_ratio:.2f}x) ok")

    # 4. FLT file: compress on host, decode on the accelerator.
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, sorted_vals, dtype="u32", chunk_blocks=32)
        dev = fio_device.read_file_device(f.name)
        assert np.array_equal(np.asarray(dev), sorted_vals)
        element = fio.read_single(f.name, block=3, index=777)
        assert element == sorted_vals[3, 777]
    print("4. FLT write -> device decode -> random access ok")

    # 5. Sharded execution over all local devices.
    mesh = pmesh.make_mesh()
    gw = int(psh.global_max_bits(mesh, vals, "u32"))
    sp = psh.sharded_pack(mesh, vals, gw, "u32")  # "auto": measured fastest path
    assert np.array_equal(np.asarray(dispatch.unchecked_unpack(gw, sp, "u32")), vals)
    print(f"5. sharded pack over {mesh.devices.size} device(s), "
          f"agreed width {gw} ok")

    # 6. Fused delta pipeline (the delta.rs:80-96 composition).
    codec = DeltaCodec("u32")
    enc = codec.encode(sorted_vals)
    assert np.array_equal(np.asarray(codec.decode(enc)), sorted_vals)
    print(f"6. fused delta codec W={enc.width} ok")

    # 7. Multi-column table with a signed (zigzag) column, any lengths.
    from fastlanes_tpu import fio_table
    rng = np.random.default_rng(7)
    table = {"id": np.arange(3000, dtype=np.uint32),
             "delta_t": rng.integers(-50, 50, 3000, np.int64).astype(np.int16)}
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio_table.write_table(f.name, table)
        got = fio_table.read_table(f.name)
    assert got["delta_t"].dtype == np.int16
    for k in table:
        assert np.array_equal(got[k], table[k])
    print("7. table file (unsigned + signed zigzag columns) ok")

    # 8. Fused analytics: query a compressed file without materializing it.
    from fastlanes_tpu import analytics

    col = np.sort(rng.integers(0, 1 << 20, 4000, np.int64).astype(np.uint32))
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, col)
        stats = analytics.scan_column(f.name)
        n_hi = analytics.count_where(f.name, "gt", 1 << 19)
    assert stats["sum"] == int(col.sum()) and stats["count"] == 4000
    assert n_hi == int((col > (1 << 19)).sum())
    print("8. fused analytics (sum/min/max/count_where) over compressed ok")

    # 9. Original-order fused decode + fused-producer encode (round-3 API).
    from fastlanes_tpu import kernels
    from fastlanes_tpu.ref import numpy_ref as npref

    tr = npref.transpose(sorted_vals, "u32")
    base = np.ascontiguousarray(tr[:, :32])
    deltas = npref.delta(tr, base, "u32")
    wd = int(deltas.max()).bit_length()
    pd = npref.pack(deltas, wd, "u32")
    orig = np.asarray(kernels.undelta_pack_orig(pd, base, wd, "u32"))
    assert np.array_equal(orig, sorted_vals)  # untranspose fused into decode
    import jax.numpy as jnp

    pm = np.asarray(kernels.pack_map(
        lambda v: v - jnp.uint32(1), sorted_vals + np.uint32(1), gw, "u32"))
    assert np.array_equal(pm, np.asarray(bitpack.pack(sorted_vals, gw, "u32")))
    print(f"9. orig-order fused decode (W={wd}) + pack_map fused encode ok")

    # 10. u64 columns come back as LimbPlanes (lo/hi uint32 device planes).
    col64 = np.sort(rng.integers(0, 1 << 44, 3000, np.int64).astype(np.uint64))
    with tempfile.NamedTemporaryFile(suffix=".flt") as f:
        fio.write_file(f.name, col64)
        planes = fio_device.read_file_device(f.name)
    assert np.array_equal(planes.to_u64().reshape(-1), col64)
    print(f"10. u64 file -> LimbPlanes(shape={planes.shape}) bit-exact ok")


if __name__ == "__main__":
    main()
