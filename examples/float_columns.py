#!/usr/bin/env python
"""ALP float compression tour: price-like decimal data through the full
stack — models driver, FLT file, table container, device decode.

Runs on CPU or GPU: python examples/float_columns.py
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    from fastlanes_tpu import fio, fio_device, fio_table
    from fastlanes_tpu.models import ALPCodec

    rng = np.random.default_rng(7)

    # 1. A float64 "price" column: 2 decimal places, ~$10-$5000
    prices = (rng.integers(1000, 500_000, 100_000) / 100.0)

    # 2. models driver: encode blocks directly
    blocks = prices[: 96 * 1024].reshape(96, 1024)
    codec = ALPCodec("f64")
    enc = codec.encode(blocks)
    ratio = blocks.nbytes / enc.packed_bytes
    print(f"1. ALPCodec: e={enc.params['e']} f={enc.params['f']} "
          f"width={enc.width} bits, {len(enc.params['exc_pos'])} exceptions, "
          f"{ratio:.1f}x smaller")

    # 3. FLT file round trip (arbitrary length; bit-exact)
    with tempfile.NamedTemporaryFile(suffix=".flt", delete=False) as f:
        path = f.name
    try:
        fio.write_file(path, prices)
        out = fio.read_file(path)
        assert out.dtype == np.float64
        assert np.array_equal(out, prices)
        print(f"2. FLT file: {prices.nbytes} raw -> {os.path.getsize(path)} "
              f"bytes on disk, bit-exact read")

        # 4. random access without decoding the file
        assert fio.read_single(path, 5, 123) == prices[5 * 1024 + 123]
        print("3. read_single ok")

        # 5. device decode (f32 column: native on the device)
        temps = (rng.integers(-400, 400, 50_000) / 10.0).astype(np.float32)
        fio.write_file(path, temps)
        got = np.asarray(fio_device.read_file_device(path))
        assert np.array_equal(got.view(np.uint32), temps.view(np.uint32))
        import jax

        print(f"4. device decode on {jax.devices()[0].platform}: bit-exact")

        # 6. mixed table: float + integer columns side by side
        fio_table.write_table(path, {
            "price": prices[:30_000],
            "qty": rng.integers(0, 500, 30_000).astype(np.uint32),
            "temp": temps[:30_000],
        })
        table = fio_table.read_table(path)
        assert np.array_equal(table["price"], prices[:30_000])
        assert table["temp"].dtype == np.float32
        print(f"5. mixed table: {sorted(table)} ok")
    finally:
        os.unlink(path)
    print("float_columns example OK")


if __name__ == "__main__":
    main()
