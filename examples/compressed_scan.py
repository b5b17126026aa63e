#!/usr/bin/env python
"""Analytics-style scan over a FastLanes-compressed column, fused on-device.

The production composition the transposed layout exists for (reference
macros.rs:5-9): the decoder is a static shift/mask DAG, so XLA fuses it INTO
the aggregation — decompressed values never hit HBM. This demo builds a
compressed u32 column, then computes sum / max / predicate-count directly
over the packed representation and reports effective scan throughput in
(logical, decompressed) ints/s.

Run: python examples/compressed_scan.py [n_blocks]
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from fastlanes_tpu.core import layout
from fastlanes_tpu.ops import bitpack
from fastlanes_tpu.ref import numpy_ref as ref


def main():
    n_blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 16384
    W, DT = 7, "u32"
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << W, (n_blocks, layout.BLOCK),
                          np.int64).astype(np.uint32)
    packed = jnp.asarray(ref.pack(values, W, DT))
    n_ints = n_blocks * layout.BLOCK
    ratio = values.nbytes / np.asarray(packed).nbytes

    @jax.jit
    def scan(p, threshold):
        v = bitpack.unpack(p, W, DT)  # fused into the reductions below
        return (jnp.sum(v, dtype=jnp.uint32),  # mod 2^32 (x64 off)
                jnp.max(v),
                jnp.sum((v > threshold).astype(jnp.int32)))

    s, m, c = jax.device_get(scan(packed, jnp.uint32(100)))  # compile + warm
    assert int(s) == int(values.sum(dtype=np.uint64)) % (1 << 32)
    assert int(m) == int(values.max())
    assert int(c) == int((values > 100).sum())
    print(f"sum(mod 2^32)={int(s)} max={int(m)} count(>100)={int(c)} — match numpy")

    K = 16

    @jax.jit
    def chained(p):
        def body(carry, _):
            _, m, _ = scan(p ^ carry, jnp.uint32(100))
            # data-dependent carry that is 0 at runtime but opaque to XLA
            nc = jnp.where(m < jnp.uint32(0xFFFFFFFF), jnp.uint32(0), jnp.uint32(1))
            return nc, ()
        out, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
        return out

    _ = np.asarray(chained(packed))
    t0 = time.perf_counter()
    _ = np.asarray(chained(packed))
    t = (time.perf_counter() - t0) / K
    print(f"scanned {n_ints/1e6:.0f}M ints ({ratio:.1f}x compressed) in "
          f"{t*1e3:.2f} ms/pass = {n_ints/t/1e9:.1f}e9 ints/s "
          f"({n_ints*4/t/1e9:.0f} GB/s logical)")


if __name__ == "__main__":
    main()
