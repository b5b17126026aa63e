#!/usr/bin/env python
"""fastlanes-tpu codec benchmark on an NVIDIA GPU. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, "extra": {...}}

Headline metric: u32 W=3 decode (unpack) throughput in integers/s through
the public entry point kernels.unpack (the plain XLA ops decode), with the
other codec paths recorded alongside.

Harness: K iterations chained inside one jit (lax.scan with a data
dependency between iterations), each iteration's FULL output passed through
jax.lax.optimization_barrier so XLA must materialize every element — no DCE
behind a scalar probe, no fusing the probe into the producer. One scalar
host fetch per repetition.

Roofline: each materialized path also reports `sol_frac`, its fraction of
the device's memory bandwidth for the bytes it must move (read n*W/8 packed
bytes + write n*elem decoded bytes), the peak taken from
fastlanes_tpu.utils.runtime by `device_kind`. It exits with an error when
JAX finds no GPU or the GPU is not in that table.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def _timed_scalar(rep_fn, arg, k, iters=5):
    """Median seconds per chained iteration; rep_fn returns a scalar whose
    host fetch forces completion."""
    _ = np.asarray(rep_fn(arg))  # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _ = np.asarray(rep_fn(arg))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / k


def main():
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fastlanes_tpu.core import layout
    from fastlanes_tpu.ops import bitpack
    from fastlanes_tpu import kernels as pk
    from fastlanes_tpu.ref import numpy_ref as ref
    from fastlanes_tpu.utils import runtime

    runtime.configure_compile_cache()
    runtime.require_gpu(jax.devices())
    dev = jax.devices()[0]
    peak = runtime.peak_hbm_bytes_per_s(dev.device_kind)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()

    W, DT = 3, "u32"
    K = 64  # chained iterations per host fetch
    n_blocks = 131072
    n_ints = n_blocks * layout.BLOCK
    raw_gb = n_ints * 4 / 1e9
    # memory speed of light for materialized u32 W=3 decode: read
    # 3/32 * 4 B/int packed + write 4 B/int values
    decode_bytes_per_int = 4 * W / 32 + 4
    encode_bytes_per_int = 4 + 4 * W / 32
    sol_decode = peak / decode_bytes_per_int
    sol_encode = peak / encode_bytes_per_int

    rng = np.random.default_rng(0)
    values_np = rng.integers(0, 1 << W, (n_blocks, layout.BLOCK), dtype=np.int64).astype(np.uint32)
    packed_np = ref.pack(values_np, W, DT)
    values = jnp.asarray(values_np)
    packed = jnp.asarray(packed_np)

    # correctness gate before timing: the public entry vs the oracle
    got = np.asarray(jax.jit(lambda p: pk.unpack(p, W, DT))(packed))
    assert np.array_equal(got, values_np), "unpack mismatch vs oracle"

    results = {}

    def chained_materialized(fn):
        """Materialize-everything chain."""
        @jax.jit
        def rep(x):
            def body(c, _):
                out = fn(jnp.bitwise_xor(x, c))
                out = jax.lax.optimization_barrier(out)
                nc = jnp.where(out.reshape(-1)[0] < jnp.uint32(0xFFFFFFFF),
                               jnp.uint32(0), jnp.uint32(1))
                return nc.astype(x.dtype), ()
            c, _ = jax.lax.scan(body, jnp.zeros((), x.dtype), None, length=K)
            return c
        return rep

    def chained_roundtrip(unpack_fn, pack_fn):
        @jax.jit
        def rep(p):
            def body(c, _):
                return pack_fn(unpack_fn(c)), ()
            c, _ = jax.lax.scan(body, p, None, length=K)
            return jnp.sum(c[:4, :4].astype(jnp.uint32))
        return rep

    def chained_consume(fn):
        """Decode fused into an on-chip consumer (sum) — the composition the
        FastLanes layout exists for; intermediates never reach HBM."""
        @jax.jit
        def rep(x):
            def body(c, _):
                out = fn(jnp.bitwise_xor(x, c))
                return jnp.sum(out, dtype=jnp.uint32) & jnp.uint32(1), ()
            c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
            return c
        return rep

    def measure_materialized(tag, fn, arg, sol):
        t = _timed_scalar(chained_materialized(fn), arg, K)
        results[f"{tag}_ints_per_s"] = n_ints / t
        results[f"{tag}_sol_frac"] = (n_ints / t) / sol

    measure_materialized("decode", lambda p: pk.unpack(p, W, DT), packed,
                         sol_decode)

    # ENCODE through the public fused-encode entry kernels.pack_map: the
    # chain's per-iteration producer (xor with the carry) is applied per
    # row-slice read, so XLA fuses it into the packed-word production —
    # exactly the work a user's on-device encode does (read input once,
    # write packed words). Perturbing the WHOLE input array instead
    # (pack(x ^ c)) makes XLA materialize the producer — its output has
    # many overlapping slice consumers — charging a spurious extra
    # read+write of the input per iteration; that variant is recorded
    # below as encode_materialized_producer.
    @jax.jit
    def rep_encode_user(x):
        def body(c, _):
            out = pk.pack_map(lambda v: v ^ c, x, W, DT)
            out = jax.lax.optimization_barrier(out)
            nc = jnp.where(out.reshape(-1)[0] < jnp.uint32(0xFFFFFFFF),
                           jnp.uint32(0), jnp.uint32(1))
            return nc, ()
        c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
        return c
    t = _timed_scalar(rep_encode_user, values, K)
    results["encode_ints_per_s"] = n_ints / t
    results["encode_sol_frac"] = (n_ints / t) / sol_encode

    # the materialized-producer harness variant
    measure_materialized("encode_materialized_producer",
                         lambda v: pk.pack(v, W, DT), values, sol_encode)

    # fused FoR encode (for_pack): a real codec entry whose scalar reference
    # carries the chain dependency — no input perturbation at all
    @jax.jit
    def rep_encode_for(x):
        def body(c, _):
            out = pk.for_pack(x, c, W, DT)
            out = jax.lax.optimization_barrier(out)
            nc = jnp.where(out.reshape(-1)[0] < jnp.uint32(0xFFFFFFFF),
                           jnp.uint32(0), jnp.uint32(1))
            return nc, ()
        c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
        return c
    t = _timed_scalar(rep_encode_for, values, K)
    results["for_encode_ints_per_s"] = n_ints / t
    results["for_encode_sol_frac"] = (n_ints / t) / sol_encode

    # original-order fused decode (the delta/zdelta/rle FILE-READ path:
    # kernels.undelta_pack_orig — untranspose fused).
    # Input: a sorted column (what the delta codec actually stores), so the
    # packed width is the realistic gap width, not 32.
    nl32 = layout.lanes(DT)
    sorted_np = np.sort(rng.integers(0, 1 << 30, (n_blocks, layout.BLOCK),
                                     dtype=np.int64).astype(np.uint32), axis=1)
    tr_np = ref.transpose(sorted_np, DT)
    base32 = jnp.asarray(np.ascontiguousarray(tr_np[:, :nl32]))
    deltas_np = ref.delta(tr_np, np.asarray(base32), DT)
    wd = max(int(deltas_np.max()).bit_length(), 1)
    packed_d = jnp.asarray(ref.pack(deltas_np, wd, DT))
    sol_orig = peak / (4 * wd / 32 + 4)

    @jax.jit
    def rep_orig(x):
        def body(c, _):
            out = pk.undelta_pack_orig(jnp.bitwise_xor(x, c), base32, wd, DT)
            out = jax.lax.optimization_barrier(out)
            nc = jnp.where(out.reshape(-1)[0] < jnp.uint32(0xFFFFFFFF),
                           jnp.uint32(0), jnp.uint32(1))
            return nc.astype(x.dtype), ()
        c, _ = jax.lax.scan(body, jnp.zeros((), x.dtype), None, length=K)
        return c
    t = _timed_scalar(rep_orig, packed_d, K)
    results["undelta_orig_w%d_ints_per_s" % wd] = n_ints / t
    results["undelta_orig_w%d_sol_frac" % wd] = (n_ints / t) / sol_orig

    # u64 W=3 materialized decode, separate limb planes (the performance
    # output form; the interleaved image pays a strided stack)
    v64 = rng.integers(0, 1 << W, (n_blocks // 2, layout.BLOCK),
                       dtype=np.int64).astype(np.uint64)
    p64 = jnp.asarray(np.ascontiguousarray(ref.pack(v64, W, "u64"))
                      .view(np.uint32).reshape(n_blocks // 2, -1, 2))
    n64 = v64.size

    def unpack64_planes(x):
        lo, hi = bitpack.unpack_planes(x, W, "u64")
        return jnp.concatenate([lo, hi], axis=-1)

    @jax.jit
    def rep64(x):
        def body(c, _):
            out = jax.lax.optimization_barrier(
                unpack64_planes(jnp.bitwise_xor(x, c)))
            nc = jnp.where(out.reshape(-1)[0] < jnp.uint32(0xFFFFFFFF),
                           jnp.uint32(0), jnp.uint32(1))
            return nc.astype(jnp.uint32), ()
        c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
        return c
    t = _timed_scalar(rep64, p64, K)
    sol_u64 = peak / (8 * W / 64 + 8)
    results["u64_decode_planes_ints_per_s"] = n64 / t
    results["u64_decode_planes_sol_frac"] = (n64 / t) / sol_u64

    # fused decode+consumer and packed->packed round trip (XLA compositions)
    t = _timed_scalar(chained_consume(lambda p: pk.unpack(p, W, DT)), packed, K)
    results["fused_decode_ints_per_s"] = n_ints / t
    t = _timed_scalar(
        chained_roundtrip(lambda p: pk.unpack(p, W, DT),
                          lambda v: pk.pack(v, W, DT)), packed, K)
    results["roundtrip_ints_per_s"] = n_ints / t
    results["encdec_GBps"] = 2 * raw_gb / t

    headline = results["decode_ints_per_s"]
    results["path"] = "unpack"
    results["n_blocks"] = n_blocks
    results["K"] = K
    results["peak_bytes_per_s"] = peak
    results["nvidia_smi"] = smi

    print(json.dumps({
        "metric": "u32_w3_decode_ints_per_sec",
        "value": headline,
        "unit": "ints/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "extra": results,
    }))


if __name__ == "__main__":
    main()
