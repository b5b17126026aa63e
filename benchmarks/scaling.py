#!/usr/bin/env python
"""Scaling-efficiency benchmark: sharded decode over 1..N devices.

The BASELINE.md target "scaling efficiency at 1 chip, 1 host, N>=2 hosts".
Blocks are independent, so the codec is data-parallel: a 1-D mesh over the
block axis, shard_map'd fused decode per device, no collectives on the hot
path (reference has no distribution layer — this is new surface).

On a multi-GPU host this measures the cards; with
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=N it
runs on a virtual CPU mesh, which validates the methodology and sharding
overheads only (CPU numbers say nothing about GPU throughput). For N hosts,
run one process per host with fastlanes_tpu.parallel.mesh.setup_distributed
and the same script.

Usage: python benchmarks/scaling.py [--devices N] [--blocks B] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="max devices to sweep (default: all)")
    ap.add_argument("--blocks", type=int, default=None,
                    help="blocks PER DEVICE (weak scaling)")
    ap.add_argument("--width", type=int, default=3)
    ap.add_argument("--out", default="benchmarks/scaling.jsonl")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.core import layout
    from fastlanes_tpu.parallel import mesh as pmesh
    from fastlanes_tpu.parallel import shard as psh
    from fastlanes_tpu.ref import numpy_ref as ref

    devices = jax.devices()
    platform = devices[0].platform
    n_max = args.devices or len(devices)
    if n_max > len(devices):
        raise SystemExit(f"asked for {n_max} devices, have {len(devices)}")
    W, DT = args.width, "u32"
    per_dev = args.blocks or 65536

    rng = np.random.default_rng(0)
    records = []

    K = 64  # in-graph chain length: amortizes the per-call dispatch

    def timed(fn, arg, iters=5):
        # fn returns a scalar whose host fetch forces all K chained decodes
        _ = np.asarray(fn(arg))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _ = np.asarray(fn(arg))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / K

    from jax.sharding import PartitionSpec as P

    def chained_decode(mesh):
        """jit(scan(shard_map(decode))): the bench.py chained-timing pattern
        over a sharded payload. Every iteration's FULL output passes
        jax.lax.optimization_barrier — the routed decode may take the XLA
        ops path, which a bare scalar probe would let XLA dead-code
        eliminate (see benchmarks/NOTES.md)."""
        from fastlanes_tpu.kernels import codecs as pk
        decode = lambda p: pk.unpack(p, W, DT)  # routed fastest path
        spec = P("blocks", None)

        def local(p):
            def body(c, _):
                out = decode(jnp.bitwise_xor(p, c))
                out = jax.lax.optimization_barrier(out)
                nc = jnp.where(out[0, 0] < jnp.uint32(0xFFFFFFFF),
                               jnp.uint32(0), jnp.uint32(1))
                return nc, ()
            c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
            return jax.lax.psum(c, "blocks")

        return jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,),
                                     out_specs=P()))

    base_t = None
    sizes = sorted({1, 2, n_max // 2, n_max} - {0})
    for n in sizes:
        if n > n_max:
            continue
        mesh = pmesh.make_mesh(n)
        n_blocks = per_dev * n  # weak scaling: constant work per device
        values = rng.integers(0, 1 << W, (n_blocks, layout.BLOCK),
                              np.int64).astype(np.uint32)
        packed = jax.device_put(
            jnp.asarray(ref.pack(values, W, DT)),
            jax.sharding.NamedSharding(mesh, P("blocks", None)))

        t = timed(chained_decode(mesh), packed)
        ints_per_s = n_blocks * layout.BLOCK / t
        if n == 1:
            base_t = ints_per_s
        eff = ints_per_s / (base_t * n) if base_t else None
        rec = {"devices": n, "platform": platform, "blocks": n_blocks,
               "width": W, "dtype": DT,
               "decode_ints_per_s": round(ints_per_s, 1),
               "scaling_efficiency": round(eff, 4) if eff else None}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
