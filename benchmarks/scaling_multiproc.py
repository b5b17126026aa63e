#!/usr/bin/env python
"""2-process jax.distributed throughput smoke (BASELINE.md "N>=2 hosts" row).

test_multiprocess proves CORRECTNESS over Gloo collectives; this measures
THROUGHPUT through the same path: two OS processes x 4 virtual CPU devices
each, one global 8-device mesh over the block axis, chained sharded decode
(the scaling.py harness) with the width-agreement pmax and a psum'd probe
riding real cross-process collectives.

Both workers are pinned to the CPU (JAX_PLATFORMS=cpu before jax is
imported), so the script never opens a GPU: two JAX processes on one card
would each reserve most of its memory. The aggregate number is a
METHODOLOGY record (the distributed path runs end-to-end at benchable
scale), not a hardware claim — the jsonl row says platform=cpu.

Usage: python benchmarks/scaling_multiproc.py [--blocks PER_DEV] [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = textwrap.dedent("""
    import os, sys, time, json
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    per_dev = int(sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address="127.0.0.1:" + port,
                               num_processes=nproc, process_id=pid)
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    sys.path.insert(0, {repo!r})
    from fastlanes_tpu.core import layout
    from fastlanes_tpu.parallel import mesh as pmesh, shard as psh
    from fastlanes_tpu.ops import bitpack as ops_bitpack
    from fastlanes_tpu.ref import numpy_ref as ref

    W, DT, K = 3, "u32", 16
    mesh = pmesh.make_mesh()
    n_dev = len(jax.devices())
    n_blocks = per_dev * n_dev
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << W, (n_blocks, 1024), np.int64).astype(np.uint32)
    w = int(psh.global_max_bits(mesh, values, DT))   # cross-process pmax
    assert w == W, w
    packed_np = ref.pack(values, W, DT)
    # each process owns its half of the global block axis
    lo = packed_np.shape[0] * pid // nproc
    hi = packed_np.shape[0] * (pid + 1) // nproc
    arrays = [jax.device_put(jnp.asarray(a), d)
              for a, d in zip(np.array_split(packed_np[lo:hi], 4),
                              jax.local_devices())]
    sharding = jax.sharding.NamedSharding(mesh, P("blocks", None))
    packed = jax.make_array_from_single_device_arrays(
        (packed_np.shape[0], packed_np.shape[1]), sharding, arrays)

    def local(p):
        def body(c, _):
            out = ops_bitpack.unpack(jnp.bitwise_xor(p, c), W, DT)
            out = jax.lax.optimization_barrier(out)
            nc = jnp.where(out[0, 0] < jnp.uint32(0xFFFFFFFF),
                           jnp.uint32(0), jnp.uint32(1))
            return nc, ()
        c, _ = jax.lax.scan(body, jnp.uint32(0), None, length=K)
        return jax.lax.psum(c, "blocks")

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("blocks", None),),
                               out_specs=P(), check_vma=False))
    _ = np.asarray(fn(packed))  # compile + warm
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        _ = np.asarray(fn(packed))
        times.append(time.perf_counter() - t0)
    t = float(np.median(times)) / K
    if pid == 0:
        print(json.dumps({"devices": n_dev, "processes": nproc,
                          "platform": "cpu", "backend": "gloo",
                          "blocks": n_blocks, "width": W, "dtype": DT,
                          "decode_ints_per_s": round(n_blocks * 1024 / t, 1)}),
              flush=True)
""").format(repo=REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=512, help="blocks per device")
    ap.add_argument("--out", default="benchmarks/scaling_multiproc.jsonl")
    args = ap.parse_args()

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        worker = os.path.join(td, "worker.py")
        with open(worker, "w") as f:
            f.write(_WORKER)
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        procs = [subprocess.Popen(
            [sys.executable, worker, str(pid), "2", port, str(args.blocks)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for pid in range(2)]
        outs = [p.communicate(timeout=600)[0] for p in procs]
    line = None
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("{"):
                line = ln
    if line is None:
        print("FAILED:\n" + "\n".join(outs), file=sys.stderr)
        raise SystemExit(1)
    print(line)
    with open(args.out, "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
