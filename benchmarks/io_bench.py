#!/usr/bin/env python
"""End-to-end IO benchmark: FLT file -> decoded array on device.

Measures the fio_device story (host ships compressed bytes, chip decodes):
wall-clock read_file_device throughput per codec, the pipelined multi-file
reader, and the host-codec path for comparison. Unlike the chained kernel
benches this INCLUDES disk IO, host staging, the PCIe transfer and
dispatch — the number an IO pipeline actually sees.

Usage: python benchmarks/io_bench.py [--blocks N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, ".")

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--out", default="benchmarks/io_bench.jsonl")
    args = ap.parse_args()

    import jax

    from fastlanes_tpu import fio, fio_device
    from fastlanes_tpu.core import layout

    platform = jax.devices()[0].platform
    n_blocks = args.blocks or 16384
    n_ints = n_blocks * layout.BLOCK
    raw_mb = n_ints * 4 / 1e6
    rng = np.random.default_rng(0)
    records = []

    def emit(rec):
        rec.update(platform=platform, n_blocks=n_blocks)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def timed(fn, iters=3):
        fn()  # warm: jit compiles, page cache fills
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            jax.block_until_ready(out) if hasattr(out, "block_until_ready") else None
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    datasets = {
        "bitpack": rng.integers(0, 1 << 7, (n_blocks, 1024), np.int64).astype(np.uint32),
        "delta": np.sort(rng.integers(0, 1 << 28, (n_blocks, 1024), np.int64)
                         .astype(np.uint32), axis=1),
        "rle": np.repeat(rng.integers(0, 1 << 16, n_blocks * 16).astype(np.uint32),
                         64).reshape(n_blocks, 1024),
        "alp": (rng.integers(0, 1 << 20, (n_blocks, 1024)) / 100.0).astype(np.float32),
    }

    tmpdir = tempfile.mkdtemp()
    try:
        for codec, values in datasets.items():
            path = os.path.join(tmpdir, f"{codec}.flt")
            fio.write_file(path, values,
                           codec=codec if values.dtype.kind == "u" else "auto")
            file_mb = os.path.getsize(path) / 1e6
            t_dev = timed(lambda p=path: fio_device.read_file_device(p))
            t_host = timed(lambda p=path: fio.read_file(p))
            # A/B: chunk-at-a-time dispatch (the pre-batching behavior)
            os.environ["FASTLANES_NO_CHUNK_BATCH"] = "1"
            try:
                t_unbatched = timed(
                    lambda p=path: fio_device.read_file_device(p))
            finally:
                os.environ.pop("FASTLANES_NO_CHUNK_BATCH", None)
            emit({"bench": "io_read", "codec": codec,
                  "file_MB": round(file_mb, 1), "raw_MB": round(raw_mb, 1),
                  "ratio": round(raw_mb / file_mb, 2),
                  "device_MBps_logical": round(raw_mb / t_dev, 1),
                  "device_ints_per_s": round(n_ints / t_dev, 1),
                  "device_unbatched_ints_per_s": round(n_ints / t_unbatched, 1),
                  "batching_speedup": round(t_unbatched / t_dev, 2),
                  "host_MBps_logical": round(raw_mb / t_host, 1)})

        # pipelined multi-file reader vs sequential
        paths = []
        for i in range(6):
            p = os.path.join(tmpdir, f"m{i}.flt")
            fio.write_file(p, datasets["delta"][: n_blocks // 4])
            paths.append(p)

        def pipelined():
            last = None
            for _, arr in fio_device.iter_files_device(paths, prefetch=2):
                last = arr
            return last

        def sequential():
            last = None
            for p in paths:
                last = fio_device.read_file_device(p)
            return last

        def batched():
            return list(fio_device.read_files_device(paths).values())[-1]

        total_mb = 6 * (n_blocks // 4) * 1024 * 4 / 1e6
        t_pipe = timed(pipelined)
        t_seq = timed(sequential)
        t_batch = timed(batched)
        emit({"bench": "io_multifile", "files": 6,
              "raw_MB": round(total_mb, 1),
              "pipelined_MBps_logical": round(total_mb / t_pipe, 1),
              "sequential_MBps_logical": round(total_mb / t_seq, 1),
              "pipeline_speedup": round(t_seq / t_pipe, 3),
              "crossfile_batched_MBps_logical": round(total_mb / t_batch, 1),
              "crossfile_batch_speedup": round(t_seq / t_batch, 3)})
    finally:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)

    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"# wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
