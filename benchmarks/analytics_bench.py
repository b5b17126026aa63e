#!/usr/bin/env python
"""Analytics-surface benchmark: fused decode->reduce throughput over
compressed FLT files (scan_column / count_where / scan_where / scan_table /
group_stats).

Unlike the chained kernel benches this INCLUDES disk IO, host staging and
dispatch — the wall-clock a query engine actually sees per column scan.
Records logical ints (or floats) per second per query shape.

Usage: python benchmarks/analytics_bench.py [--blocks N] [--out PATH]
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
    ap.add_argument("--out", default="benchmarks/analytics_bench.jsonl")
    args = ap.parse_args()

    import jax

    from fastlanes_tpu import analytics, fio, fio_table
    from fastlanes_tpu.core import layout

    platform = jax.devices()[0].platform
    n_blocks = args.blocks or 16384
    n = n_blocks * layout.BLOCK
    rng = np.random.default_rng(0)
    records = []

    def emit(rec):
        rec.update(platform=platform, n_rows=n)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    def timed(fn, iters=3):
        fn()  # warm: jit compiles, page cache fills
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    tmpdir = tempfile.mkdtemp()
    try:
        # single-column scans per codec/dtype shape
        datasets = {
            "bitpack_u32": rng.integers(0, 1 << 7, (n_blocks, 1024),
                                        np.int64).astype(np.uint32),
            "delta_u32": np.sort(rng.integers(0, 1 << 28, (n_blocks, 1024),
                                              np.int64).astype(np.uint32),
                                 axis=1),
            "bitpack_u64": rng.integers(0, 1 << 40, (n_blocks, 1024),
                                        np.int64).astype(np.uint64),
            "alp_f32": (rng.integers(0, 1 << 20, (n_blocks, 1024)) / 100.0
                        ).astype(np.float32),
            "alp_f64": (rng.integers(0, 1 << 20, (n_blocks, 1024)) / 100.0
                        ).astype(np.float64),
        }
        for name, values in datasets.items():
            path = os.path.join(tmpdir, f"{name}.flt")
            codec = name.split("_")[0] if values.dtype.kind == "u" else "auto"
            fio.write_file(path, values, codec=codec)
            t_scan = timed(lambda p=path: analytics.scan_column(p))
            t_cnt = timed(lambda p=path: analytics.count_where(p, "gt", 50))
            t_filt = timed(lambda p=path: analytics.scan_where(p, "gt", 50))
            emit({"bench": "analytics_scan", "dataset": name,
                  "scan_rows_per_s": round(n / t_scan, 1),
                  "count_where_rows_per_s": round(n / t_cnt, 1),
                  "scan_where_rows_per_s": round(n / t_filt, 1)})

        # table: multi-column single-pass scan + group-by
        key = rng.integers(0, 16, n).astype(np.uint16)
        qty = rng.integers(0, 1000, n, np.int64).astype(np.uint32)
        price = (rng.integers(0, 1 << 16, n) / 100.0).astype(np.float32)
        tpath = os.path.join(tmpdir, "t.flt")
        fio_table.write_table(tpath, {"k": key, "qty": qty, "price": price})
        t_table = timed(lambda: analytics.scan_table(tpath))
        t_group = timed(lambda: analytics.group_stats(tpath, "k", "qty",
                                                      max_groups=16))
        t_groupf = timed(lambda: analytics.group_stats(tpath, "k", "price",
                                                       max_groups=16))
        t_cross = timed(lambda: analytics.scan_where(
            tpath, "gt", 500, column="price", where="qty"))
        emit({"bench": "analytics_table", "columns": 3, "groups": 16,
              "scan_table_rows_per_s": round(3 * n / t_table, 1),
              "group_by_u32_rows_per_s": round(n / t_group, 1),
              "group_by_f32_rows_per_s": round(n / t_groupf, 1),
              "cross_column_scan_where_rows_per_s": round(n / t_cross, 1)})

        # SQL-ish pushdowns: multi-predicate WHERE, top-k, ORDER BY LIMIT
        # select, dict/string columns (codes + gather path)
        cats = np.array(["EUR", "GBP", "JPY", "USD", "AUD", "CAD", "CHF",
                         "CNY"])
        spath = os.path.join(tmpdir, "s.flt")
        fio_table.write_table(spath, {"cur": cats[key % 8], "qty": qty,
                                      "price": price})
        t_multi = timed(lambda: analytics.scan_where_multi(
            spath, [("cur", "eq", "EUR"), ("qty", "gt", 500)],
            column="price"))
        t_topk = timed(lambda: analytics.top_k(tpath, "qty", k=10))
        t_sel = timed(lambda: analytics.select(
            spath, columns=["qty", "price"], preds=[("cur", "eq", "EUR"),
                                                    ("qty", "gt", 900)]))
        t_ord = timed(lambda: analytics.select(
            spath, columns=["qty", "cur"], order_by="price", desc=True,
            limit=10))
        t_vc = timed(lambda: analytics.value_counts(spath, "cur"))
        t_strgrp = timed(lambda: analytics.group_stats(spath, "cur", "qty",
                                                       max_groups=8))
        dimpath = os.path.join(tmpdir, "dim.flt")
        fio_table.write_table(dimpath, {
            "cur": cats, "rate": (np.arange(8) / 7.0 + 0.5)})
        t_join = timed(lambda: analytics.join(
            spath, dimpath, on="cur", columns=["qty"],
            preds=[("qty", "gt", 900)]))
        emit({"bench": "analytics_pushdowns",
              "scan_where_multi_rows_per_s": round(2 * n / t_multi, 1),
              "top_k_rows_per_s": round(n / t_topk, 1),
              "select_rows_per_s": round(3 * n / t_sel, 1),
              "order_by_limit_rows_per_s": round(3 * n / t_ord, 1),
              "value_counts_rows_per_s": round(n / t_vc, 1),
              "group_by_str_rows_per_s": round(2 * n / t_strgrp, 1),
              "join_rows_per_s": round(2 * n / t_join, 1)})
        # zone maps: selective range predicate over a clustered (sorted)
        # column — pruning should skip ~all chunks; the A/B pair is the
        # same file with the stats keys stripped from its header
        import struct as _struct

        zpath = os.path.join(tmpdir, "z.flt")
        sorted_col = np.sort(rng.integers(0, 1 << 30, n, np.int64)
                             ).astype(np.uint32)
        fio_table.write_table(zpath, {"v": sorted_col}, chunk_blocks=64)
        z0path = os.path.join(tmpdir, "z0.flt")
        raw = open(zpath, "rb").read()
        m = len(fio_table.MAGIC)
        (hlen,) = _struct.unpack("<I", raw[m:m + 4])
        hdr = json.loads(raw[m + 4:m + 4 + hlen].decode())
        for c in hdr["columns"]["v"]["chunks"]:
            c.pop("stats", None)
        nh = json.dumps(hdr).encode()
        with open(z0path, "wb") as f:
            f.write(raw[:m] + _struct.pack("<I", len(nh)) + nh
                    + raw[m + 4 + hlen:])
        lo = int(sorted_col[n - n // 256])  # hits the last ~1/256 of rows
        t_zon = timed(lambda: analytics.count_where(zpath, "ge", lo,
                                                    column="v"))
        t_noz = timed(lambda: analytics.count_where(z0path, "ge", lo,
                                                    column="v"))
        t_zsel = timed(lambda: analytics.select(
            zpath, columns=["v"], preds=[("v", "ge", lo)]))
        t_nsel = timed(lambda: analytics.select(
            z0path, columns=["v"], preds=[("v", "ge", lo)]))
        t_ztop = timed(lambda: analytics.select(
            zpath, columns=["v"], order_by="v", desc=True, limit=10))
        t_ntop = timed(lambda: analytics.select(
            z0path, columns=["v"], order_by="v", desc=True, limit=10))
        emit({"bench": "analytics_zonemaps", "chunk_blocks": 64,
              "selectivity": 1 / 256,
              "count_where_rows_per_s": round(n / t_zon, 1),
              "count_where_nostats_rows_per_s": round(n / t_noz, 1),
              "count_prune_speedup": round(t_noz / t_zon, 2),
              "select_rows_per_s": round(n / t_zsel, 1),
              "select_nostats_rows_per_s": round(n / t_nsel, 1),
              "select_prune_speedup": round(t_nsel / t_zsel, 2),
              "order_by_limit_rows_per_s": round(n / t_ztop, 1),
              "order_by_limit_nostats_rows_per_s": round(n / t_ntop, 1),
              "order_by_limit_prune_speedup": round(t_ntop / t_ztop, 2)})
    finally:
        import shutil

        shutil.rmtree(tmpdir, ignore_errors=True)

    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"# wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
