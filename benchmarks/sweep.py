#!/usr/bin/env python
"""Full benchmark sweep — the framework analogue of the reference's criterion
benches (benches/bitpacking.rs, benches/delta.rs, benches/transpose.rs):

  * pack / unpack per (dtype, width) — ints/s and GB/s of raw bytes
  * unpack_single, all 1024 indices (benches/bitpacking.rs:49-63)
  * fused vs unfused delta decode (benches/delta.rs:10-44)
  * transpose/untranspose (benches/transpose.rs)
  * C++ host codec throughput for comparison

Writes JSON lines to benchmarks/results.jsonl (one record per config).
Usage: python benchmarks/sweep.py [--quick] [--out PATH]
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
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="benchmarks/results.jsonl")
    ap.add_argument("--blocks", type=int, default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.core import layout
    from fastlanes_tpu.ops import dispatch
    from fastlanes_tpu.kernels import codecs as pk
    from fastlanes_tpu.utils.testing import to_jax_form

    platform = jax.devices()[0].platform
    n_blocks = args.blocks or 16384
    n_ints = n_blocks * layout.BLOCK
    rng = np.random.default_rng(0)
    records = []

    # chained in-graph timing (the bench.py pattern): K iterations inside one
    # jit with a loop-carried data dependency, one scalar host fetch, so the
    # per-call dispatch does not distort per-op medians.
    K = 64

    def chained_time(fn, main, *rest, iters=5, consume=None):
        """Median seconds per op application; fn(main ^ carry, *rest).

        Every iteration's FULL output passes through
        jax.lax.optimization_barrier: XLA must materialize all elements (no
        DCE behind the scalar probe, no fusing the probe into the producer)
        — decode-to-memory throughput. (`consume` kept for signature
        compat; ignored.)"""
        @jax.jit
        def rep(x):
            def body(c, _):
                out = fn(jnp.bitwise_xor(x, c), *rest)
                out = jax.lax.optimization_barrier(out)
                flat = out.reshape(-1)
                np_dt = np.dtype(str(flat.dtype))
                top = np_dt.type(np.iinfo(np_dt).max)
                nc = jnp.where(flat[0] < top, 0, 1)
                return nc.astype(x.dtype), ()
            c, _ = jax.lax.scan(body, jnp.zeros((), x.dtype), None, length=K)
            return c
        _ = np.asarray(rep(main))  # compile + warm
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            _ = np.asarray(rep(main))
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) / K

    def emit(rec):
        rec.update(platform=platform, n_blocks=n_blocks)
        records.append(rec)
        print(json.dumps(rec), flush=True)

    dtypes = ["u32"] if args.quick else list(layout.DTYPES)
    for dt in dtypes:
        t = layout.bit_width(dt)
        widths = [3] if args.quick else sorted(
            {1, 2, 3, 4, 8, t // 2, t - 1, t} & set(range(1, t + 1)))
        elem_bytes = t // 8
        values_np = (rng.integers(0, 1 << min(widths[-1], t), (n_blocks, 1024),
                                  dtype=np.uint64).astype(layout.np_dtype(dt)))
        values = jnp.asarray(to_jax_form(values_np, dt))
        for w in widths:
            vals_w = jnp.asarray(to_jax_form(
                (values_np & layout.np_dtype(dt).type((1 << w) - 1 if w < t else ~np.uint64(0))),
                dt)) if w < t else values
            packf = dispatch.get("pack", dt, w)
            unpackf = dispatch.get("unpack", dt, w)
            packed = jax.block_until_ready(packf(vals_w))
            te = chained_time(packf, vals_w)
            td = chained_time(unpackf, packed)
            rec = {
                "bench": "bitpack", "dtype": dt, "width": w, "path": "xla_ops",
                "encode_ints_per_s": n_ints / te,
                "decode_ints_per_s": n_ints / td,
                "encode_GBps": n_ints * elem_bytes / te / 1e9,
                "decode_GBps": n_ints * elem_bytes / td / 1e9,
            }
            emit(rec)

        # unpack_single: all 1024 indices of every block at W=T//2
        w = t // 2
        packed = jax.block_until_ready(dispatch.get("pack", dt, w)(
            values if w == t else jnp.asarray(
            to_jax_form(values_np & layout.np_dtype(dt).type((1 << w) - 1), dt))))
        singlef = dispatch.get("unpack_single", dt, w)
        idx = jnp.arange(1024)
        ts = chained_time(singlef, packed, idx)
        emit({"bench": "unpack_single_all", "dtype": dt, "width": w,
              "ints_per_s": n_ints / ts})

        # transpose
        trf = dispatch.get("transpose", dt, 0)
        utf = dispatch.get("untranspose", dt, 0)
        emit({"bench": "transpose", "dtype": dt,
              "ints_per_s": n_ints / chained_time(trf, values)})
        emit({"bench": "untranspose", "dtype": dt,
              "ints_per_s": n_ints / chained_time(utf, values)})

    # fused vs unfused delta decode, u16 W=9 (benches/delta.rs:10-44)
    dt, w = "u16", 9
    values_np = np.sort(rng.integers(0, 1 << 12, (n_blocks, 1024), dtype=np.int64)
                        .astype(np.uint16), axis=1)
    base = jnp.zeros(64, jnp.uint16)
    tr = dispatch.get("transpose", dt, 0)
    dl = dispatch.get("delta", dt, 0)
    transposed = jax.block_until_ready(tr(jnp.asarray(values_np)))
    deltas = jax.block_until_ready(dl(transposed, base))
    packed = jax.block_until_ready(dispatch.get("pack", dt, w)(deltas))
    fusedf = dispatch.get("undelta_pack", dt, w)
    unpackf = dispatch.get("unpack", dt, w)
    undeltaf = dispatch.get("undelta", dt, 0)
    t_fused = chained_time(fusedf, packed, base)

    def unfused(p, b):
        return undeltaf(unpackf(p), b)

    t_unfused = chained_time(unfused, packed, base)
    emit({"bench": "delta_decode", "dtype": dt, "width": w,
          "fused_ints_per_s": n_ints / t_fused,
          "unfused_ints_per_s": n_ints / t_unfused,
          "fusion_speedup": t_unfused / t_fused})

    # the sorted-column FILE-READ decode: routed
    # original-order fused decode vs decode + standalone untranspose, and
    # the encode dual vs transpose-then-encode — per dtype at the column's
    # natural delta width
    from fastlanes_tpu import kernels as _k
    from fastlanes_tpu.ref import numpy_ref as _ref

    for dt in dtypes:
        t = layout.bit_width(dt)
        nl = layout.lanes(dt)
        np_dt = layout.np_dtype(dt)
        col = np.sort(rng.integers(0, 1 << min(t - 2, 62), (n_blocks, 1024),
                                   dtype=np.uint64).astype(np_dt), axis=1)
        trc = _ref.transpose(col, dt)
        base_c = np.ascontiguousarray(trc[:, :nl])
        deltas_c = _ref.delta(trc, base_c, dt)
        wd = int(deltas_c.max()).bit_length()
        packed_c = jnp.asarray(to_jax_form(_ref.pack(deltas_c, wd, dt), dt))
        base_j = jnp.asarray(to_jax_form(base_c, dt))
        col_j = jnp.asarray(to_jax_form(col, dt))
        t_orig = chained_time(
            lambda p, b, _w=wd, _dt=dt: _k.undelta_pack_orig(p, b, _w, _dt),
            packed_c, base_j)
        t_comp = chained_time(
            lambda p, b, _w=wd, _dt=dt: _k.undelta_pack_orig(
                p, b, _w, _dt, strategy="compose"), packed_c, base_j)
        t_enc = chained_time(
            lambda v, _w=wd, _dt=dt: _k.delta_pack_orig(v, _w, _dt)[0], col_j)
        t_enc_c = chained_time(
            lambda v, _w=wd, _dt=dt: _k.delta_pack_orig(
                v, _w, _dt, strategy="compose")[0], col_j)
        emit({"bench": "sorted_file_decode", "dtype": dt, "width": wd,
              "orig_routed_ints_per_s": n_ints / t_orig,
              "compose_ints_per_s": n_ints / t_comp,
              "encode_orig_ints_per_s": n_ints / t_enc,
              "encode_compose_ints_per_s": n_ints / t_enc_c})

    # C++ host codec (single-thread). Warm first + median of 5: a cold
    # one-shot call spends most of its time page-faulting the freshly
    # allocated numpy output (67 MB at this batch), not decoding — the
    # round-1 "0.78e9 u32 decode" was that artifact.
    try:
        from fastlanes_tpu import native

        if native.available():
            def med(fn, iters=5):
                fn()  # warm: faults pages, loads code
                times = []
                for _ in range(iters):
                    t0 = time.perf_counter()
                    fn()
                    times.append(time.perf_counter() - t0)
                return float(np.median(times))

            import ctypes

            lib = native._load()
            code = {"u8": 0, "u16": 1, "u32": 2, "u64": 3}
            for ndt in ("u16", "u32"):
                np_dt = np.uint16 if ndt == "u16" else np.uint32
                vals = rng.integers(0, 8, (n_blocks, 1024),
                                    dtype=np.int64).astype(np_dt)
                p = native.pack(vals, 3, ndt)
                pbuf = np.empty_like(p)
                # 64B-aligned output -> the r4 non-temporal store path
                # (regular stores pay read-for-ownership; decode is
                # write-bandwidth-bound on the host)
                obuf = native.aligned_empty(vals.shape, np_dt)
                te = med(lambda: native.pack(vals, 3, ndt, out=pbuf))
                td = med(lambda: native.unpack(p, 3, ndt, out=obuf))
                emit({"bench": "native_host", "dtype": ndt, "width": 3,
                      "encode_ints_per_s": n_ints / te,
                      "decode_ints_per_s": n_ints / td,
                      "nt_stores": True})
                # hot (cache-resident) decode, the reference's criterion
                # shape: one small batch decoded repeatedly, raw C call
                # (the Python wrapper costs ~20us/call — IO pipelines
                # amortize it over big batches; criterion-style loops
                # must not measure it)
                hb = 64
                hp = np.ascontiguousarray(p[:hb])
                ho = native.aligned_empty((hb, 1024), np_dt)
                pptr = hp.ctypes.data_as(ctypes.c_void_p)
                optr = ho.ctypes.data_as(ctypes.c_void_p)
                th = med(lambda: lib.fl_unpack(code[ndt], 3, pptr, optr, hb),
                         iters=200)
                emit({"bench": "native_host_hot", "dtype": ndt, "width": 3,
                      "blocks": hb,
                      "decode_ints_per_s": hb * 1024 / th})
    except Exception as e:
        emit({"bench": "native_host", "error": str(e)[:120]})

    with open(args.out, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    print(f"# wrote {len(records)} records to {args.out}")


if __name__ == "__main__":
    main()
