#!/usr/bin/env python
"""Race the competing formulations of each (op, dtype, width) on the GPU
this runs on and write the routing table for that device kind
(fastlanes_tpu.kernels.routing.table_path(device_kind)), which the public
entries then consult on that kind of device only.

Fair harness (every path identical): K iterations inside one jit via
lax.scan with a data dependency between iterations; each iteration's FULL
output passes through jax.lax.optimization_barrier, so XLA must materialize
every element (no DCE behind a scalar probe, no fusing the probe into the
producer) exactly like an opaque kernel must; then one element feeds the
carry. One scalar host fetch per repetition (benchmarks/NOTES.md).

Usage:
    python tools/tune_routing.py                  # full measure, write table
    python tools/tune_routing.py --quick          # u32 W=T relayouts only
    python tools/tune_routing.py --dry            # print configs, no device
    ... [--blocks N] [--out PATH] [--no-merge]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# widths measured per op; unmeasured widths route via nearest-width
WIDTHS = {8: [1, 3, 4, 8], 16: [1, 3, 8, 16], 32: [1, 3, 8, 16, 32],
          64: [1, 3, 16, 32, 64]}


def build_configs(quick: bool):
    from fastlanes_tpu.core import layout

    configs = []
    dtypes = ["u32"] if quick else list(layout.DTYPES)
    for dt in dtypes:
        t = layout.bit_width(dt)
        configs.append(("unpack_wt", dt, t))  # W=T relayout strategy races
        configs.append(("pack_wt", dt, t))
        if quick:
            continue
        for w in WIDTHS[t]:
            for op in ("unpack_orig", "undelta_pack_orig",
                       "unzdelta_pack_orig", "delta_pack_orig_enc",
                       "zdelta_pack_orig_enc"):
                configs.append((op, dt, w))
            configs.append(("unpack_single", dt, w))
    if not quick:
        # dtype-independent standalone relayouts (one entry each, u32:0)
        configs.append(("transpose_st", "u32", 0))
        configs.append(("untranspose_st", "u32", 0))
    return configs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dry", action="store_true")
    ap.add_argument("--blocks", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="table file (default: the running device kind's)")
    ap.add_argument("--no-merge", action="store_true",
                    help="start from an empty table instead of merging")
    ap.add_argument("--only-missing", action="store_true",
                    help="measure only configs absent from the existing table")
    ap.add_argument("--k", type=int, default=None, help="chain length")
    ap.add_argument("--ops", default=None,
                    help="comma-separated op names to measure (filter)")
    ap.add_argument("--dtypes", default=None,
                    help="comma-separated dtypes to measure (filter)")
    ap.add_argument("--strategies", default=None,
                    help="comma-separated strategy names: for *_orig "
                         "entries, measure only these and merge into the "
                         "existing same-scale entry")
    ap.add_argument("--widths", default=None,
                    help="comma-separated widths: measure exactly these "
                         "widths (clamped to <=T) for every selected "
                         "(op, dtype) instead of the default lists; "
                         "wt/st entries keep their fixed widths")
    args = ap.parse_args()

    configs = build_configs(args.quick)
    if args.ops:
        keep = set(args.ops.split(","))
        configs = [c for c in configs if c[0] in keep]
    if args.dtypes:
        keep_dt = set(args.dtypes.split(","))
        configs = [c for c in configs if c[1] in keep_dt]
    if args.widths:
        from fastlanes_tpu.core import layout as _layout

        widths = sorted({int(w) for w in args.widths.split(",")})
        fixed = {"unpack_wt", "pack_wt", "transpose_st", "untranspose_st"}
        pairs, seen, rebuilt = [], set(), []
        for op, dt, w in configs:
            if op in fixed:
                rebuilt.append((op, dt, w))
            elif (op, dt) not in seen:
                seen.add((op, dt))
                pairs.append((op, dt))
        for op, dt in pairs:
            t = _layout.bit_width(dt)
            rebuilt.extend((op, dt, w) for w in widths if 1 <= w <= t)
        configs = rebuilt
    if args.dry:
        for c in configs:
            print(":".join(map(str, c)))
        print(f"# {len(configs)} configs")
        return

    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.core import layout
    from fastlanes_tpu.kernels import codecs as pk
    from fastlanes_tpu.kernels import routing
    from fastlanes_tpu.ops import bitpack as ops_bitpack
    from fastlanes_tpu.ref import numpy_ref as ref
    from fastlanes_tpu.utils import runtime
    from fastlanes_tpu.utils.testing import to_jax_form

    runtime.configure_compile_cache()
    runtime.require_gpu(jax.devices())
    kind = jax.devices()[0].device_kind
    out_path = args.out or routing.table_path(kind)
    n_blocks = args.blocks or 16384
    n_ints = n_blocks * layout.BLOCK
    K = args.k or 64
    rng = np.random.default_rng(0)

    def chained(fn, main, *rest, iters=5):
        """Median s/op; identical materialize-everything harness."""
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

    def make_inputs(op, dt, w):
        """Returns (main_input, rest_inputs) for both paths. Arrays are
        materialized ON DEVICE (jnp.asarray + block) — passing host numpy
        into the jitted chain would re-transfer it every repetition and
        measure PCIe, not the codec."""
        t = layout.bit_width(dt)
        nl = layout.lanes(dt)
        np_dt = layout.np_dtype(dt)
        hi = 1 << min(max(w, 1), t)
        values = rng.integers(0, hi, (n_blocks, 1024), dtype=np.uint64).astype(np_dt)
        if op in ("pack", "delta_pack", "for_pack",
                  "delta_pack_orig_enc", "zdelta_pack_orig_enc"):
            main = values
        else:
            main = ref.pack(values, w, dt)
        main = jax.block_until_ready(jnp.asarray(to_jax_form(main, dt)))
        if op in ("undelta_pack", "unzdelta_pack", "delta_pack",
                  "undelta_pack_orig", "unzdelta_pack_orig"):
            base = np.ascontiguousarray(ref.transpose(values, dt)[:, :nl])
            return main, (jax.block_until_ready(jnp.asarray(to_jax_form(base, dt))),)
        if op in ("for_pack", "unfor_pack"):
            return main, (int(values.min()),)
        return main, ()

    entries = {}
    if not args.no_merge:
        try:
            with open(out_path) as f:
                entries = json.load(f)["entries"]
        except (OSError, KeyError, json.JSONDecodeError):
            pass
    if args.only_missing:
        configs = [(op, dt, w) for op, dt, w in configs
                   if f"{op}:{dt}:{w}" not in entries]
        print(f"# {len(configs)} configs to measure", file=sys.stderr)

    from fastlanes_tpu.ops import orig as ops_orig

    def _dec_orig(entry):
        # all strategies of the *_orig decode entries: od select-chain,
        # gat/rep flat one-pass forms, compose = transposed decode +
        # standalone untranspose
        return {s: (lambda *a, _s=s, _e=entry: _e(*a, strategy=_s))
                for s in ("od", "gat", "rep", "compose")}

    orig_fns = {
        "delta_pack_orig_enc": {
            "od": lambda v, w, dt: ops_orig.delta_pack_orig(v, w, dt)[0],
            "compose": lambda v, w, dt: pk.delta_pack_orig(
                v, w, dt, strategy="compose")[0],
        },
        "zdelta_pack_orig_enc": {
            "od": lambda v, w, dt: ops_orig.delta_pack_orig(
                v, w, dt, zigzag=True)[0],
            "compose": lambda v, w, dt: pk.delta_pack_orig(
                v, w, dt, zigzag=True, strategy="compose")[0],
        },
        "unpack_orig": _dec_orig(
            lambda p, w, dt, strategy: pk.unpack_orig(p, w, dt,
                                                      strategy=strategy)),
        "undelta_pack_orig": _dec_orig(
            lambda p, b, w, dt, strategy: pk.undelta_pack_orig(
                p, b, w, dt, strategy=strategy)),
        "unzdelta_pack_orig": _dec_orig(
            lambda p, b, w, dt, strategy: pk.unzdelta_pack_orig(
                p, b, w, dt, strategy=strategy)),
    }

    def _flush():
        """Write the table after EVERY entry — a crash mid-run must not
        lose the measurements already taken."""
        doc = {
            "device_kind": kind,
            "source": f"tools/tune_routing.py, {n_blocks} blocks, K={K}, "
                      "optimization_barrier materialized harness",
            "entries": {k: entries[k] for k in sorted(entries)},
        }
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)

    for op, dt, w in configs:
        key = f"{op}:{dt}:{w}"
        _WT_BASE = {"unpack_wt": "unpack", "pack_wt": "pack"}
        main, rest = make_inputs(
            "pack" if op in ("transpose_st", "untranspose_st")
            else _WT_BASE.get(op, op), dt, max(w, 1) if not w else w)
        rec = {}
        if op in ("transpose_st", "untranspose_st"):
            from fastlanes_tpu.kernels import routing as _routing
            from fastlanes_tpu.ops import transpose as _tr

            base_fn = (_tr.transpose if op == "transpose_st"
                       else _tr.untranspose)
            for strat in ("permute", "gather", "axes"):
                try:
                    _routing.set_table({key: {strat: 1.0}})
                    _tr._st_strategy.cache_clear()
                    t_s = chained(
                        lambda x, _dt=dt, _f=base_fn: _f(x, _dt), main)
                    rec[strat] = round(n_ints / t_s, 1)
                except Exception as e:  # pragma: no cover
                    print(f"# {key} {strat} failed: {str(e)[:100]}",
                          file=sys.stderr)
                finally:
                    _routing.set_table(None)
                    _tr._st_strategy.cache_clear()
            if rec:
                rec["blocks"] = n_blocks
                entries[key] = rec
                _flush()
                print(json.dumps({key: rec}), flush=True)
            continue
        if op in _WT_BASE:
            # race the W=T relayout strategies through the public ops entry
            # (forced via a table override; ops/bitpack._unpack_wt/_pack_wt)
            from fastlanes_tpu.kernels import routing as _routing
            base_fn = (ops_bitpack.unpack if op == "unpack_wt"
                       else ops_bitpack.pack)
            caches = (ops_bitpack._wt_strategy, ops_bitpack._pack_wt_strategy)
            for strat in ("assemble", "gather", "grouptake", "bitrev"):
                try:
                    _routing.set_table({key: {strat: 1.0}})
                    for c in caches:
                        c.cache_clear()
                    t_s = chained(
                        lambda x, _w=w, _dt=dt, _f=base_fn: _f(x, _w, _dt),
                        main)
                    rec[strat] = round(n_ints / t_s, 1)
                except Exception as e:  # pragma: no cover
                    print(f"# {key} {strat} failed: {str(e)[:100]}",
                          file=sys.stderr)
                finally:
                    _routing.set_table(None)
                    for c in caches:
                        c.cache_clear()
            if rec:
                rec["blocks"] = n_blocks
                entries[key] = rec
                _flush()
                print(json.dumps({key: rec}), flush=True)
            continue
        if op == "unpack_single":
            # dense random access (all 1024 indices, the reference bench
            # shape benches/bitpacking.rs:49-63): 2-word gather vs routed
            # full decode + one gather (ops/single.py)
            from fastlanes_tpu.kernels import routing as _routing
            from fastlanes_tpu.ops import single as _single

            idx_all = jnp.arange(1024, dtype=jnp.int32)
            for strat in ("gather", "decode"):
                try:
                    _routing.set_table({key: {strat: 1.0}})
                    _single._single_strategy.cache_clear()
                    t_s = chained(
                        lambda x, _w=w, _dt=dt: _single.unpack_single(
                            x, _w, idx_all, _dt), main)
                    rec[strat] = round(n_ints / t_s, 1)
                except Exception as e:  # pragma: no cover
                    print(f"# {key} {strat} failed: {str(e)[:100]}",
                          file=sys.stderr)
                finally:
                    _routing.set_table(None)
                    _single._single_strategy.cache_clear()
            if rec:
                rec["blocks"] = n_blocks
                rec["k"] = 1024
                entries[key] = rec
                _flush()
                print(json.dumps({key: rec}), flush=True)
            continue
        if op in orig_fns:
            strat_items = orig_fns[op].items()
            if args.strategies:
                keep_s = set(args.strategies.split(","))
                strat_items = [(s, f) for s, f in strat_items if s in keep_s]
                # strategy-filtered runs MERGE into the existing entry
                # (same measurement scale only — mixing block counts would
                # compare numbers from different regimes)
                prior = entries.get(key, {})
                if prior.get("blocks") == n_blocks:
                    rec.update(prior)
            for strat, fn in strat_items:
                try:
                    t_s = chained(
                        lambda x, *r, _fn=fn, _w=w, _dt=dt: _fn(x, *r, _w, _dt),
                        main, *rest)
                    rec[strat] = round(n_ints / t_s, 1)
                except Exception as e:  # pragma: no cover
                    print(f"# {key} {strat} failed: {str(e)[:100]}",
                          file=sys.stderr)
            if rec:
                rec["blocks"] = n_blocks  # per-entry provenance (metadata
                entries[key] = rec        # keys are ignored by routing)
                _flush()
                print(json.dumps({key: rec}), flush=True)
    _flush()
    print(f"# wrote {len(entries)} entries to {out_path}")


if __name__ == "__main__":
    main()
