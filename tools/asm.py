#!/usr/bin/env python
"""Inspect generated code for a codec config — the `cargo asm` recipe of the
reference (reference README.md:60-66) translated to the XLA stack.

    python tools/asm.py unpack u32 3              # stablehlo (lowered)
    python tools/asm.py unpack u32 3 --stage hlo  # optimized HLO (compiled)
    python tools/asm.py pack u16 9 --path kernels # the routed public entry
    python tools/asm.py undelta_pack u32 7 --stage cost

Stages: stablehlo (jax lowering), hlo (backend-optimized HLO — on the
device this shows what fused), cost (compiler cost analysis: flops/bytes
accessed). The reference inspects LLVM SIMD output to confirm
vectorization; here the analogous check is that the ops path lowers to one
fused loop (HLO) and a kernel to a single custom-call, plus the cost
analysis byte counts.
"""

from __future__ import annotations

import argparse
import sys


sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("op", choices=["pack", "unpack", "undelta_pack", "delta_pack",
                                   "for_pack", "unfor_pack", "transpose", "untranspose"])
    ap.add_argument("dtype")
    ap.add_argument("width", type=int)
    ap.add_argument("--path", choices=["ops", "kernels"], default="ops")
    ap.add_argument("--stage", choices=["stablehlo", "hlo", "cost"], default="stablehlo")
    ap.add_argument("--blocks", type=int, default=1024)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.core import layout
    from fastlanes_tpu.ops import dispatch
    from fastlanes_tpu.kernels import codecs as pk

    dt = layout.canon_dtype(args.dtype)
    w = args.width
    b = args.blocks
    plen = layout.packed_len(dt, w)
    nl = layout.lanes(dt)

    def arg_of(cols):
        if dt == "u64":
            return jnp.zeros((b, cols, 2), jnp.uint32)
        return jnp.zeros((b, cols), layout.np_dtype(dt))

    decode = args.op in ("unpack", "undelta_pack", "unfor_pack")
    main_arg = arg_of(plen if decode else layout.BLOCK)
    extra = ()
    if "delta" in args.op:
        extra = (jnp.zeros((nl, 2), jnp.uint32) if dt == "u64"
                 else jnp.zeros((nl,), layout.np_dtype(dt)),)
    elif "for" in args.op:
        extra = (0,)

    if args.path == "kernels":
        fns = {"pack": pk.pack, "unpack": pk.unpack, "undelta_pack": pk.undelta_pack,
               "delta_pack": pk.delta_pack, "for_pack": pk.for_pack,
               "unfor_pack": pk.unfor_pack}
        if args.op not in fns:
            raise SystemExit(f"{args.op} has no kernel path")
        fn = jax.jit(lambda m, *e: fns[args.op](m, *e, w, dt))
    else:
        fn = dispatch.get(args.op, dt, w)

    lowered = fn.lower(main_arg, *extra)
    if args.stage == "stablehlo":
        print(lowered.as_text())
        return
    compiled = lowered.compile()
    if args.stage == "hlo":
        print(compiled.as_text())
        return
    for ca in [compiled.cost_analysis()] if isinstance(compiled.cost_analysis(), dict) \
            else compiled.cost_analysis():
        for k in sorted(ca):
            if any(s in k for s in ("flops", "bytes", "utilization"))and not k.startswith("%"):
                print(f"{k:40s} {ca[k]}")


if __name__ == "__main__":
    main()
