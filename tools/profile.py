#!/usr/bin/env python
"""Capture a JAX profiler (XPlane/Perfetto) trace of a codec op — the
tracing/observability counterpart of the reference's criterion+cargo-asm
workflow (SURVEY.md §5: the reference has no in-library tracing; this is the
JAX equivalent).

    python tools/profile.py unpack u32 3 [--blocks N] [--out DIR]

Writes a trace viewable with TensorBoard (`tensorboard --logdir DIR`) or
ui.perfetto.dev, and prints the per-op device timing summary from the
profiler's own data when available.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("op", choices=["pack", "unpack", "undelta_pack", "unfor_pack"])
    ap.add_argument("dtype")
    ap.add_argument("width", type=int)
    ap.add_argument("--blocks", type=int, default=16384)
    ap.add_argument("--path", choices=["ops", "kernels"], default="kernels")
    ap.add_argument("--out", default="traces/profile")
    ap.add_argument("--iters", type=int, default=16)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from fastlanes_tpu.core import layout
    from fastlanes_tpu.kernels import codecs as pk
    from fastlanes_tpu.ops import dispatch
    from fastlanes_tpu.ref import numpy_ref as ref

    dt = layout.canon_dtype(args.dtype)
    w = args.width
    rng = np.random.default_rng(0)
    values = rng.integers(0, 1 << min(w, 63), (args.blocks, layout.BLOCK),
                          np.uint64).astype(layout.np_dtype(dt))
    packed = np.ascontiguousarray(ref.pack(values, w, dt))
    nl = layout.lanes(dt)

    if dt == "u64":
        values = values.view(np.uint32).reshape(*values.shape, 2)
        packed = packed.view(np.uint32).reshape(*packed.shape, 2)

    decode = args.op in ("unpack", "undelta_pack", "unfor_pack")
    main_arg = jnp.asarray(packed if decode else values)
    extra = ()
    if args.op == "undelta_pack":
        extra = (jnp.zeros((nl, 2), jnp.uint32) if dt == "u64"
                 else jnp.zeros((nl,), layout.np_dtype(dt)),)
    elif args.op == "unfor_pack":
        extra = (0,)

    if args.path == "kernels":
        fns = {"pack": pk.pack, "unpack": pk.unpack,
               "undelta_pack": pk.undelta_pack, "unfor_pack": pk.unfor_pack}
        fn = jax.jit(lambda m, *e: fns[args.op](m, *e, w, dt))
    else:
        fn = dispatch.get(args.op, dt, w)

    out = fn(main_arg, *extra)  # compile outside the trace
    _ = np.asarray(out.reshape(-1)[0])

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out):
        o = None
        for _ in range(args.iters):
            o = fn(main_arg, *extra)
        _ = np.asarray(o.reshape(-1)[0])

    traces = glob.glob(os.path.join(args.out, "**", "*.xplane.pb"), recursive=True)
    print(f"trace written: {traces[-1] if traces else args.out}")
    print(f"view with: tensorboard --logdir {args.out}  (or ui.perfetto.dev)")


if __name__ == "__main__":
    main()
