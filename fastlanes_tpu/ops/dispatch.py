"""Runtime-width dispatch: the JAX equivalent of the reference's
`unchecked_pack` / `unchecked_unpack` width match tables
(reference src/bitpacking.rs:82-95, 115-128, 186-203).

The reference monomorphizes 4 types x (T+1) widths = 124 kernel variants at
compile time and dispatches on runtime width with a `seq_t!`-generated match.
Here each (op, dtype, width) pair is traced/compiled once by `jax.jit` and
cached; `precompile()` eagerly builds the full table for a given batch shape
(AOT-lowered, so first-use latency mirrors the Rust monomorphization)."""

from __future__ import annotations

import functools

import jax

from ..core import layout
from . import bitpack, delta as delta_mod, ffor, single, transpose as transpose_mod

_OPS = {
    "pack": lambda w, dt: lambda values: bitpack.pack(values, w, dt),
    "unpack": lambda w, dt: lambda packed: bitpack.unpack(packed, w, dt),
    "undelta_pack": lambda w, dt: lambda packed, base: delta_mod.undelta_pack(packed, base, w, dt),
    "delta_pack": lambda w, dt: lambda values, base: delta_mod.delta_pack(values, base, w, dt),
    "for_pack": lambda w, dt: lambda values, ref: ffor.for_pack(values, ref, w, dt),
    "unfor_pack": lambda w, dt: lambda packed, ref: ffor.unfor_pack(packed, ref, w, dt),
    "unpack_single": lambda w, dt: lambda packed, idx: single.unpack_single(packed, w, idx, dt),
    "delta": lambda w, dt: lambda values, base: delta_mod.delta(values, base, dt),
    "undelta": lambda w, dt: lambda values, base: delta_mod.undelta(values, base, dt),
    "transpose": lambda w, dt: lambda values: transpose_mod.transpose(values, dt),
    "untranspose": lambda w, dt: lambda values: transpose_mod.untranspose(values, dt),
}


def get(op: str, dtype: str, width: int):
    """Return the jitted kernel for (op, dtype, width). Cached — repeated
    runtime-width calls hit the same compiled executable, mirroring the
    reference's monomorphized match arms. The cache key is the canonical
    dtype, so 'u32' and 'uint32' share one entry."""
    return _get(op, layout.canon_dtype(dtype), width)


@functools.lru_cache(maxsize=None)
def _get(op: str, dtype: str, width: int):
    layout.check_width(dtype, width)
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; have {sorted(_OPS)}")
    return jax.jit(_OPS[op](width, dtype))


def unchecked_pack(width: int, values, dtype):
    """Runtime-width pack (reference bitpacking.rs:76-95; width is validated
    here, unlike the Rust release build's debug_assert)."""
    return get("pack", layout.canon_dtype(dtype), width)(values)


def unchecked_unpack(width: int, packed, dtype):
    """Runtime-width unpack (reference bitpacking.rs:109-128)."""
    return get("unpack", layout.canon_dtype(dtype), width)(packed)


def unchecked_unpack_single(width: int, packed, index, dtype):
    """Runtime-width unpack_single (reference bitpacking.rs:182-203)."""
    return get("unpack_single", layout.canon_dtype(dtype), width)(packed, index)


def precompile(ops=("pack", "unpack"), dtypes=layout.DTYPES, n_blocks=1024):
    """Eagerly trace+compile the full (op, dtype, width) table — the analogue
    of the reference's 124 monomorphized variants. Returns the variant count."""
    import jax.numpy as jnp
    import numpy as np

    count = 0
    for dt in dtypes:
        t = layout.bit_width(dt)
        if dt == "u64":
            vals = jnp.zeros((n_blocks, layout.BLOCK, 2), jnp.uint32)
        else:
            vals = jnp.zeros((n_blocks, layout.BLOCK), eng_dtype(dt))
        for w in range(t + 1):
            for op in ops:
                fn = get(op, dt, w)
                if op == "pack":
                    fn.lower(vals).compile()
                elif op == "unpack":
                    plen = layout.packed_len(dt, w)
                    shape = (n_blocks, plen, 2) if dt == "u64" else (n_blocks, plen)
                    pk = jnp.zeros(shape, jnp.uint32 if dt == "u64" else eng_dtype(dt))
                    fn.lower(pk).compile()
                count += 1
    return count


def eng_dtype(dt):
    from . import _engine

    return _engine.jnp_dtype(dt)
