"""Dtype engine: uniform integer vector ops over native jnp ints and u64 limbs.

u64 blocks are processed as 2x32-bit limb pairs, so no path needs JAX's
process-global x64 mode (SURVEY.md §7 hard part (a)). This module gives the
jnp ops one shared vocabulary:

  * a "vec" is either a jnp array (u8/u16/u32 native) or an (lo, hi) tuple of
    uint32 arrays (u64);
  * all shift amounts and masks are trace-time Python constants (the row loop
    is statically unrolled exactly like the reference's `seq_t!`), except the
    *_dyn variants used by unpack_single where shifts are data.

Semantics mirror Rust wrapping/unsigned ops: shifts are always called with
0 <= k < T (guaranteed by the pack/unpack loop structure, see
reference src/macros.rs:74-93 / 142-165), wrapping add/sub mod 2^T.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core import layout

_JNP_DTYPE = {"u8": jnp.uint8, "u16": jnp.uint16, "u32": jnp.uint32}


def is_limb(dtype) -> bool:
    return layout.canon_dtype(dtype) == "u64"


def jnp_dtype(dtype):
    return _JNP_DTYPE[layout.canon_dtype(dtype)]


# ---------------------------------------------------------------------------
# boundary conversion: user array <-> vec


def to_vec(arr, dtype):
    """Convert a user-facing array into the engine representation.

    u8/u16/u32: pass through (cast-checked). u64: accepts uint64 arrays (when
    jax x64 is enabled), or uint32 arrays with a trailing limb axis of 2
    (little-endian lo, hi) — the exact byte image of the u64 buffer.
    """
    dtype = layout.canon_dtype(dtype)
    if dtype != "u64":
        arr = jnp.asarray(arr)
        want = jnp_dtype(dtype)
        if arr.dtype != want:
            raise ValueError(f"expected {want} array for dtype {dtype}, got {arr.dtype}")
        return arr
    if isinstance(arr, tuple) or type(arr).__name__ == "LimbPlanes":
        # separate-plane form: (lo, hi) tuple or a limbs.LimbPlanes — the
        # fast path that never materializes the interleaved image
        lo, hi = (arr.lo, arr.hi) if not isinstance(arr, tuple) else arr
        lo, hi = jnp.asarray(lo), jnp.asarray(hi)
        if lo.dtype != jnp.uint32 or hi.dtype != jnp.uint32:
            raise ValueError("u64 limb planes must be uint32")
        return lo, hi
    arr = jnp.asarray(arr)
    if arr.dtype == jnp.uint32:
        if arr.shape[-1] != 2:
            raise ValueError("u64 limb arrays must have trailing axis 2 (lo, hi)")
        return arr[..., 0], arr[..., 1]
    if str(arr.dtype) == "uint64":
        limbs = jax.lax.bitcast_convert_type(arr, jnp.uint32)  # (..., 2), LE
        return limbs[..., 0], limbs[..., 1]
    raise ValueError(f"u64 values must be uint64 or uint32 limb pairs, got {arr.dtype}")


def promote_shape(vec, dtype):
    """Ensure a leading batch axis; returns (vec2d, had_batch)."""
    if is_limb(dtype):
        lo, hi = vec
        if lo.ndim == 1:
            return (lo[None], hi[None]), False
        return vec, True
    if vec.ndim == 1:
        return vec[None], False
    return vec, True


def squeeze_shape(vec, had_batch, dtype):
    if had_batch:
        return vec
    if is_limb(dtype):
        return vec[0][0], vec[1][0]
    return vec[0]


def from_vec(vec, dtype, like=None):
    """Convert engine repr back to user-facing form. For u64, returns uint64
    if `like` was uint64, else the (..., 2) uint32 limb image."""
    dtype = layout.canon_dtype(dtype)
    if dtype != "u64":
        return vec
    lo, hi = vec
    limbs = jnp.stack([lo, hi], axis=-1)
    if isinstance(like, tuple) or type(like).__name__ == "LimbPlanes":
        like = None  # plane-form input has no uint64-array convention
    if like is not None and str(jnp.asarray(like).dtype) == "uint64":
        return jax.lax.bitcast_convert_type(limbs, jnp.uint64)
    return limbs


# ---------------------------------------------------------------------------
# static-constant ops (k, mask are Python ints known at trace time)


def zeros(shape, dtype):
    if is_limb(dtype):
        z = jnp.zeros(shape, jnp.uint32)
        return z, z
    return jnp.zeros(shape, jnp_dtype(dtype))


def const(value: int, shape, dtype):
    if is_limb(dtype):
        return (jnp.full(shape, value & 0xFFFFFFFF, jnp.uint32),
                jnp.full(shape, (value >> 32) & 0xFFFFFFFF, jnp.uint32))
    return jnp.full(shape, value, jnp_dtype(dtype))


def shl(x, k: int, dtype):
    """x << k, 0 <= k < T."""
    if k == 0:
        return x
    if is_limb(dtype):
        lo, hi = x
        if k < 32:
            return lo << k, (hi << k) | (lo >> (32 - k))
        return jnp.zeros_like(lo), lo << (k - 32)
    return x << k


def shr(x, k: int, dtype):
    """x >> k (logical), 0 <= k < T."""
    if k == 0:
        return x
    if is_limb(dtype):
        lo, hi = x
        if k < 32:
            return (lo >> k) | (hi << (32 - k)), hi >> k
        return hi >> (k - 32), jnp.zeros_like(hi)
    return x >> k


def orr(x, y, dtype):
    if is_limb(dtype):
        return x[0] | y[0], x[1] | y[1]
    return x | y


def and_const(x, mask: int, dtype):
    if is_limb(dtype):
        lo, hi = x
        # numpy scalars: Python ints >= 2^31 overflow JAX's weak int32
        return (lo & np.uint32(mask & 0xFFFFFFFF),
                hi & np.uint32((mask >> 32) & 0xFFFFFFFF))
    return x & np.asarray(mask, layout.np_dtype(dtype))[()]


def add(x, y, dtype):
    """Wrapping add mod 2^T."""
    if is_limb(dtype):
        lo = x[0] + y[0]
        carry = (lo < x[0]).astype(jnp.uint32)
        return lo, x[1] + y[1] + carry
    return x + y


def sub(x, y, dtype):
    """Wrapping sub mod 2^T."""
    if is_limb(dtype):
        lo = x[0] - y[0]
        borrow = (x[0] < y[0]).astype(jnp.uint32)
        return lo, x[1] - y[1] - borrow
    return x - y


# ---------------------------------------------------------------------------
# column slicing on the last axis (works for (B, N) and (N,) arrays)


def cols(x, start: int, n: int, dtype):
    if is_limb(dtype):
        return x[0][..., start:start + n], x[1][..., start:start + n]
    return x[..., start:start + n]


def concat_cols(pieces, dtype):
    if is_limb(dtype):
        return (jnp.concatenate([p[0] for p in pieces], axis=-1),
                jnp.concatenate([p[1] for p in pieces], axis=-1))
    return jnp.concatenate(pieces, axis=-1)


def take_cols(x, idx, dtype):
    """Gather columns by (possibly traced) integer index array."""
    if is_limb(dtype):
        return (jnp.take(x[0], idx, axis=-1), jnp.take(x[1], idx, axis=-1))
    return jnp.take(x, idx, axis=-1)


# ---------------------------------------------------------------------------
# dynamic-shift ops (k is a traced int32 array; used by unpack_single)


def _safe_shl32(x, k):
    """x << k for uint32 x with traced k in [0, 32]; returns 0 when k >= 32."""
    kc = jnp.minimum(k, 31).astype(jnp.uint32)
    return jnp.where(k >= 32, jnp.uint32(0), x << kc)


def _safe_shr32(x, k):
    kc = jnp.minimum(k, 31).astype(jnp.uint32)
    return jnp.where(k >= 32, jnp.uint32(0), x >> kc)


def shr_dyn(x, k, dtype):
    """Logical right shift by traced amount k in [0, T)."""
    if is_limb(dtype):
        lo, hi = x
        lo_small = _safe_shr32(lo, k) | _safe_shl32(hi, 32 - k)
        hi_small = _safe_shr32(hi, k)
        lo_big = _safe_shr32(hi, k - 32)
        return (jnp.where(k < 32, lo_small, lo_big),
                jnp.where(k < 32, hi_small, jnp.zeros_like(hi)))
    t = layout.bit_width(dtype)
    kc = jnp.minimum(k, t - 1).astype(x.dtype)
    return jnp.where(k >= t, jnp.zeros_like(x), x >> kc)


def shl_dyn(x, k, dtype):
    """Left shift by traced amount k in [0, T]; returns 0 when k >= T."""
    if is_limb(dtype):
        lo, hi = x
        lo_small = _safe_shl32(lo, k)
        hi_small = _safe_shl32(hi, k) | _safe_shr32(lo, 32 - k)
        hi_big = _safe_shl32(lo, k - 32)
        return (jnp.where(k < 32, lo_small, jnp.zeros_like(lo)),
                jnp.where(k < 32, hi_small, hi_big))
    t = layout.bit_width(dtype)
    kc = jnp.minimum(k, t - 1).astype(x.dtype)
    return jnp.where(k >= t, jnp.zeros_like(x), x << kc)


def where(cond, x, y, dtype):
    if is_limb(dtype):
        return jnp.where(cond, x[0], y[0]), jnp.where(cond, x[1], y[1])
    return jnp.where(cond, x, y)
