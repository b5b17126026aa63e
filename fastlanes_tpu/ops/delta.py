"""jnp Delta codec: per-lane running delta over transposed blocks + the fused
undelta_pack decoder (reference src/delta.rs:24-63).

The per-lane sequential dependency of the reference (`prev` carried across
the T rows of a lane) is preserved, but the lane axis and block axis are the
vector dimensions, so LANES x B prefix sums run data-parallel — the same
structure the Rust crate relies on for SIMD (delta.rs:55-60)."""

from __future__ import annotations

from ..core import layout
from . import _engine as eng
from .bitpack import assemble_blocks, block_rows, pack_words, unpack_row_stream, _row_fn_of


def _base_vec(base, dtype, batch_like):
    """base: per-lane seeds (LANES,) or (B, LANES) (reference delta.rs:7)."""
    vec = eng.to_vec(base, dtype)
    return vec


def delta(values, base, dtype):
    """Delta::delta (delta.rs:24-33): out[idx] = next - prev, wrapping."""
    dtype = layout.canon_dtype(dtype)
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    prev = _base_vec(base, dtype, vec)
    rows = {}
    for row, nxt in block_rows(vec, dtype):
        rows[row] = eng.sub(nxt, prev, dtype)
        prev = nxt
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch, dtype)
    return eng.from_vec(out, dtype, like=values)


def undelta(deltas, base, dtype, *, planes: bool = False):
    """Delta::undelta (delta.rs:36-45): per-lane prefix sum from base.
    planes=True (u64 only): separate (lo, hi) uint32 planes out."""
    from .bitpack import _check_planes

    dtype = layout.canon_dtype(dtype)
    _check_planes(planes, dtype)
    vec = eng.to_vec(deltas, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    prev = _base_vec(base, dtype, vec)
    rows = {}
    for row, d in block_rows(vec, dtype):
        prev = eng.add(d, prev, dtype)
        rows[row] = prev
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch, dtype)
    if planes:
        return out
    return eng.from_vec(out, dtype, like=deltas)


def undelta_pack(packed, base, width: int, dtype, *, planes: bool = False):
    """Fused Delta::undelta_pack (delta.rs:48-63): prefix-sum inside the
    unpack row stream — one pass, the flagship fusion of the layout.
    planes=True (u64 only): separate (lo, hi) uint32 planes out."""
    from .bitpack import _check_planes

    dtype = layout.canon_dtype(dtype)
    _check_planes(planes, dtype)
    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    prev = _base_vec(base, dtype, vec)
    rows = {}
    for row, elem in unpack_row_stream(vec, width, dtype):
        prev = eng.add(elem, prev, dtype)
        rows[row] = prev
    out = eng.squeeze_shape(assemble_blocks(rows, dtype), had_batch, dtype)
    if planes:
        return out
    return eng.from_vec(out, dtype, like=packed)


def unzdelta_pack(packed, base, width: int, dtype, *, planes: bool = False):
    """Fused zdelta decode: unpack -> unzigzag -> per-lane prefix sum.
    planes=True (u64 only): separate (lo, hi) uint32 planes out."""
    import jax
    import jax.numpy as jnp

    from .. import transforms
    from .bitpack import _check_planes, unpack

    dtype = layout.canon_dtype(dtype)
    _check_planes(planes, dtype)
    if eng.is_limb(dtype):
        zlo, zhi = unpack(packed, width, dtype, planes=True)
        deltas = transforms.zigzag_decode_limb(zlo, zhi)
        out = undelta(deltas, base, dtype, planes=True)
        return out if planes else eng.from_vec(out, dtype, like=packed)
    t = layout.bit_width(dtype)
    deltas = jax.lax.bitcast_convert_type(
        transforms.zigzag_decode(jnp.asarray(unpack(packed, width, dtype))),
        jnp.dtype(f"uint{t}"))
    return undelta(deltas, base, dtype)


def delta_pack(values, base, width: int, dtype):
    """Fused encode: pack(delta(values, base)) in one pass (composition the
    reference leaves to callers, delta.rs:80-96)."""
    dtype = layout.canon_dtype(dtype)
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    prev_holder = [_base_vec(base, dtype, vec)]
    row_src = _row_fn_of(vec, dtype)

    def row_fn(row):
        nxt = row_src(row)
        out = eng.sub(nxt, prev_holder[0], dtype)
        prev_holder[0] = nxt
        return out

    words = pack_words(row_fn, width, dtype, None)
    if not words:
        b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
        out = eng.zeros((b, 0), dtype)
    else:
        out = eng.concat_cols(words, dtype)
    out = eng.squeeze_shape(out, had_batch, dtype)
    return eng.from_vec(out, dtype, like=values)
