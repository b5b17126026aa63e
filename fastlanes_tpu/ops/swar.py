"""SWAR (SIMD-within-a-register) bitpack codecs for the sub-word dtypes.

The standard ops paths compute u8/u16 rows one value per vector element.
This module bitcasts the arrays to the uint32 domain (4 u8 / 2 u16 per lane,
little-endian) and runs the SAME FastLanes row formulas with byte-/halfword-
replicated mask constants — the hand-scheduled equivalent of the SIMD byte
ops LLVM auto-vectorizes the Rust reference into (reference
macros.rs:67-69, README.md:9-10).

Why the existing formulas survive the packing almost unchanged
(cross-sub-word leakage analysis):

  * unpack extract `(word >> s) & mask(cb)`: cb <= t - s, so the mask
    also kills every bit that leaked in from the neighbor sub-word.
  * unpack stitch `(next & mask(rem)) << cb`: rem + cb = W <= t, so the
    shifted value stays inside its sub-word.
  * pack accumulate `(src & mask(W)) << s`: s + W <= t for non-boundary
    rows; the BOUNDARY row masks to the `t - s` bits that fit first
    (in the scalar domain the overflow truncates for free — here it
    would leak into the neighbor).
  * pack carry `src >> (W - rem)`: masked to mask(rem) to kill the
    neighbor's low bits (scalar domain: nothing to kill).

Both dtypes map to 32 uint32 columns per packed word and per transposed
row, so the layout arithmetic is shared. Everything is pure jnp — XLA
fuses it like the ops path and runs on CPU for conformance tests.

It is not routed, and whether it beats the plain sub-word ops path on a
GPU has not been measured (ROADMAP C3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import layout

_SWAR_DTYPES = ("u8", "u16")
_COLS = 32  # uint32 columns per packed word AND per transposed row


def _check(dtype):
    dtype = layout.canon_dtype(dtype)
    if dtype not in _SWAR_DTYPES:
        raise ValueError(f"SWAR path packs u8/u16, got {dtype}")
    return dtype


def _repl(value: int, t: int) -> jnp.uint32:
    """Sub-word constant replicated across a uint32 lane."""
    factor = 0x01010101 if t == 8 else 0x00010001
    return jnp.uint32((value & ((1 << t) - 1)) * factor)


def _to_u32(arr, dtype):
    """(B, n) u8/u16 -> (B, n*t/32) uint32 (little-endian groups)."""
    t = layout.bit_width(dtype)
    group = 32 // t
    b, n = arr.shape
    return jax.lax.bitcast_convert_type(
        arr.reshape(b, n // group, group), jnp.uint32)


def _from_u32(arr, dtype, n_elems):
    t = layout.bit_width(dtype)
    group = 32 // t
    b = arr.shape[0]
    out = jax.lax.bitcast_convert_type(arr, layout.np_dtype(dtype))
    return out.reshape(b, n_elems)


def _mask_bits(width_bits: int, t: int) -> int:
    if width_bits >= t:
        return (1 << t) - 1
    return (1 << width_bits) - 1


def unpack(packed, width: int, dtype):
    """BitPacking::unpack for u8/u16 in the SWAR domain: (B, plen) ->
    (B, 1024), bit-exact with the oracle."""
    dtype = _check(dtype)
    t = layout.bit_width(dtype)
    layout.check_width(dtype, width)
    packed = jnp.asarray(packed)
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None]
    b = packed.shape[0]

    if width == 0:
        out = jnp.zeros((b, layout.BLOCK), layout.np_dtype(dtype))
        return out[0] if squeeze else out

    u = _to_u32(packed, dtype)
    get_word = lambda w: u[..., _COLS * w: _COLS * (w + 1)]  # noqa: E731

    rows = {}
    if width == t:
        for row in range(t):
            rows[row] = get_word(row)
    else:
        src = get_word(0)
        for row in range(t):
            curr_word = (row * width) // t
            next_word = ((row + 1) * width) // t
            shift = (row * width) % t
            if next_word > curr_word:
                remaining = ((row + 1) * width) % t
                current_bits = width - remaining
                tmp = (src >> shift) & _repl(_mask_bits(current_bits, t), t)
                if next_word < width:
                    src = get_word(next_word)
                    tmp = tmp | ((src & _repl(_mask_bits(remaining, t), t))
                                 << current_bits)
            else:
                tmp = (src >> shift) & _repl(_mask_bits(width, t), t)
            rows[row] = tmp

    # assemble in output-offset order (u32 units: element offset * t / 32)
    order = layout.row_order_by_offset(dtype)
    pieces = [rows[o * 8 + s] for s in range(8) for o in order]
    out = _from_u32(jnp.concatenate(pieces, axis=-1), dtype, layout.BLOCK)
    return out[0] if squeeze else out


def pack(values, width: int, dtype):
    """BitPacking::pack for u8/u16 in the SWAR domain: (B, 1024) ->
    (B, plen), byte-identical with the oracle."""
    dtype = _check(dtype)
    t = layout.bit_width(dtype)
    layout.check_width(dtype, width)
    values = jnp.asarray(values)
    squeeze = values.ndim == 1
    if squeeze:
        values = values[None]
    b = values.shape[0]

    if width == 0:
        out = jnp.zeros((b, 0), layout.np_dtype(dtype))
        return out[0] if squeeze else out

    v = _to_u32(values, dtype)
    group = 32 // t

    def row_fn(row):
        off = layout.row_offset(row) // group
        return v[..., off: off + _COLS]

    if width == t:
        words = [row_fn(row) for row in range(t)]
    else:
        mask_w = _repl((1 << width) - 1, t)
        words = []
        tmp = None
        for row in range(t):
            src = row_fn(row) & mask_w
            shift = (row * width) % t
            curr_word = (row * width) // t
            next_word = ((row + 1) * width) // t
            if next_word > curr_word:
                remaining = ((row + 1) * width) % t
                fits = t - shift  # bits of src that land in this word
                contrib = (src & _repl(_mask_bits(fits, t), t)) << shift
                tmp = contrib if tmp is None else tmp | contrib
                words.append(tmp)
                # carry the bits that did not fit; mask kills the
                # neighbor sub-word's low bits the shift drags in
                tmp = (src >> (width - remaining)) & _repl(
                    _mask_bits(remaining, t), t)
                if remaining == 0:
                    tmp = None
            else:
                contrib = src << shift
                tmp = contrib if tmp is None else tmp | contrib
        assert len(words) == width

    out = _from_u32(jnp.concatenate(words, axis=-1), dtype,
                    layout.packed_len(dtype, width))
    return out[0] if squeeze else out
