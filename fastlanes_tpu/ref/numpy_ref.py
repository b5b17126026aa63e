"""NumPy oracle for the FastLanes codecs — slow-but-exact reference model.

Implements, bit-for-bit, the semantics of the Rust reference crate
(spiraldb/fastlanes v0.1.8):

  - pack / unpack           <- reference src/macros.rs:35-98 / 101-174,
                               driven per-lane as in src/bitpacking.rs:65-106
  - unpack_single           <- reference src/bitpacking.rs:131-179
  - delta / undelta / undelta_pack  <- reference src/delta.rs:24-63
  - for_pack / unfor_pack   <- reference src/ffor.rs:24-50
  - transpose / untranspose <- reference src/transpose.rs:11-22

All functions are vectorized over a leading batch-of-blocks axis: `values`
has shape (B, 1024), packed buffers have shape (B, 1024*W//T). The lane axis
and batch axis are both vectorized in NumPy; the row loop (T iterations) is
a Python loop exactly mirroring the reference's unrolled `seq_t!` row loop.

This module is the conformance oracle for the jnp ops and
the C++ host codec. It is NOT the fast path.
"""

from __future__ import annotations

import numpy as np

from ..core import layout
from ..core.layout import BLOCK


def _as_blocks(values, dtype) -> np.ndarray:
    dt = layout.np_dtype(dtype)
    arr = np.ascontiguousarray(values, dtype=dt)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2 or arr.shape[1] != BLOCK:
        raise ValueError(f"values must have shape (..., {BLOCK}), got {arr.shape}")
    return arr


def _rows(arr2d: np.ndarray, dtype):
    """Yield (row, (B, LANES) contiguous slice view) in transposed row order.

    D[b, row, lane] = arr2d[b, row_offset(row) + lane]  — see layout.py notes:
    each transposed row is a contiguous slice of the flat block.
    """
    nl = layout.lanes(dtype)
    for row in range(layout.bit_width(dtype)):
        off = layout.row_offset(row)
        yield row, arr2d[:, off:off + nl]


def pack(values, width: int, dtype=None) -> np.ndarray:
    """BitPacking::pack (reference bitpacking.rs:65-74 -> macros.rs:35-98)."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)
    b = v.shape[0]
    dt = layout.np_dtype(dtype)
    out = np.zeros((b, layout.packed_len(dtype, width)), dtype=dt)

    if width == 0:
        return out
    if width == t:
        # W == T: straight copy in row order, packed[LANES*row + lane] (macros.rs:54-59).
        for row, src in _rows(v, dtype):
            out[:, nl * row:nl * (row + 1)] = src
        return out

    mask = dt.type((1 << width) - 1)
    tmp = np.zeros((b, nl), dtype=dt)
    for row, src_full in _rows(v, dtype):
        src = src_full & mask
        shift = (row * width) % t
        if row == 0:
            tmp = src.copy()
        else:
            tmp |= src << dt.type(shift)
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        if next_word > curr_word:
            out[:, nl * curr_word:nl * (curr_word + 1)] = tmp
            remaining = ((row + 1) * width) % t
            # carry the bits that didn't fit (macros.rs:89-93); width-remaining < T.
            tmp = src >> dt.type(width - remaining)
    return out


def _mask_of(width_bits: int, t: int, dt) -> np.uint64:
    """mask(width) from macros.rs:141-143: full-width mask when width==T."""
    if width_bits == t:
        return dt.type(~dt.type(0))
    return dt.type((1 << (width_bits % t)) - 1)


def unpack_rows(packed, width: int, dtype):
    """Core of unpack: yields (row, (B, LANES) element array) in transposed row
    order — the vectorized analogue of the unpack! kernel-body hook
    (macros.rs:101-174), enabling fused consumers (delta, FoR)."""
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)
    dt = layout.np_dtype(dtype)
    p = np.ascontiguousarray(packed, dtype=dt)
    if p.ndim == 1:
        p = p[None, :]
    b = p.shape[0]
    plen = layout.packed_len(dtype, width)
    if p.shape[1] != plen:
        raise ValueError(
            f"packed must have shape (..., {plen}) for {dtype} W={width}, got {p.shape}")

    if width == 0:
        zero = np.zeros((b, nl), dtype=dt)
        for row in range(t):
            yield row, zero
        return
    if width == t:
        for row in range(t):
            yield row, p[:, nl * row:nl * (row + 1)]
        return

    src = p[:, 0:nl]
    for row in range(t):
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        shift = (row * width) % t
        if next_word > curr_word:
            remaining = ((row + 1) * width) % t
            current_bits = width - remaining
            tmp = (src >> dt.type(shift)) & _mask_of(current_bits, t, dt)
            if next_word < width:
                src = p[:, nl * next_word:nl * (next_word + 1)]
                tmp = tmp | ((src & _mask_of(remaining, t, dt)) << dt.type(current_bits))
        else:
            tmp = (src >> dt.type(shift)) & _mask_of(width, t, dt)
        yield row, tmp


def _assemble(rows_by_row, b: int, dtype) -> np.ndarray:
    """Scatter transposed rows back into flat (B, 1024) blocks via contiguous
    column slices (inverse of _rows)."""
    dt = layout.np_dtype(dtype)
    nl = layout.lanes(dtype)
    out = np.empty((b, BLOCK), dtype=dt)
    for row, elems in rows_by_row:
        off = layout.row_offset(row)
        out[:, off:off + nl] = elems
    return out


def unpack(packed, width: int, dtype) -> np.ndarray:
    """BitPacking::unpack (reference bitpacking.rs:98-106 -> macros.rs:101-174)."""
    p = np.asarray(packed)
    b = p.shape[0] if p.ndim == 2 else 1
    return _assemble(unpack_rows(packed, width, dtype), b, dtype)


def unpack_single(packed, width: int, index, dtype) -> np.ndarray:
    """BitPacking::unpack_single (reference bitpacking.rs:131-179). `index` may
    be a scalar or an array of indices; vectorized over both batch and index."""
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)
    dt = layout.np_dtype(dtype)
    p = np.ascontiguousarray(packed, dtype=dt)
    squeeze = p.ndim == 1
    if squeeze:
        p = p[None, :]
    idx = np.asarray(index)
    scalar_idx = idx.ndim == 0
    idx = np.atleast_1d(idx).astype(np.int64)
    if np.any((idx < 0) | (idx >= BLOCK)):
        raise IndexError("index must be in [0, 1024)")

    if width == 0:
        out = np.zeros((p.shape[0], idx.size), dtype=dt)
    else:
        lane = layout.lanes_by_index(dtype)[idx]
        row = layout.rows_by_index(dtype)[idx]
        if width == t:
            out = p[:, nl * row + lane]
        else:
            mask = _mask_of(width, t, dt)
            start_bit = row * width
            start_word = start_bit // t
            lo_shift = start_bit % t
            remaining_bits = t - lo_shift
            lo = p[:, nl * start_word + lane] >> lo_shift.astype(dt)
            need_hi = remaining_bits < width
            # hi word read is guarded (bitpacking.rs:171-178); clamp to stay in bounds.
            hi_word = np.minimum(nl * (start_word + 1) + lane, p.shape[1] - 1)
            hi = p[:, hi_word] << remaining_bits.astype(dt)
            out = np.where(need_hi, (lo | hi) & mask, lo & mask).astype(dt)
    if scalar_idx:
        out = out[:, 0]
    if squeeze:
        out = out[0]
    return out


def _check_base(base, dtype) -> np.ndarray:
    nl = layout.lanes(dtype)
    b = np.ascontiguousarray(base, dtype=layout.np_dtype(dtype))
    if b.ndim == 1:
        b = b[None, :]
    if b.shape[-1] != nl:
        raise ValueError(f"base must have {nl} per-lane seeds, got {b.shape}")
    return b


def delta(values, base, dtype=None) -> np.ndarray:
    """Delta::delta (reference delta.rs:24-33): per-lane running difference over
    *transposed-order* input, seeded by a per-lane base."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    base = _check_base(base, dtype)
    out_rows = []
    prev = np.broadcast_to(base, (v.shape[0], base.shape[-1]))
    for row, nxt in _rows(v, dtype):
        out_rows.append((row, nxt - prev))  # wrapping sub (numpy uint wraps)
        prev = nxt
    return _assemble(out_rows, v.shape[0], dtype)


def undelta(values, base, dtype=None) -> np.ndarray:
    """Delta::undelta (reference delta.rs:36-45): per-lane prefix sum."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    base = _check_base(base, dtype)
    out_rows = []
    prev = np.broadcast_to(base, (v.shape[0], base.shape[-1]))
    for row, d in _rows(v, dtype):
        prev = d + prev  # wrapping add
        out_rows.append((row, prev))
    return _assemble(out_rows, v.shape[0], dtype)


def undelta_pack(packed, base, width: int, dtype) -> np.ndarray:
    """Fused Delta::undelta_pack (reference delta.rs:48-63): prefix-sum inside
    the unpack row stream — the flagship fusion the layout exists for."""
    dtype = layout.canon_dtype(dtype)
    base = _check_base(base, dtype)
    p = np.asarray(packed)
    b = p.shape[0] if p.ndim == 2 else 1
    prev = np.broadcast_to(base, (b, base.shape[-1]))
    out_rows = []
    for row, elem in unpack_rows(packed, width, dtype):
        prev = elem + prev
        out_rows.append((row, prev))
    return _assemble(out_rows, b, dtype)


def delta_pack(values, base, width: int, dtype=None) -> np.ndarray:
    """Fused encode counterpart: pack(delta(values, base)) in one pass.

    Not a public function of the reference crate (callers compose, see
    delta.rs:80-96), provided here because the fused encoder is a natural
    framework entry point.
    """
    return pack(delta(values, base, dtype), width, dtype)


def for_pack(values, reference, width: int, dtype=None) -> np.ndarray:
    """FoR::for_pack (reference ffor.rs:24-36): pack(v - reference) fused."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    ref = layout.np_dtype(dtype).type(reference)
    return pack(v - ref, width, dtype)


def unfor_pack(packed, reference, width: int, dtype) -> np.ndarray:
    """FoR::unfor_pack (reference ffor.rs:38-50): unpack + wrapping_add(reference)."""
    dtype = layout.canon_dtype(dtype)
    ref = layout.np_dtype(dtype).type(reference)
    p = np.asarray(packed)
    b = p.shape[0] if p.ndim == 2 else 1
    rows = ((row, elem + ref) for row, elem in unpack_rows(packed, width, dtype))
    return _assemble(rows, b, dtype)


def transpose(values, dtype=None) -> np.ndarray:
    """Transpose::transpose (reference transpose.rs:11-15): out[i] = in[t(i)]."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    return v[:, layout.transpose_perm()]


def untranspose(values, dtype=None) -> np.ndarray:
    """Transpose::untranspose (reference transpose.rs:18-22): out[t(i)] = in[i]."""
    dtype = layout.canon_dtype(dtype if dtype is not None else np.asarray(values).dtype)
    v = _as_blocks(values, dtype)
    return v[:, layout.untranspose_perm()]
