"""jnp unpack_single: O(1) random access into packed blocks via the
compile-time inverse index tables (reference src/bitpacking.rs:131-232).

On the device this is a gather: per queried index we read at most two
packed words per block (lo/hi stitch, bitpacking.rs:164-178). Vectorized
over both the batch-of-blocks axis and the index axis, so `unpack_single`
doubles as a batched `take` for packed columns.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp

from ..core import layout
from . import _engine as eng

#: below this many queried indices the two-word gather always wins (full
#: decode does 1024 elements of work regardless of K); at/above it the
#: measured routing entry "unpack_single" decides (tools/tune_routing.py
#: races both at the reference bench shape, all 1024 indices —
#: benches/bitpacking.rs:49-63).
_DECODE_MIN_K = 256


@functools.lru_cache(maxsize=None)
def _single_strategy(dtype, width) -> str:
    from ..kernels import routing

    strat = routing.best_path("unpack_single", dtype, width)
    return strat if strat in ("gather", "decode") else "gather"


def unpack_single(packed, width: int, index, dtype):
    """Gather elements `index` (scalar or int array) from packed blocks.

    packed: (B, plen) native dtype (u64: (..., plen, 2) uint32 limbs).
    index:  () or (K,) integers in [0, 1024); may be traced.
    Returns (B, K) (or squeezed shapes matching the inputs).
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)

    idx = jnp.asarray(index)
    scalar_idx = idx.ndim == 0
    idx = jnp.atleast_1d(idx).astype(jnp.int32)

    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    bshape = (vec[0] if eng.is_limb(dtype) else vec).shape[0]

    if width == 0:
        out = eng.zeros((bshape, idx.shape[0]), dtype)
    elif (idx.shape[0] >= _DECODE_MIN_K
          and _single_strategy(dtype, width) == "decode"):
        # measured-faster for dense index sets: decode the whole block
        # (the routed full unpack) and gather once, instead of 2 packed-word
        # gathers per index
        from . import bitpack

        t_bits = layout.bit_width(dtype)
        if width == t_bits:
            full = bitpack._unpack_wt(vec, dtype, bitpack._wt_strategy(dtype))
        else:
            rows = dict(bitpack.unpack_row_stream(vec, width, dtype))
            full = bitpack.assemble_blocks(rows, dtype)
        out = eng.take_cols(full, idx, dtype)
    else:
        lanes_t = jnp.asarray(layout.lanes_by_index(dtype))
        rows_t = jnp.asarray(layout.rows_by_index(dtype))
        lane = jnp.take(lanes_t, idx)
        row = jnp.take(rows_t, idx)

        if width == t:
            out = eng.take_cols(vec, nl * row + lane, dtype)
        else:
            mask = (1 << width) - 1
            start_bit = row * width
            start_word = start_bit // t
            lo_shift = start_bit % t
            remaining = t - lo_shift

            lo_word = eng.take_cols(vec, nl * start_word + lane, dtype)
            lo = eng.shr_dyn(lo_word, lo_shift, dtype)

            plen = layout.packed_len(dtype, width)
            hi_idx = jnp.minimum(nl * (start_word + 1) + lane, plen - 1)
            hi_word = eng.take_cols(vec, hi_idx, dtype)
            hi = eng.shl_dyn(hi_word, remaining, dtype)

            need_hi = remaining < width
            stitched = eng.orr(lo, hi, dtype)
            out = eng.and_const(eng.where(need_hi, stitched, lo, dtype), mask, dtype)

    if not had_batch:
        out = eng.squeeze_shape(out, False, dtype)  # (B=1, K) -> (K,)
    if scalar_idx:
        out = (out[0][..., 0], out[1][..., 0]) if eng.is_limb(dtype) else out[..., 0]
    return eng.from_vec(out, dtype, like=packed)
