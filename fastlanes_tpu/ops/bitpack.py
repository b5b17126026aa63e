"""jnp bit-packing ops: batched, jit-traceable, XLA-fused.

A vectorized re-design of the reference's pack!/unpack! macro kernels
(reference src/macros.rs:35-98 / 101-174 driven by src/bitpacking.rs:65-106):

  * the per-lane loop of the reference becomes the vector axis — every op
    below acts on (B, LANES) slabs, vectorizing over all lanes of all blocks
    at once;
  * the reference's unrolled `seq_t!` row loop becomes a trace-time Python
    loop over T rows: all shifts/masks/word indices are Python constants, so
    XLA sees a static DAG of shift/mask/or ops it can fuse into a single
    memory-bound pass;
  * because `index(row, lane)` makes each transposed row a *contiguous*
    slice of the flat block (see core/layout.py), there are no gathers —
    only static column slices and concatenations.

The kernel-body hooks of the reference macros (`|$idx, $elem|`) survive as
the `pack_row_stream` / `unpack_row_stream` generators, which delta.py and
ffor.py compose into fused kernels exactly like delta.rs:48-63 / ffor.rs:24-50.

u64 runs on 2x32-bit limbs via the engine (ops/_engine.py).
"""

from __future__ import annotations

import functools

import numpy as np

from ..core import layout
from . import _engine as eng


def _mask_bits(width_bits: int, t: int) -> int:
    """mask(width) from reference macros.rs:141-143."""
    if width_bits == t:
        return (1 << t) - 1
    return (1 << (width_bits % t)) - 1


def pack_words(row_fn, width: int, dtype, batch_shape):
    """Run the pack loop over a row stream; returns the list of W word vecs.

    `row_fn(row)` must return the (B, LANES) vec of transposed row `row`
    (already masked or not — masking to W bits happens here, macros.rs:74-76).
    Mirrors reference macros.rs:35-98.
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    layout.check_width(dtype, width)

    if width == 0:
        return []
    if width == t:
        # W == T: straight copy in row order (macros.rs:54-59).
        return [row_fn(row) for row in range(t)]

    mask = (1 << width) - 1
    words = []
    tmp = None
    for row in range(t):
        src = eng.and_const(row_fn(row), mask, dtype)
        shift = (row * width) % t
        if row == 0:
            tmp = src
        else:
            tmp = eng.orr(tmp, eng.shl(src, shift, dtype), dtype)
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        if next_word > curr_word:
            words.append(tmp)
            remaining = ((row + 1) * width) % t
            # carry bits that did not fit (macros.rs:89-93); width-remaining < T
            tmp = eng.shr(src, width - remaining, dtype)
    assert len(words) == width
    return words


def unpack_row_stream(packed_vec, width: int, dtype, get_word=None):
    """Yield (row, (B, LANES) vec) in transposed row order from a packed vec.

    The vectorized analogue of the reference unpack! macro's kernel-body hook
    (macros.rs:101-174) — fused consumers iterate this stream.

    `get_word(w)` optionally overrides how packed word w is fetched.
    """
    dtype = layout.canon_dtype(dtype)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    layout.check_width(dtype, width)
    if get_word is None:
        get_word = lambda w: eng.cols(packed_vec, nl * w, nl, dtype)  # noqa: E731

    if width == 0:
        if eng.is_limb(dtype):
            b = packed_vec[0].shape[:-1]
        else:
            b = packed_vec.shape[:-1]
        zero = eng.zeros((*b, nl), dtype)
        for row in range(t):
            yield row, zero
        return

    if width == t:
        for row in range(t):
            yield row, get_word(row)
        return

    src = get_word(0)
    for row in range(t):
        curr_word = (row * width) // t
        next_word = ((row + 1) * width) // t
        shift = (row * width) % t
        if next_word > curr_word:
            remaining = ((row + 1) * width) % t
            current_bits = width - remaining
            tmp = eng.and_const(eng.shr(src, shift, dtype), _mask_bits(current_bits, t), dtype)
            if next_word < width:
                src = get_word(next_word)
                stitched = eng.shl(eng.and_const(src, _mask_bits(remaining, t), dtype),
                                   current_bits, dtype)
                tmp = eng.orr(tmp, stitched, dtype)
        else:
            tmp = eng.and_const(eng.shr(src, shift, dtype), _mask_bits(width, t), dtype)
        yield row, tmp


def assemble_blocks(rows_by_row: dict, dtype):
    """Reassemble T (B, LANES) row vecs into flat (B, 1024) blocks.

    Inverse of the contiguous-row-slice decomposition: column group k of the
    (8, 128)-tiled block holds o = row_order_by_offset[k], so the flat block
    is a single static concatenation — no scatter.
    """
    dtype = layout.canon_dtype(dtype)
    order = layout.row_order_by_offset(dtype)
    pieces = []
    for s in range(8):
        for o in order:
            pieces.append(rows_by_row[o * 8 + s])
    return eng.concat_cols(pieces, dtype)


def block_rows(values_vec, dtype):
    """Yield (row, (B, LANES) vec) of a flat block vec, in transposed row order
    (the iterate!/pack! read pattern, macros.rs:12-32)."""
    dtype = layout.canon_dtype(dtype)
    nl = layout.lanes(dtype)
    for row in range(layout.bit_width(dtype)):
        yield row, eng.cols(values_vec, layout.row_offset(row), nl, dtype)


def _row_fn_of(values_vec, dtype):
    nl = layout.lanes(dtype)
    return lambda row: eng.cols(values_vec, layout.row_offset(row), nl, dtype)


def pack(values, width: int, dtype) -> "jnp.ndarray":
    """BitPacking::pack, batched: (B, 1024) -> (B, 1024*W//T).

    For u64 pass uint64 (needs jax x64) or uint32 limb pairs (..., 1024, 2);
    the result mirrors the input convention.
    """
    dtype = layout.canon_dtype(dtype)
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    if width == layout.bit_width(dtype):
        out = _pack_wt(vec, dtype, _pack_wt_strategy(dtype))
    elif width == 0:
        b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
        out = eng.zeros((b, 0), dtype)
    else:
        out = eng.concat_cols(pack_words(_row_fn_of(vec, dtype), width,
                                         dtype, None), dtype)
    out = eng.squeeze_shape(out, had_batch, dtype)
    return eng.from_vec(out, dtype, like=values)


def pack_map(fn, values, width: int, dtype):
    """pack(fn(values)) with `fn` applied PER TRANSPOSED ROW SLICE — the
    fused-encode public entry.

    Writing `pack(fn(values))` materializes fn(values) first: the packed
    words read many overlapping row slices of it, and XLA materializes an
    elementwise producer that has many slice consumers — a full extra
    read+write of the input charged to the encode. This entry applies `fn`
    AFTER each row-slice read, so every fn instance has a single consumer
    and XLA fuses it into the packed-word production: the codec's true
    encode throughput, through a public API. `delta_pack`/`for_pack` are
    the specialized versions of this hook (reference delta.rs:25-33,
    ffor.rs:24-35); `fn` generalizes it to any elementwise producer.

    `fn` must be jax-traceable and elementwise on a (B, LANES) row vec;
    for u64 it receives and returns a (lo, hi) uint32 plane pair.
    """
    dtype = layout.canon_dtype(dtype)
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    base_row = _row_fn_of(vec, dtype)
    words = pack_words(lambda row: fn(base_row(row)), width, dtype, None)
    if not words:
        b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
        out = eng.zeros((b, 0), dtype)
    else:
        out = eng.concat_cols(words, dtype)
    out = eng.squeeze_shape(out, had_batch, dtype)
    return eng.from_vec(out, dtype, like=values)


def _check_planes(planes, dtype):
    if planes and not eng.is_limb(dtype):
        raise ValueError("planes=True is the u64 limb-plane API; other "
                         "dtypes return a single array already")


def unpack(packed, width: int, dtype, *, planes: bool = False) -> "jnp.ndarray":
    """BitPacking::unpack, batched: (B, 1024*W//T) -> (B, 1024).

    planes=True (u64 only) returns separate (lo, hi) uint32 planes — the
    fast device form (see unpack_planes)."""
    dtype = layout.canon_dtype(dtype)
    _check_planes(planes, dtype)
    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    t = layout.bit_width(dtype)
    if width == t:
        # W == T: no bit math — a pure relayout of LANES-wide word groups
        # (macros.rs:126-132 is a copy loop). Strategy measured per dtype
        # (routing key "unpack_wt"); 'assemble' is the classic concat.
        out = _unpack_wt(vec, dtype, _wt_strategy(dtype))
    else:
        rows = dict(unpack_row_stream(vec, width, dtype))
        out = assemble_blocks(rows, dtype)
    out = eng.squeeze_shape(out, had_batch, dtype)
    if planes:
        return out
    return eng.from_vec(out, dtype, like=packed)


# -- W == T relayout strategies ----------------------------------------------
# At full width the packed image holds the transposed values verbatim, one
# T-row per LANES-wide word group; unpack is a static permutation of those
# groups. Several relayout lowerings race for the slot:
#   assemble   the classic row-stream concat (default)
#   gather     one static 1024-lane gather
#   grouptake  (B, T, LANES) view + take on the group axis
#   bitrev     pure reshape/transpose (see _wt_bitrev)
# tools/tune_routing.py records the winner under "unpack_wt".


@functools.lru_cache(maxsize=None)
def _wt_group_perm(dtype) -> tuple:
    """Output word-group g of the flat transposed block holds packed word
    perm[g] (the assemble_blocks piece order)."""
    t = layout.bit_width(dtype)
    order = layout.row_order_by_offset(dtype)
    return tuple(o * 8 + s for s in range(8) for o in order[:t // 8])


@functools.lru_cache(maxsize=None)
def _wt_strategy(dtype) -> str:
    from ..kernels import routing

    strat = routing.best_path("unpack_wt", dtype, layout.bit_width(dtype))
    return strat if strat in _WT_IMPLS else "assemble"


def _wt_bitrev(x2d, dtype, kind):
    """W=T relayout as pure reshape/transpose (no gather HLO): the group
    permutation is an (o, s)-axis swap composed with a bit-reversal of the
    o bits, because FL_ORDER is the 3-bit bit-reversal — word r = (o, s)
    maps to flat group g = s*(T/8) + bitrev(o)."""
    import jax.numpy as jnp

    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    b = x2d.shape[0]
    q = t // 8
    if q == 1:
        return x2d  # u8: words are already in flat-group order
    nb = q.bit_length() - 1
    x3 = x2d.reshape(b, t, nl)
    if kind == "unpack":
        # word-major r = (o_msb..o_lsb, s) -> group-major (s, bitrev(o))
        y = x3.reshape((b,) + (2,) * nb + (8, nl))
        axes = [0, 1 + nb] + list(range(nb, 0, -1)) + [2 + nb]
    else:
        # group-major g = (s, q_msb..q_lsb) -> word-major (bitrev(q), s)
        y = x3.reshape((b, 8) + (2,) * nb + (nl,))
        axes = [0] + list(range(1 + nb, 1, -1)) + [1, 2 + nb]
    return jnp.transpose(y, axes).reshape(b, layout.BLOCK)


def _wt_one(x2d, dtype, strategy, perm=None, kind="unpack"):
    import jax.numpy as jnp

    if strategy == "bitrev":
        return _wt_bitrev(x2d, dtype, kind)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    b = x2d.shape[0]
    perm = _wt_group_perm(dtype) if perm is None else perm
    if strategy == "gather":
        flat = np.repeat(np.asarray(perm, np.int64) * nl, nl) + \
            np.tile(np.arange(nl), t)
        return x2d[:, jnp.asarray(flat)]
    if strategy == "grouptake":
        return jnp.take(x2d.reshape(b, t, nl),
                        jnp.asarray(np.asarray(perm, np.int32)),
                        axis=1).reshape(b, layout.BLOCK)
    raise ValueError(f"unknown W=T strategy {strategy!r}")


_WT_IMPLS = ("assemble", "gather", "grouptake", "bitrev")


def _unpack_wt(vec, dtype, strategy):
    if strategy == "assemble":
        t = layout.bit_width(dtype)
        rows = dict(unpack_row_stream(vec, t, dtype))
        return assemble_blocks(rows, dtype)
    if eng.is_limb(dtype):  # apply the relayout per limb plane
        return (_wt_one(vec[0], dtype, strategy),
                _wt_one(vec[1], dtype, strategy))
    return _wt_one(vec, dtype, strategy)


@functools.lru_cache(maxsize=None)
def _pack_wt_perm(dtype) -> tuple:
    """Packed word r of the W=T image comes from input word group
    row_offset(r) // LANES of the flat transposed block (the inverse of
    _wt_group_perm)."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    return tuple(layout.row_offset(r) // nl for r in range(t))


@functools.lru_cache(maxsize=None)
def _pack_wt_strategy(dtype) -> str:
    from ..kernels import routing

    strat = routing.best_path("pack_wt", dtype, layout.bit_width(dtype))
    return strat if strat in _WT_IMPLS else "assemble"


def _pack_wt(vec, dtype, strategy):
    """W == T pack: the inverse group permutation (macros.rs:54-59 is a
    copy loop) — same strategy set as _unpack_wt, routed via 'pack_wt'."""
    if strategy == "assemble":
        words = pack_words(_row_fn_of(vec, dtype), layout.bit_width(dtype),
                           dtype, None)
        return eng.concat_cols(words, dtype)
    perm = _pack_wt_perm(dtype)
    if eng.is_limb(dtype):
        return (_wt_one(vec[0], dtype, strategy, perm, kind="pack"),
                _wt_one(vec[1], dtype, strategy, perm, kind="pack"))
    return _wt_one(vec, dtype, strategy, perm, kind="pack")


def unpack_planes(packed, width: int, dtype):
    """u64 unpack returning SEPARATE (lo, hi) uint32 planes, each (B, 1024),
    instead of the interleaved (..., 1024, 2) limb image.

    The performance form for u64 consumers that stay on device: it skips
    the strided element interleave of the limb image. The byte-compatible
    limb image is `jnp.stack([lo, hi], axis=-1)` when needed off-device."""
    dtype = layout.canon_dtype(dtype)
    if not eng.is_limb(dtype):
        raise ValueError("unpack_planes is the u64 limb-plane API; "
                         "use unpack for other dtypes")
    return unpack(packed, width, dtype, planes=True)
