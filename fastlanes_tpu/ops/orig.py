"""Original-order (untransposed) decode — the output-domain formulation.

FLT delta/zdelta/rle chunks store TRANSPOSED blocks (transpose.rs:11-15
composed with delta.rs:25-45 in the reference); after decode the consumer
wants original order back (transpose.rs:18-22). Decode-then-permute pays
a standalone relayout pass over the full output on every sorted-column
file read.

This module never materializes the transposed image: it decodes each
ORIGINAL-order output position directly from its packed word plane,

    orig[b, seg*T + r] = ((plane_k[b, lane_of_seg(seg)] >> sh) | stitch)
        & mask,   k = (r*W) // T,  sh = (r*W) % T

using only gather-free vector vocabulary:

  * per-word-plane lane-repeat broadcasts ((B, LANES) -> (B, 1024) with
    each lane repeated T consecutive positions — sublane broadcast),
  * per-position plane selects over a static row mask (jnp.where chains
    with trace-time constants, W+stitch selects total),
  * for delta: a segmented cumsum in the ORIGINAL domain — the prefix sum
    runs along r, which is the contiguous minor position of each T-wide
    output segment, so `jnp.cumsum` on a (B, LANES, T) view does it,
  * one final static lane->segment chunk permutation (concat of T-wide
    column slices — whole-chunk moves applied LAST, where XLA can fuse
    them into the producing selects instead of running a standalone pass).

u64 runs the same formulations in the (lo, hi) limb-plane domain: shifts
become vector-amount funnels across the limbs and the delta prefix sum
propagates carries via a second cumsum of low-limb overflow indicators.

The module also holds the ENCODE duals (delta_pack_orig / deltas_orig):
original-order values -> the delta/zdelta wire format in one pass, no
transposed image materialized.

Reference parity: macros.rs:35-174 (pack/unpack) and delta.rs:25-63
composed with transpose.rs:11-22; the output/input-domain rewrites are
new structure with no reference counterpart.
"""

from __future__ import annotations

import functools

import numpy as np

from ..core import layout
from . import _engine as eng


@functools.lru_cache(maxsize=None)
def _lane_of_seg(dtype) -> tuple:
    """Inverse of seg_of_lane: which transposed lane feeds original-order
    segment `seg` (orig[seg*T + r] = transposed[index(r, lane_of_seg[seg])];
    derived from transpose.rs:29-36 via layout.transpose_index)."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    seg_of_lane = np.array(
        [layout.transpose_index(layout.index(0, lane, dtype)) // t
         for lane in range(nl)], np.int64)
    inv = np.empty_like(seg_of_lane)
    inv[seg_of_lane] = np.arange(nl, dtype=np.int64)
    return tuple(int(x) for x in inv)


def _repeat_lanes(plane, t):
    """(B, LANES) -> (B, LANES*T): each lane value repeated T consecutive
    positions (natural lane-major layout: out[b, l*T + r] = plane[b, l])."""
    import jax.numpy as jnp

    b, nl = plane.shape
    return jnp.broadcast_to(plane[:, :, None], (b, nl, t)).reshape(b, nl * t)


def _natural_unpack(vec, width, dtype):
    """(B, 1024*W/T) packed -> (B, 1024) natural lane-major order:
    out[b, l*T + r] = value(row r, lane l). Plane selects only."""
    import jax.numpy as jnp

    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    jdt = jnp.dtype(layout.np_dtype(dtype).name)
    b = vec.shape[0]
    if width == 0:
        return jnp.zeros((b, layout.BLOCK), jdt)
    r = np.tile(np.arange(t, dtype=np.int64), nl)      # row of position j
    k = (r * width) // t                               # word plane of j
    sh = (r * width) % t                               # shift within word
    straddle = (sh + width > t) & (k + 1 < width)
    np_dt = layout.np_dtype(dtype)
    SH = jnp.asarray(sh.astype(np_dt))
    SL = jnp.asarray(((t - sh) % t).astype(np_dt))
    reps = [_repeat_lanes(vec[:, kk * nl:(kk + 1) * nl], t)
            for kk in range(width)]
    acc = jnp.zeros((b, layout.BLOCK), jdt)
    for kk in range(width):
        acc = jnp.where(jnp.asarray(k == kk), reps[kk] >> SH, acc)
    for kk in range(1, width):
        m = (k == kk - 1) & straddle
        if m.any():
            acc = jnp.where(jnp.asarray(m), acc | (reps[kk] << SL), acc)
    if width < t:
        acc = acc & jdt.type((1 << width) - 1)
    return acc


def _chunk_perm(nat, dtype):
    """Natural lane-major (B, 1024) -> original order: output segment `seg`
    is the T-wide chunk of lane lane_of_seg[seg] — a static concat of
    T-wide column slices."""
    import jax.numpy as jnp

    t = layout.bit_width(dtype)
    return jnp.concatenate(
        [nat[:, l * t:(l + 1) * t] for l in _lane_of_seg(dtype)], axis=1)


def _seg_cumsum(nat, dtype):
    """Wrapping cumulative sum along r within each T-wide chunk of the
    natural lane-major image — the original-domain form of the per-lane
    delta accumulation (delta.rs:36-45: row order IS position order within
    each output segment)."""
    import jax.numpy as jnp

    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    b = nat.shape[0]
    return jnp.cumsum(nat.reshape(b, nl, t), axis=-1,
                      dtype=nat.dtype).reshape(b, layout.BLOCK)


# -- u64 limb-domain building blocks ----------------------------------------
# The x64-free u64 form: u64 words are (lo, hi) uint32 plane pairs,
# shifts become funnels across the limbs with VECTOR shift amounts
# (trace-time constant arrays — one per output position), and the delta
# prefix sum propagates carries via a second cumsum of overflow indicators.


def _shr64_vec(lo, hi, sh):
    """(lo, hi) >> sh elementwise, sh a uint32 array in [0, 64). Shift
    operands are kept in [0, 31] everywhere (shift-by->=width is undefined
    in XLA); discarded lanes are masked by the wheres."""
    import jax.numpy as jnp

    s = sh & jnp.uint32(31)
    up = (jnp.uint32(32) - s) & jnp.uint32(31)
    lo_small = (lo >> s) | jnp.where(s == 0, jnp.uint32(0), hi << up)
    hi_small = hi >> s
    lo_big = hi >> s  # sh >= 32: sh - 32 == sh & 31
    small = sh < jnp.uint32(32)
    return (jnp.where(small, lo_small, lo_big),
            jnp.where(small, hi_small, jnp.uint32(0)))


def _shl64_vec(lo, hi, sh):
    """(lo, hi) << sh elementwise, sh a uint32 array in [0, 64)."""
    import jax.numpy as jnp

    s = sh & jnp.uint32(31)
    down = (jnp.uint32(32) - s) & jnp.uint32(31)
    hi_small = (hi << s) | jnp.where(s == 0, jnp.uint32(0), lo >> down)
    lo_small = lo << s
    hi_big = lo << s
    small = sh < jnp.uint32(32)
    return (jnp.where(small, lo_small, jnp.uint32(0)),
            jnp.where(small, hi_small, hi_big))


def _natural_unpack_u64(lo, hi, width):
    """u64 od unpack: packed limb planes (B, 16*W) -> natural lane-major
    (B, 1024) plane pair."""
    import jax.numpy as jnp

    t, nl = 64, 16
    b = lo.shape[0]
    if width == 0:
        z = jnp.zeros((b, layout.BLOCK), jnp.uint32)
        return z, z
    r = np.tile(np.arange(t, dtype=np.int64), nl)
    k = (r * width) // t
    sh = (r * width) % t
    straddle = (sh + width > t) & (k + 1 < width)
    SH = jnp.asarray(sh.astype(np.uint32))
    SL = jnp.asarray((((t - sh) % t)).astype(np.uint32))
    reps = [(_repeat_lanes(lo[:, kk * nl:(kk + 1) * nl], t),
             _repeat_lanes(hi[:, kk * nl:(kk + 1) * nl], t))
            for kk in range(width)]
    acc_lo = jnp.zeros((b, layout.BLOCK), jnp.uint32)
    acc_hi = jnp.zeros((b, layout.BLOCK), jnp.uint32)
    for kk in range(width):
        m = jnp.asarray(k == kk)
        s_lo, s_hi = _shr64_vec(reps[kk][0], reps[kk][1], SH)
        acc_lo = jnp.where(m, s_lo, acc_lo)
        acc_hi = jnp.where(m, s_hi, acc_hi)
    for kk in range(1, width):
        m = (k == kk - 1) & straddle
        if m.any():
            s_lo, s_hi = _shl64_vec(reps[kk][0], reps[kk][1], SL)
            mj = jnp.asarray(m)
            acc_lo = jnp.where(mj, acc_lo | s_lo, acc_lo)
            acc_hi = jnp.where(mj, acc_hi | s_hi, acc_hi)
    if width < t:
        mask = (1 << width) - 1
        acc_lo = acc_lo & jnp.uint32(mask & 0xFFFFFFFF)
        acc_hi = acc_hi & jnp.uint32((mask >> 32) & 0xFFFFFFFF)
    return acc_lo, acc_hi


def _seg_cumsum_u64(lo, hi, dtype="u64"):
    """64-bit wrapping segmented cumsum on natural-order planes: cumsum
    both limbs mod 2^32, then add the running count of low-limb overflows
    to the high limb (a + b overflows iff the wrapped sum < b)."""
    import jax.numpy as jnp

    t, nl = 64, 16
    b = lo.shape[0]
    lo3 = lo.reshape(b, nl, t)
    hi3 = hi.reshape(b, nl, t)
    lo_c = jnp.cumsum(lo3, axis=-1, dtype=jnp.uint32)
    carry = jnp.cumsum((lo_c < lo3).astype(jnp.uint32), axis=-1,
                       dtype=jnp.uint32)
    hi_c = jnp.cumsum(hi3, axis=-1, dtype=jnp.uint32) + carry
    return lo_c.reshape(b, layout.BLOCK), hi_c.reshape(b, layout.BLOCK)


def _add64(a_lo, a_hi, b_lo, b_hi):
    import jax.numpy as jnp

    lo = a_lo + b_lo
    return lo, a_hi + b_hi + (lo < b_lo).astype(jnp.uint32)


def _check_dtype(dtype) -> str:
    return layout.canon_dtype(dtype)


# -- gat / rep: all relayout on the PACKED image, O(1) output passes --
# The select-chain 'od' does W lane-repeat broadcasts + ~2W full-width
# selects — O(W) full-block passes. These two do ONE pass over the output:
#
#   gat  words[b, s, r] = packed[b, k(r)*NL + lane_of_seg(s)] via one
#        static (NL, T)-indexed jnp.take per operand (plus the straddle
#        next-word twin), then a single vectorized shift/or/mask pass;
#   rep  the same word arrays built gather-free: lane-permute + transpose
#        the (B, W, NL) packed view (packed-size relayout, W/T of the
#        output bytes), then static-count jnp.repeat along the minor axis.
#
# Both produce the ORIGINAL order directly (segment s owns output positions
# [s*T, (s+1)*T) = rows 0..T of transposed lane lane_of_seg(s) — SURVEY §2
# contiguity fact), so the delta cumsum runs along the minor axis and no
# chunk permutation remains. Work is (B, NL, T) rank-3 throughout with a
# final free reshape to (B, 1024). The routing table picks among od, gat
# and rep per (op, dtype, width); with no table, gat.
# Reference semantics: macros.rs:142-170 restated as the uniform two-term
# extract value = ((word_k >> sh) | (word_{k+1} << (T-sh))) & mask(W).


@functools.lru_cache(maxsize=None)
def _r3_tables(width: int, dtype):
    """Static per-row tables for the rank-3 formulations: primary word k(r),
    shift sh(r), straddle mask, next word, (NL, T) take indices."""
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    r = np.arange(t, dtype=np.int64)
    k = (r * width) // t
    sh = (r * width) % t
    need = (sh + width > t) & (k + 1 < width)
    kn = np.minimum(k + 1, max(width - 1, 0))
    lane_perm = np.asarray(_lane_of_seg(dtype), np.int64)
    IDXW = (k[None, :] * nl + lane_perm[:, None]).astype(np.int32)   # (NL, T)
    IDXN = (kn[None, :] * nl + lane_perm[:, None]).astype(np.int32)
    return {
        "t": t, "nl": nl, "sh": sh, "sl": (t - sh) % t, "need": need,
        "any_need": bool(need.any()), "reps": np.bincount(k, minlength=width),
        "idxw": IDXW, "idxn": IDXN, "lane_perm": lane_perm,
    }


def _word_streams_gat(vec_one, width, dtype):
    """(words, nxt) (B, NL, T) operand arrays via static takes."""
    import jax.numpy as jnp

    tb = _r3_tables(width, dtype)
    words = jnp.take(vec_one, jnp.asarray(tb["idxw"]), axis=-1)
    nxt = (jnp.take(vec_one, jnp.asarray(tb["idxn"]), axis=-1)
           if tb["any_need"] else None)
    return words, nxt


def _word_streams_rep(vec_one, width, dtype):
    """(words, nxt) via packed-domain relayout + static-count repeats."""
    import jax.numpy as jnp

    tb = _r3_tables(width, dtype)
    nl = tb["nl"]
    b = vec_one.shape[0]
    pt3 = jnp.transpose(
        vec_one.reshape(b, width, nl)[:, :, jnp.asarray(tb["lane_perm"])],
        (0, 2, 1))                                           # (B, NL, W)
    reps = jnp.asarray(tb["reps"])
    words = jnp.repeat(pt3, reps, axis=-1, total_repeat_length=tb["t"])
    nxt = None
    if tb["any_need"]:
        ptn = jnp.concatenate([pt3[:, :, 1:], pt3[:, :, -1:]], axis=-1)
        nxt = jnp.repeat(ptn, reps, axis=-1, total_repeat_length=tb["t"])
    return words, nxt


_WORD_STREAMS = {"gat": _word_streams_gat, "rep": _word_streams_rep}


def _r3_unpack(vec, width, dtype, formulation):
    """Packed vec -> (B, NL, T) ORIGINAL-order values (segment-major, perm
    folded into the word streams; flat original order is a free reshape).
    u64 returns a (lo, hi) plane pair."""
    import jax.numpy as jnp

    streams = _WORD_STREAMS[formulation]
    if eng.is_limb(dtype):
        b = vec[0].shape[0]
        if width == 0:
            z = jnp.zeros((b, layout.lanes(dtype), layout.bit_width(dtype)),
                          jnp.uint32)
            return z, z
        tb = _r3_tables(width, dtype)
        SH = jnp.asarray(tb["sh"].astype(np.uint32))
        wl, nl_ = streams(vec[0], width, dtype)
        wh, nh = streams(vec[1], width, dtype)
        lo, hi = _shr64_vec(wl, wh, SH)
        if tb["any_need"]:
            SL = jnp.asarray(tb["sl"].astype(np.uint32))
            sl_lo, sl_hi = _shl64_vec(nl_, nh, SL)
            m = jnp.asarray(tb["need"])
            lo = jnp.where(m, lo | sl_lo, lo)
            hi = jnp.where(m, hi | sl_hi, hi)
        if width < 64:
            mask = (1 << width) - 1
            lo = lo & jnp.uint32(mask & 0xFFFFFFFF)
            hi = hi & jnp.uint32((mask >> 32) & 0xFFFFFFFF)
        return lo, hi
    np_dt = layout.np_dtype(dtype)
    b = vec.shape[0]
    if width == 0:
        return jnp.zeros((b, layout.lanes(dtype), layout.bit_width(dtype)),
                         jnp.dtype(np_dt.name))
    tb = _r3_tables(width, dtype)
    words, nxt = streams(vec, width, dtype)
    out = words >> jnp.asarray(tb["sh"].astype(np_dt))
    if tb["any_need"]:
        out = jnp.where(jnp.asarray(tb["need"]),
                        out | (nxt << jnp.asarray(tb["sl"].astype(np_dt))),
                        out)
    if width < tb["t"]:
        out = out & np_dt.type((1 << width) - 1)
    return out


def _flat_unpack(vec, width, dtype, formulation):
    """Packed vec -> (B, 1024) ORIGINAL-order values via _r3_unpack."""
    b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
    out = _r3_unpack(vec, width, dtype, formulation)
    if eng.is_limb(dtype):
        return out[0].reshape(b, layout.BLOCK), out[1].reshape(b, layout.BLOCK)
    return out.reshape(b, layout.BLOCK)


def _finish_delta_flat(nat3, base, width, dtype, had_batch, vec):
    """Delta tail for the rank-3 formulations: segmented cumsum along the
    minor axis + LANE-PERMUTED base; no chunk permutation (the word streams
    already fold lane_of_seg). `nat3` is the (B, NL, T) image."""
    import jax.numpy as jnp

    b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
    perm = jnp.asarray(np.asarray(_lane_of_seg(dtype), np.int64))
    if eng.is_limb(dtype):
        base_lo, base_hi = _base_2d(base, dtype, vec)
        lo3, hi3 = nat3
        lo_c = jnp.cumsum(lo3, axis=-1, dtype=jnp.uint32)
        carry = jnp.cumsum((lo_c < lo3).astype(jnp.uint32), axis=-1,
                           dtype=jnp.uint32)
        hi_c = jnp.cumsum(hi3, axis=-1, dtype=jnp.uint32) + carry
        bl = base_lo[:, perm][:, :, None]
        lo = lo_c + bl
        hi = hi_c + base_hi[:, perm][:, :, None] + (lo < bl).astype(jnp.uint32)
        out = lo.reshape(b, layout.BLOCK), hi.reshape(b, layout.BLOCK)
    else:
        base_vec = _base_2d(base, dtype, vec)
        cum = jnp.cumsum(nat3, axis=-1, dtype=nat3.dtype)
        out = (cum + base_vec[:, perm][:, :, None]).reshape(b, layout.BLOCK)
    return eng.squeeze_shape(out, had_batch, dtype)


def unpack_orig(packed, width, dtype, *, formulation: str = "gat"):
    """unpack + untranspose in one pass: packed transposed-domain blocks ->
    ORIGINAL-order (B, 1024) values, no transposed image materialized.
    u64 returns a (lo, hi) uint32 plane pair.

    formulation: 'gat' | 'rep' (flat one-pass forms, see above) | 'od'
    (the select-chain output-domain form — O(W) passes, kept for routing
    races and as the formulation that needs no gather/repeat vocabulary)."""
    dtype = _check_dtype(dtype)
    layout.check_width(dtype, width)
    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    if formulation in _WORD_STREAMS:
        out = _flat_unpack(vec, width, dtype, formulation)
        return eng.squeeze_shape(out, had_batch, dtype)
    if eng.is_limb(dtype):
        lo, hi = _natural_unpack_u64(vec[0], vec[1], width)
        out = _chunk_perm(lo, dtype), _chunk_perm(hi, dtype)
    else:
        out = _chunk_perm(_natural_unpack(vec, width, dtype), dtype)
    return eng.squeeze_shape(out, had_batch, dtype)


def _finish_delta_orig(nat, base, width, dtype, had_batch, vec):
    """Shared tail of the delta-family orig decodes: segmented cumsum (+base)
    in the natural domain, then the chunk permutation."""
    t = layout.bit_width(dtype)
    if eng.is_limb(dtype):
        base_lo, base_hi = _base_2d(base, dtype, vec)
        lo, hi = _seg_cumsum_u64(*nat)
        lo, hi = _add64(lo, hi, _repeat_lanes(base_lo, t),
                        _repeat_lanes(base_hi, t))
        out = _chunk_perm(lo, dtype), _chunk_perm(hi, dtype)
    else:
        base_vec = _base_2d(base, dtype, vec)
        nat = _seg_cumsum(nat, dtype) + _repeat_lanes(base_vec, t)
        out = _chunk_perm(nat, dtype)
    return eng.squeeze_shape(out, had_batch, dtype)


def undelta_pack_orig(packed, base, width, dtype, *, formulation: str = "gat"):
    """undelta_pack + untranspose in one pass (delta.rs:48-63 composed with
    transpose.rs:18-22): per-segment cumsum in the original domain.
    u64 returns a (lo, hi) uint32 plane pair (carry-propagating cumsum)."""
    dtype = _check_dtype(dtype)
    layout.check_width(dtype, width)
    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    if formulation in _WORD_STREAMS:
        nat3 = _r3_unpack(vec, width, dtype, formulation)
        return _finish_delta_flat(nat3, base, width, dtype, had_batch, vec)
    if eng.is_limb(dtype):
        nat = _natural_unpack_u64(vec[0], vec[1], width)
    else:
        nat = _natural_unpack(vec, width, dtype)
    return _finish_delta_orig(nat, base, width, dtype, had_batch, vec)


def unzdelta_pack_orig(packed, base, width, dtype, *, formulation: str = "gat"):
    """Fused zdelta decode to original order: unpack -> unzigzag ->
    per-segment cumsum (-> chunk permutation on the od form), one traced
    pass."""
    import jax.numpy as jnp

    from .. import transforms

    dtype = _check_dtype(dtype)
    layout.check_width(dtype, width)
    vec = eng.to_vec(packed, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    if formulation in _WORD_STREAMS:
        z = _r3_unpack(vec, width, dtype, formulation)
        if eng.is_limb(dtype):
            nat3 = transforms.zigzag_decode_limb(z[0], z[1])
        else:
            one = z.dtype.type(1)
            nat3 = (z >> one) ^ (jnp.zeros_like(z) - (z & one))
        return _finish_delta_flat(nat3, base, width, dtype, had_batch, vec)
    if eng.is_limb(dtype):
        zlo, zhi = _natural_unpack_u64(vec[0], vec[1], width)
        nat = transforms.zigzag_decode_limb(zlo, zhi)
    else:
        z = _natural_unpack(vec, width, dtype)
        one = z.dtype.type(1)
        nat = (z >> one) ^ (jnp.zeros_like(z) - (z & one))  # unzigzag bits
    return _finish_delta_orig(nat, base, width, dtype, had_batch, vec)


def _base_2d(base, dtype, vec):
    """Base operand -> (B, LANES) in the packed batch: scalar, (LANES,)
    shared, or (B, LANES) per-block (the ops/delta._base_vec conventions).
    u64: returns a ((B, LANES), (B, LANES)) plane pair."""
    import jax.numpy as jnp

    nl = layout.lanes(dtype)
    if eng.is_limb(dtype):
        b = vec[0].shape[0]
        if isinstance(base, int):
            lo = jnp.full((b, nl), base & 0xFFFFFFFF, jnp.uint32)
            hi = jnp.full((b, nl), (base >> 32) & 0xFFFFFFFF, jnp.uint32)
            return lo, hi
        lo, hi = eng.to_vec(base, dtype)
        if lo.ndim == 1:
            if lo.shape[0] != nl:
                raise ValueError(f"shared u64 base must be ({nl},)-shaped")
            lo, hi = lo[None, :], hi[None, :]
        return (jnp.broadcast_to(lo, (b, nl)), jnp.broadcast_to(hi, (b, nl)))
    jdt = jnp.dtype(layout.np_dtype(dtype).name)
    b = vec.shape[0]
    arr = jnp.asarray(base)
    if arr.dtype != jdt:
        if arr.ndim == 0 or jnp.issubdtype(arr.dtype, jnp.integer):
            arr = arr.astype(jdt)
        else:
            raise ValueError(f"base dtype {arr.dtype} incompatible with {dtype}")
    if arr.ndim == 0:
        return jnp.broadcast_to(arr, (b, nl))
    if arr.ndim == 1:
        if arr.shape[0] != nl:
            raise ValueError(f"shared base must be ({nl},), got {arr.shape}")
        return jnp.broadcast_to(arr[None, :], (b, nl))
    if arr.ndim == 2:
        if arr.shape != (b, nl):
            raise ValueError(f"per-block base must be ({b}, {nl}), got {arr.shape}")
        return arr
    raise ValueError(f"base rank {arr.ndim} not supported")


# -- encode duals: ORIGINAL-order values -> delta/zdelta wire format ---------
# The composed encode materializes the transposed image first (a standalone
# permute) before delta+pack. Here the transpose never exists:
# transposed(r, l) = orig[seg_of_lane[l]*T + r], so
# a (B, LANES, T) view + ONE static lane-axis take exposes every transposed
# row as a minor-axis slice, and delta/zigzag/pack trace straight off it
# (the encode dual of undelta_pack_orig; reference transpose.rs:11-15 +
# delta.rs:25-33 + macros.rs:35-98 in one pass).


@functools.lru_cache(maxsize=None)
def _seg_of_lane(dtype) -> tuple:
    """transposed(r, l) = orig[_seg_of_lane[l]*T + r]."""
    t = layout.bit_width(dtype)
    return tuple(int(layout.transpose_index(layout.index(0, lane, dtype)) // t)
                 for lane in range(layout.lanes(dtype)))


def _orig_rows_one(x2d, dtype):
    """(B, 1024) original order -> (B, LANES, T) with [:, l, r] =
    transposed(r, l): reshape + one static lane-axis take."""
    import jax.numpy as jnp

    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    b = x2d.shape[0]
    X3 = x2d.reshape(b, nl, t)
    return X3[:, jnp.asarray(np.asarray(_seg_of_lane(dtype), np.int32)), :]


def _orig_rows(vec, dtype):
    if eng.is_limb(dtype):
        return _orig_rows_one(vec[0], dtype), _orig_rows_one(vec[1], dtype)
    return _orig_rows_one(vec, dtype)


def _p3_row(P3, r, dtype):
    if eng.is_limb(dtype):
        return P3[0][..., r], P3[1][..., r]
    return P3[..., r]


def _zigzag_vec(d, dtype):
    """Wrapping-unsigned delta -> zigzag code, in-domain (u = (v << 1) ^
    (v >> T-1 arithmetic); transforms.py formulas restated unsigned)."""
    import jax.numpy as jnp

    if eng.is_limb(dtype):
        from .. import transforms

        return transforms.zigzag_encode_limb(d[0], d[1])
    t = layout.bit_width(dtype)
    one = d.dtype.type(1)
    sign = jnp.zeros_like(d) - (d >> d.dtype.type(t - 1))
    return (d << one) ^ sign


def deltas_orig(values, dtype, *, zigzag: bool = False):
    """The delta image (rows 1..T-1; row 0 vs the per-block base is zero)
    computed from ORIGINAL-order values without a transpose — order is
    lane-major, intended for width selection (max), not the wire."""
    dtype = _check_dtype(dtype)
    vec = eng.to_vec(values, dtype)
    vec, _ = eng.promote_shape(vec, dtype)
    P3 = _orig_rows(vec, dtype)
    if eng.is_limb(dtype):
        d = eng.sub((P3[0][..., 1:], P3[1][..., 1:]),
                    (P3[0][..., :-1], P3[1][..., :-1]), dtype)
    else:
        d = eng.sub(P3[..., 1:], P3[..., :-1], dtype)
    if zigzag:
        d = _zigzag_vec(d, dtype)
    return d


def delta_pack_orig(values, width, dtype, *, zigzag: bool = False):
    """ORIGINAL-order values -> (packed, base): transpose + per-lane delta
    (+ zigzag) + pack in ONE traced pass; the transposed image is never
    materialized. base is the per-block transposed row 0 ((B, LANES), the
    fio delta-chunk convention), so delta row 0 is zero."""
    dtype = _check_dtype(dtype)
    layout.check_width(dtype, width)
    t = layout.bit_width(dtype)
    nl = layout.lanes(dtype)
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    P3 = _orig_rows(vec, dtype)
    base = _p3_row(P3, 0, dtype)

    def row_fn(r):
        if r == 0:
            b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
            return eng.zeros((b, nl), dtype)
        d = eng.sub(_p3_row(P3, r, dtype), _p3_row(P3, r - 1, dtype), dtype)
        return _zigzag_vec(d, dtype) if zigzag else d

    from .bitpack import pack_words

    words = pack_words(row_fn, width, dtype, None)
    if not words:
        b = (vec[0] if eng.is_limb(dtype) else vec).shape[0]
        packed = eng.zeros((b, 0), dtype)
    else:
        packed = eng.concat_cols(words, dtype)
    packed = eng.squeeze_shape(packed, had_batch, dtype)
    base = eng.squeeze_shape(base, had_batch, dtype)
    return (eng.from_vec(packed, dtype, like=values),
            eng.from_vec(base, dtype, like=values))
