"""Fused analytics over compressed FLT columns: decode-into-consumer as a
library API.

The FastLanes layout exists so decoders fuse into their consumers
(reference macros.rs:5-9). This module turns that into a user-facing
query surface: reductions and filtered counts over
an FLT file or table column WITHOUT materializing the decoded data in HBM
— per chunk, one jit traces decode -> reduce and XLA fuses the pipeline.

    from fastlanes_tpu import analytics
    stats = analytics.scan_column("col.flt")             # sum/min/max/count
    n = analytics.count_where("col.flt", "gt", 1000)     # filtered count
    stats = analytics.scan_column("table.flt", column="price")
    all_cols = analytics.scan_table("table.flt")         # one file pass
    hot = analytics.scan_where("table.flt", "gt", 50,    # filtered agg
                               column="price", where="qty")
    per_key = analytics.group_stats("table.flt", "k", "price")  # GROUP BY

Works for every chunk codec (bitpack/ffor fuse fully; delta/zdelta/rle/alp
decode in-graph first) and every dtype incl. signed transforms and floats.
u64 integer columns reduce x64-FREE in the uint32 limb domain
(_stats_kernel_u64): sums are exact big-ints via 16-bit plane reduction;
min/max use int64 semantics (unsigned values >= 2^63 appear negative —
the same convention as the signed transforms). FLOAT columns (f32 AND
f64) also reduce x64-free — and EXACTLY: sums run through an integer
superaccumulator in the limb domain (_stats_kernel_f64/_f32) and come
back exactly rounded (each value contributes its full
2^-1075/2^-150-granularity amount; stronger than float accumulation,
which drifts with column length), min/max through the IEEE total-order
key, count_where through key comparisons with numpy NaN/-0.0 semantics.
The same exact path runs when x64 IS enabled, so results never depend on
the x64 flag.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import fio, fio_device, zonemaps
from .core import layout

_PREDS = {
    "lt": lambda x, v: x < v,
    "le": lambda x, v: x <= v,
    "gt": lambda x, v: x > v,
    "ge": lambda x, v: x >= v,
    "eq": lambda x, v: x == v,
    "ne": lambda x, v: x != v,
}
#: membership predicates take a LIST of probe values (the semi-join /
#: SQL IN pushdown); null rows match neither `in` nor `notin`
_SET_OPS = ("in", "notin")
_ALL_OPS = tuple(_PREDS) + _SET_OPS

#: lockstep walks (cross-column where / group-by / select / join) decode
#: this many aligned chunks per device dispatch — ~1/8 of the per-call
#: overhead without unbounded HBM staging (FASTLANES_LOCKSTEP_WINDOW
#: overrides for A/B measurement; 1 = chunk-at-a-time)
import os as _os_mod

_LOCKSTEP_WINDOW = int(_os_mod.environ.get("FASTLANES_LOCKSTEP_WINDOW", "8")
                       or 8)


def _column_layout(path: str, column: Optional[str]):
    """Chunk metadata of a column (FLT file or FLTTAB table column):
    (chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta)."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"FLTTAB1"):
        from . import fio_table

        if column is None:
            raise ValueError("table file: pass column=<name>")
        header = fio_table.read_table_header(path)
        col = fio_table._col_meta(header, column)
        return (col["chunks"], col["dtype"], col.get("transform"),
                col.get("vtype"), col.get("n_values"),
                fio.payload_base_of(path, fio_table.MAGIC),
                col.get("nulls"))
    header = fio.read_header(path)
    return (header["chunks"], header["dtype"], header.get("transform"),
            header.get("vtype"), header.get("n_values"),
            fio._payload_base(path), header.get("nulls"))


def _paths(path):
    """Every analytics entry point accepts one path or a LIST of paths (a
    sharded dataset); lists scan file-by-file into one shared accumulator
    wherever that keeps exactness (integer sums, counts, extremes,
    distinct sets, top-k candidates stay exact across files; only
    string-keyed/valued FLOAT sums merge as per-file exactly-rounded
    sums, since each file owns its dictionary)."""
    return list(path) if isinstance(path, (list, tuple)) else [path]


def _merge_str_stats(subs) -> dict:
    """Merge per-file stats of a string column (each file owns its own
    dictionary, so code-domain accumulators cannot merge — strings can)."""
    mins = [s["min"] for s in subs if s["min"] is not None]
    maxs = [s["max"] for s in subs if s["max"] is not None]
    out = {"sum": None, "min": min(mins) if mins else None,
           "max": max(maxs) if maxs else None,
           "count": sum(s["count"] for s in subs)}
    if any("n_null" in s for s in subs):
        out["n_null"] = sum(s.get("n_null", 0) for s in subs)
    return out


def _merge_group_results(subs, str_value: bool) -> dict:
    """Merge per-file group_stats results (string-keyed/valued datasets:
    dictionaries differ per file, so merging happens at the label level).
    Integer sums add exactly; float sums add the per-file exactly-rounded
    totals."""
    out = {}
    for sub in subs:
        for g, s in sub.items():
            cur = out.get(g)
            if cur is None:
                out[g] = cur = dict(s)
                cur.pop("n_dict", None)  # per-file dictionary size
                continue
            cur["count"] += s["count"]
            if str_value:
                cur["min"] = min(cur["min"], s["min"])
                cur["max"] = max(cur["max"], s["max"])
            else:
                cur["sum"] = cur["sum"] + s["sum"]
                cur["min"] = _merge_extreme(cur["min"], s["min"], min)
                cur["max"] = _merge_extreme(cur["max"], s["max"], max)
    return out


def _decoded_chunks(path: str, column: Optional[str], mesh, batch=True,
                    window: Optional[int] = None, keep=None, natural=False):
    """Yield (decoded device blocks, dtype, vtype, valid, vmask) already
    transform-applied — real values in the column's logical domain. `vmask`
    is the part's flat device validity mask for nullable columns (True =
    present; null fillers are real neighbour values and must not
    contribute), else None. With `batch` (the default), consecutive
    same-signature chunks decode in ONE device dispatch
    (fio_device._decode_chunks_grouped) and come back as one merged part;
    lockstep consumers (cross-column scan_where / group_stats / select /
    join) pass batch=False with a `window`: every window of N chunks
    decodes batched and yields exactly ONE part, so multi-column walks
    stay aligned while paying ~1/N of the per-dispatch overhead.

    `keep` (optional, one bool per chunk — from zone-map decisions) skips
    chunks the caller proved irrelevant: skipped chunks are never read or
    decoded, and value/block accounting jumps over them so `valid` and the
    validity mask stay exact. In window mode a window decodes whole unless
    EVERY chunk in it is skippable (lockstep consumers feed every column
    the same `keep`, so the walks stay aligned).

    `natural=True` (order-insensitive consumers only: reductions, counts,
    value-domain aggregates) lets delta-family chunks keep the NATURAL
    transposed-domain image — the per-block untranspose relayout, the
    single most expensive stage of a sorted-column read, never runs
   . Values are a per-block permutation of the
    original order, so it is applied per run only when nothing positional
    rides along: no validity bitmaps and no padded tail block in the run
    (the `valid` prefix mask and `vmask` are positional)."""
    chunks, cdtype, transform, vtype, n_values, base_off, nulls_meta = \
        _column_layout(path, column)
    starts = [0]
    for m in chunks:
        starts.append(starts[-1] + m["n_blocks"])

    def _run_natural(idxs):
        if not natural or nulls_meta is not None:
            return False
        end_values = starts[idxs[-1] + 1] * layout.BLOCK
        return n_values is None or end_values <= n_values

    with open(path, "rb") as f:
        def read_cov(idxs):
            cov = []
            for i in idxs:
                meta = chunks[i]
                f.seek(base_off + meta["offset"])
                cov.append((meta, f.read(meta["nbytes"])))
            return cov

        def emit(parts, block0):
            seen_blocks = block0
            seen_values = block0 * layout.BLOCK
            for blocks in parts:
                n_blocks_here = (blocks[0] if isinstance(blocks, tuple)
                                 else blocks).shape[0]
                n_here = n_blocks_here * layout.BLOCK
                blocks = fio_device._apply_transform_device(blocks, transform,
                                                            cdtype)
                valid = n_here
                if n_values is not None:
                    valid = max(0, min(n_here, n_values - seen_values))
                seen_values += n_here
                vmask = None
                if nulls_meta is not None:
                    vmask = jnp.asarray(fio.read_validity_range(
                        path, nulls_meta, base_off, seen_blocks,
                        seen_blocks + n_blocks_here).reshape(-1))
                seen_blocks += n_blocks_here
                yield blocks, cdtype, vtype, valid, vmask

        if batch:
            runs = []  # maximal contiguous runs of kept chunk indices
            for i in range(len(chunks)):
                if keep is not None and not keep[i]:
                    continue
                if runs and runs[-1][-1] == i - 1:
                    runs[-1].append(i)
                else:
                    runs.append([i])
            for run in runs:
                subs = [run]
                if (natural and nulls_meta is None
                        and len(run) > 1 and not _run_natural(run)
                        and _run_natural(run[:-1])):
                    # only the padded tail chunk blocks natural order:
                    # split it off so the bulk still skips the untranspose
                    subs = [run[:-1], run[-1:]]
                for sub in subs:
                    parts = fio_device._decode_chunks_grouped(
                        read_cov(sub), cdtype, mesh,
                        natural=_run_natural(sub))
                    yield from emit(parts, starts[sub[0]])
        elif window:
            for i in range(0, len(chunks), window):
                idxs = range(i, min(i + window, len(chunks)))
                if keep is not None:
                    # trim the skippable prefix/suffix of the window (the
                    # interior decodes whole so the part stays one
                    # contiguous block range; lockstep columns share keep,
                    # so every column trims identically)
                    kept = [j for j in idxs if keep[j]]
                    if not kept:
                        continue
                    idxs = range(kept[0], kept[-1] + 1)
                ps = fio_device._decode_chunks_grouped(
                    read_cov(idxs), cdtype, mesh)
                yield from emit([fio_device._concat_parts(ps, cdtype)],
                                starts[idxs[0]])
        else:
            for i, meta in enumerate(chunks):
                if keep is not None and not keep[i]:
                    continue
                f.seek(base_off + meta["offset"])
                part = fio_device._decode_chunk_device(
                    meta, f.read(meta["nbytes"]), meta["n_blocks"], cdtype,
                    mesh=mesh, natural=_run_natural([i]))
                yield from emit([part], starts[i])


def _probe_epoch(path, column, value):
    """Temporal-column probes -> int64 epochs in the COLUMN's unit:
    np.datetime64/np.timedelta64 scalars (any unit) and date strings
    convert with unit scaling; plain ints pass through as raw epochs
    (the original calling convention). Non-temporal columns return the
    probe unchanged."""
    vt = _column_layout(path, column)[3]
    if not (vt or "").startswith(("datetime64", "timedelta64")):
        return value

    def one(v):
        if isinstance(v, (int, np.integer)):
            return int(v)
        return int(np.array(v, dtype=np.dtype(vt)).view("int64"))

    return [one(v) for v in value] if isinstance(value, (list, tuple)) \
        else one(value)


def _zone_decisions_col(path, column, op, value):
    """Per-chunk zone decisions ('none'/'all'/'maybe') of one predicate on
    one column (op/value already code-domain for string columns), plus the
    chunk list and n_values for 'all' accounting. Chunks without stored
    stats (pre-zone-map files) decide 'maybe'."""
    chunks, cdtype, _t, vtype, n_values, _b, _nm = _column_layout(path,
                                                                  column)
    kind = zonemaps.kind_of(cdtype, vtype)
    return zonemaps.decisions(chunks, kind, op, value), chunks, n_values


def _zone_keep(path, preds, names=()):
    """Chunk keep flags for ANDed predicates [(col, op, value)]: False
    where some predicate's zone decision is 'none' (the chunk can satisfy
    no row, so lockstep walks skip it for EVERY column). Returns None when
    nothing is skippable — or when any involved column's chunk count
    disagrees, leaving the layout mismatch to the walk's own error."""
    counts = set()
    for n in names:
        try:
            counts.add(len(_column_layout(path, n)[0]))
        except (ValueError, KeyError):
            return None
    keep = None
    for pcol, op, value in preds:
        try:
            ds, chunks, _nv = _zone_decisions_col(path, pcol, op, value)
        except (ValueError, KeyError):
            return None
        counts.add(len(chunks))
        if len(counts) > 1:
            return None
        if keep is None:
            keep = [True] * len(chunks)
        for i, d in enumerate(ds):
            if d == "none":
                keep[i] = False
    return None if keep is None or all(keep) else keep


def _str_dict_of(path: str, column: Optional[str]):
    """Sorted dictionary of a string table column, else None."""
    if column is None:
        return None
    with open(path, "rb") as f:
        magic = f.read(8)
    if not magic.startswith(b"FLTTAB1"):
        return None
    from . import fio_table

    header = fio_table.read_table_header(path)
    col = fio_table._col_meta(header, column)
    if col.get("vtype") != "str":
        return None
    with open(path, "rb") as f:
        return fio_table._load_str_dict(
            f, fio.payload_base_of(path, fio_table.MAGIC), col)


def _str_pred_to_code(dictionary: np.ndarray, op: str, value):
    """String predicate -> code-domain integer predicate. The dictionary is
    sorted ascending, so code order == lexicographic order; probes absent
    from the dictionary fold to the neighbouring threshold (eq/ne on a
    missing value become never/always: code < 0 / code >= 0)."""
    if op in _SET_OPS:  # membership probes -> present codes only
        codes = []
        for v in value:
            i = int(np.searchsorted(dictionary, str(v)))
            if i < dictionary.size and dictionary[i] == str(v):
                codes.append(i)
        return op, codes
    value = str(value)
    lo_idx = int(np.searchsorted(dictionary, value))
    exact = bool(lo_idx < dictionary.size and dictionary[lo_idx] == value)
    thr = lo_idx + (1 if exact else 0)
    if op == "lt":
        return "lt", lo_idx
    if op == "le":
        return "lt", thr
    if op == "ge":
        return "ge", lo_idx
    if op == "gt":
        return "ge", thr
    if op == "eq":
        return ("eq", lo_idx) if exact else ("lt", 0)
    if op == "ne":
        return ("ne", lo_idx) if exact else ("ge", 0)
    raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")


def _map_str_result(r: dict, dictionary: np.ndarray) -> dict:
    """Code-domain stats of a string column -> user-facing stats: min/max
    become the lexicographic extreme strings; a sum of codes is meaningless
    and reports None."""
    has = r["count"] > 0
    return {"sum": None,
            "min": str(dictionary[int(r["min"])]) if has else None,
            "max": str(dictionary[int(r["max"])]) if has else None,
            "count": r["count"], "n_dict": int(dictionary.size)}


def _flatten_logical(blocks, cdtype, vtype):
    """Device blocks -> flat logical vector for reductions.

    u64 INTEGER columns stay in the (lo, hi) uint32 plane domain (x64-free;
    the limb kernels below reduce them exactly — and the planes arrive
    straight from the decoder without an interleaving stack). f64 columns
    return the ("f64", lo, hi) marker for the exact limb-domain kernels —
    float64 arrays (x64 jax) are bitcast back to limbs so the SAME exact
    path runs regardless of the x64 flag."""
    if isinstance(blocks, tuple) or type(blocks).__name__ == "LimbPlanes":
        lo, hi = blocks if isinstance(blocks, tuple) else (blocks.lo, blocks.hi)
        if vtype == "f64":
            return ("f64", lo.reshape(-1), hi.reshape(-1))
        return lo.reshape(-1), hi.reshape(-1)
    arr = blocks
    if arr.dtype == jnp.float64:  # x64 jax: route through the exact path too
        bits = jax.lax.bitcast_convert_type(arr.reshape(-1), jnp.uint32)
        return ("f64", bits[..., 0], bits[..., 1])
    if arr.dtype == jnp.float32:  # exact superaccumulator path (single limb)
        return ("f32",
                jax.lax.bitcast_convert_type(arr.reshape(-1), jnp.uint32))
    if cdtype == "u64" and arr.ndim >= 2 and arr.shape[-1] == 2 and (
            arr.dtype == jnp.uint32):
        if vtype == "f64":
            # f64 bit planes, reduced EXACTLY in the limb domain (x64-free:
            # _stats_kernel_f64 superaccumulator / total-order keys)
            return ("f64", arr.reshape(-1, 2)[..., 0],
                    arr.reshape(-1, 2)[..., 1])
        return arr.reshape(-1, 2)[..., 0], arr.reshape(-1, 2)[..., 1]
    return arr.reshape(-1)


_PIECE = 32768  # piece-sum length: 32768 * (2^16 - 1) < 2^31, no overflow


def _iota_ok(n, v):
    return jnp.arange(n) < v


def _stats_core(x, ok):
    """Masked sum/min/max, one fused program per input shape/dtype
    (module-level jit entries below: repeated chunks hit the cache). `ok`
    masks tail padding AND (on the scan_where path) predicate misses.

    Integer sums are EXACT WITHOUT x64: the masked values bitcast to the
    unsigned domain and split into 16-bit halves summed per 32768-element
    piece (each partial < 2^31); the host reassembles the big-int total
    and corrects signed columns by 2^T * n_negative (two's complement).
    Returns (lo_sums, hi_sums, n_neg, mn, mx); float dtypes return the
    fused float total in lo_sums[0:1]."""
    n = x.shape[0]
    if jnp.issubdtype(x.dtype, jnp.floating):
        big = jnp.asarray(jnp.inf, x.dtype)
        total = jnp.sum(jnp.where(ok, x, jnp.asarray(0, x.dtype)))
        mn = jnp.min(jnp.where(ok, x, big))
        mx = jnp.max(jnp.where(ok, x, -big))
        z = jnp.zeros((1,), jnp.uint32)
        return total[None][None], z, jnp.int32(0), mn, mx
    info = jnp.iinfo(x.dtype)
    mn = jnp.min(jnp.where(ok, x, jnp.asarray(info.max, x.dtype)))
    mx = jnp.max(jnp.where(ok, x, jnp.asarray(info.min, x.dtype)))
    signed = jnp.issubdtype(x.dtype, jnp.signedinteger)
    n_neg = (jnp.sum((ok & (x < 0)).astype(jnp.int32)) if signed
             else jnp.int32(0))
    t = x.dtype.itemsize * 8
    xu = jax.lax.bitcast_convert_type(
        jnp.where(ok, x, jnp.asarray(0, x.dtype)), jnp.dtype(f"uint{t}"))
    pad = (-n) % _PIECE
    if pad:
        xu = jnp.concatenate([xu, jnp.zeros(pad, xu.dtype)])
    pieces = xu.reshape(-1, _PIECE)
    # one 16-bit plane per 16 bits of the dtype (u8/u16 fit one plane),
    # each piece-sum < 2^31; mask/shift stay inside the dtype's width
    planes = []
    pmask = jnp.asarray(min(0xFFFF, info.max - info.min), xu.dtype)
    for k in range(max(1, t // 16)):
        part = ((pieces >> jnp.asarray(16 * k, xu.dtype)) & pmask
                ).astype(jnp.uint32)
        planes.append(jnp.sum(part, axis=1, dtype=jnp.uint32))
    return jnp.stack(planes), jnp.zeros((1,), jnp.uint32), n_neg, mn, mx


_stats_kernel = jax.jit(
    lambda x, v: _stats_core(x, _iota_ok(x.shape[0], v)))
_stats_kernel_pred = jax.jit(
    lambda x, v, pred: _stats_core(x, _iota_ok(x.shape[0], v) & pred))


def _stats_core_u64(lo, hi, ok):
    """u64 limb-domain twin of _stats_core, x64-free and EXACT: four
    16-bit planes summed per piece (big-int reassembly on the host), and
    min/max by signed-int64 order computed lexicographically on
    (sign-flipped hi, lo) — matching the int64 semantics of the x64 path
    (unsigned columns >= 2^63 appear negative; recovered by the caller's
    two's-complement reconstruction). Takes separate planes (the decoder's
    native output form — no interleave anywhere on the path)."""
    n = lo.shape[0]
    lo = jnp.where(ok, lo, jnp.uint32(0))
    hi = jnp.where(ok, hi, jnp.uint32(0))
    n_neg = jnp.sum(((hi >> 31) & 1).astype(jnp.int32))
    # signed order key: flip the sign bit of hi, compare (key, lo) lexicographic
    key = hi ^ jnp.uint32(0x80000000)
    big = jnp.uint32(0xFFFFFFFF)
    key_mn = jnp.where(ok, key, big)
    key_mx = jnp.where(ok, key, jnp.uint32(0))
    kmn = jnp.min(key_mn)
    kmx = jnp.max(key_mx)
    mn_lo = jnp.min(jnp.where(ok & (key == kmn), lo, big))
    mx_lo = jnp.max(jnp.where(ok & (key == kmx), lo, jnp.uint32(0)))
    # exact sum: 16-bit planes over both limbs
    pad = (-n) % _PIECE
    if pad:
        lo = jnp.concatenate([lo, jnp.zeros(pad, jnp.uint32)])
        hi = jnp.concatenate([hi, jnp.zeros(pad, jnp.uint32)])
    planes = []
    for src, base in ((lo, 0), (hi, 2)):
        pieces = src.reshape(-1, _PIECE)
        for k in range(2):
            part = (pieces >> jnp.uint32(16 * k)) & jnp.uint32(0xFFFF)
            planes.append(jnp.sum(part, axis=1, dtype=jnp.uint32))
    return jnp.stack(planes), n_neg, kmn, mn_lo, kmx, mx_lo


_stats_kernel_u64 = jax.jit(
    lambda lo, hi, v: _stats_core_u64(lo, hi, _iota_ok(lo.shape[0], v)))
_stats_kernel_u64_pred = jax.jit(
    lambda lo, hi, v, pred: _stats_core_u64(
        lo, hi, _iota_ok(lo.shape[0], v) & pred))


def _i64_of(key: int, lo: int) -> int:
    """(sign-flipped hi key, lo) -> python int with int64 semantics."""
    u = ((key ^ 0x80000000) << 32) | lo
    return u - (1 << 64) if u >= (1 << 63) else u


# ---------------------------------------------------------------------------
# Exact f64 analytics in the uint32 limb domain (x64-FREE: x64 is
# process-global in JAX). A float64 is (-1)^s * m * 2^(E'-1075) with E' = max(E, 1)
# and m the 52-bit fraction plus the implicit bit when E > 0. Writing
# E' = 16*b + r (bucket b in [0, 128], r in [0, 16)), the EXACT column sum
# is a SUPERACCUMULATOR:
#
#   sum = ( sum_{s,b,k} +-BIN[s,b,k] * 2^(16*(b+k)) ) * 2^-1075
#
# where BIN accumulates the k-th 16-bit plane of m << r per sign/bucket —
# pure uint32 shifts/adds/scatter-adds on device, big-int reassembly on the
# host and ONE correctly-rounded Fraction->float conversion. The result is
# the EXACTLY ROUNDED sum (stronger than float64 accumulation, which drifts
# with length). min/max ride the IEEE total-order key (sign-flip for
# positives, full complement for negatives); NaN/+-inf are counted apart
# and resolved on the host with numpy semantics.

_F64_BUCKETS = 129          # E' // 16 for E' in [1, 2046]
_F64_BINS = 2 * _F64_BUCKETS * 5


def _f64_key(lo, hi):
    """IEEE-754 total-order key: lexicographic uint (key_hi, key_lo)
    compare == numeric order (with -0.0 < +0.0; NaNs at the extremes —
    callers mask them)."""
    neg = (hi >> jnp.uint32(31)) == jnp.uint32(1)
    key_hi = jnp.where(neg, ~hi, hi ^ jnp.uint32(0x80000000))
    key_lo = jnp.where(neg, ~lo, lo)
    return key_hi, key_lo


def _stats_core_f64(lo, hi, ok):
    """Exact limb-domain f64 stats. Returns (bins (P, _F64_BINS) uint32,
    n_nan, n_pinf, n_ninf, n_key, kmn_hi, kmn_lo, kmx_hi, kmx_lo)."""
    u32 = jnp.uint32
    n = lo.shape[0]
    lo = jnp.where(ok, lo, u32(0))
    hi = jnp.where(ok, hi, u32(0))  # padding = +0.0: zero planes, masked keys
    sign = hi >> u32(31)
    E = (hi >> u32(20)) & u32(0x7FF)
    frac_hi = hi & u32(0xFFFFF)
    special = E == u32(2047)
    is_nan = special & ((frac_hi != u32(0)) | (lo != u32(0))) & ok
    is_inf = special & (frac_hi == u32(0)) & (lo == u32(0)) & ok
    n_nan = jnp.sum(is_nan.astype(jnp.int32))
    n_pinf = jnp.sum((is_inf & (sign == u32(0))).astype(jnp.int32))
    n_ninf = jnp.sum((is_inf & (sign == u32(1))).astype(jnp.int32))
    # finite superaccumulator contribution: 3-limb m << (E' % 16)
    fin = ok & ~special
    Ep = jnp.maximum(E, u32(1))
    m_lo = jnp.where(fin, lo, u32(0))
    m_hi = jnp.where(fin, frac_hi | jnp.where(E > u32(0), u32(1 << 20),
                                              u32(0)), u32(0))
    r = Ep & u32(15)
    sh_back = (u32(32) - r) & u32(31)
    lo_carry = jnp.where(r == u32(0), u32(0), m_lo >> sh_back)
    hi_carry = jnp.where(r == u32(0), u32(0), m_hi >> sh_back)
    m0 = m_lo << r
    m1 = (m_hi << r) | lo_carry
    m2 = hi_carry                      # m' < 2^68 -> m2 < 2^16
    planes = (m0 & u32(0xFFFF), m0 >> u32(16),
              m1 & u32(0xFFFF), m1 >> u32(16), m2)
    bucket = (Ep >> u32(4)).astype(jnp.int32)
    base_idx = jnp.where(fin, sign.astype(jnp.int32) * (_F64_BUCKETS * 5)
                         + bucket * 5, jnp.int32(0))
    # per-piece scatter-add: each bin gathers <= _PIECE values of < 2^16,
    # so every partial stays < 2^31 (the same bound as _stats_kernel);
    # non-finite/padded lanes scatter zeros into bin 0
    pad = (-n) % _PIECE
    idx5, pl5 = [], []
    for k, p in enumerate(planes):
        idx5.append(base_idx + k)
        pl5.append(p)
    idx = jnp.concatenate([jnp.pad(i, (0, pad)) for i in idx5])
    pl = jnp.concatenate([jnp.pad(p, (0, pad)) for p in pl5])
    idx = idx.reshape(5, -1, _PIECE).transpose(1, 0, 2).reshape(-1, 5 * _PIECE)
    pl = pl.reshape(5, -1, _PIECE).transpose(1, 0, 2).reshape(-1, 5 * _PIECE)
    bins = jax.vmap(lambda i, p: jnp.zeros((_F64_BINS,), u32).at[i].add(p))(
        idx, pl)
    # total-order min/max over comparable (non-NaN, in-range) values
    key_hi, key_lo = _f64_key(lo, hi)
    kok = ok & ~is_nan
    n_key = jnp.sum(kok.astype(jnp.int32))
    ones = u32(0xFFFFFFFF)
    kh_mn = jnp.min(jnp.where(kok, key_hi, ones))
    kl_mn = jnp.min(jnp.where(kok & (key_hi == kh_mn), key_lo, ones))
    kh_mx = jnp.max(jnp.where(kok, key_hi, u32(0)))
    kl_mx = jnp.max(jnp.where(kok & (key_hi == kh_mx), key_lo, u32(0)))
    return bins, n_nan, n_pinf, n_ninf, n_key, kh_mn, kl_mn, kh_mx, kl_mx


_stats_kernel_f64 = jax.jit(
    lambda lo, hi, v: _stats_core_f64(lo, hi, _iota_ok(lo.shape[0], v)))
_stats_kernel_f64_pred = jax.jit(
    lambda lo, hi, v, pred: _stats_core_f64(
        lo, hi, _iota_ok(lo.shape[0], v) & pred))


def _f64_of_key(khi: int, klo: int) -> float:
    """Inverse of _f64_key on host ints -> python float."""
    import struct

    if khi >> 31:
        hi, lo = khi ^ 0x80000000, klo
    else:
        hi, lo = ~khi & 0xFFFFFFFF, ~klo & 0xFFFFFFFF
    return struct.unpack("<d", struct.pack("<II", lo, hi))[0]


def _f64_bins_to_int(bins_np: np.ndarray) -> int:
    """(P, _F64_BINS) uint32 partials -> signed big-int numerator (in units
    of 2^-1075)."""
    per_bin = bins_np.astype(np.int64).sum(axis=0)
    num = 0
    half = _F64_BUCKETS * 5
    for s, sgn in ((0, 1), (1, -1)):
        for j in range(half):
            c = int(per_bin[s * half + j])
            if c:
                b, k = divmod(j, 5)
                num += sgn * (c << (16 * (b + k)))
    return num


# f32 twin: value = (-1)^s * m * 2^(E'-150), m < 2^24, E' = max(E, 1) in
# [1, 254] -> buckets E'//16 in [0, 15], m << (E'%16) < 2^39 -> 3 planes.
_F32_BUCKETS = 16
_F32_BINS = 2 * _F32_BUCKETS * 3


def _stats_core_f32(bits, ok):
    """Exact f32 stats from the raw uint32 bit pattern: superaccumulator
    bins (exact sum in units of 2^-150) + total-order keys. Returns
    (bins (P, _F32_BINS), n_nan, n_pinf, n_ninf, n_key, kmn, kmx)."""
    u32 = jnp.uint32
    n = bits.shape[0]
    bits = jnp.where(ok, bits, u32(0))
    sign = bits >> u32(31)
    E = (bits >> u32(23)) & u32(0xFF)
    frac = bits & u32(0x7FFFFF)
    special = E == u32(255)
    is_nan = special & (frac != u32(0)) & ok
    is_inf = special & (frac == u32(0)) & ok
    n_nan = jnp.sum(is_nan.astype(jnp.int32))
    n_pinf = jnp.sum((is_inf & (sign == u32(0))).astype(jnp.int32))
    n_ninf = jnp.sum((is_inf & (sign == u32(1))).astype(jnp.int32))
    fin = ok & ~special
    Ep = jnp.maximum(E, u32(1))
    m = jnp.where(fin, frac | jnp.where(E > u32(0), u32(1 << 23), u32(0)),
                  u32(0))
    r = Ep & u32(15)
    m0 = m << r                        # low 32 of m' < 2^39
    m2 = jnp.where(r == u32(0), u32(0), m >> ((u32(32) - r) & u32(31)))
    planes = (m0 & u32(0xFFFF), m0 >> u32(16), m2)
    bucket = (Ep >> u32(4)).astype(jnp.int32)
    base_idx = jnp.where(fin, sign.astype(jnp.int32) * (_F32_BUCKETS * 3)
                         + bucket * 3, jnp.int32(0))
    pad = (-n) % _PIECE
    idx = jnp.concatenate([jnp.pad(base_idx + k, (0, pad))
                           for k in range(3)])
    pl = jnp.concatenate([jnp.pad(p, (0, pad)) for p in planes])
    idx = idx.reshape(3, -1, _PIECE).transpose(1, 0, 2).reshape(-1, 3 * _PIECE)
    pl = pl.reshape(3, -1, _PIECE).transpose(1, 0, 2).reshape(-1, 3 * _PIECE)
    bins = jax.vmap(lambda i, p: jnp.zeros((_F32_BINS,), u32).at[i].add(p))(
        idx, pl)
    neg = sign == u32(1)
    key = jnp.where(neg, ~bits, bits ^ u32(0x80000000))
    kok = ok & ~is_nan
    n_key = jnp.sum(kok.astype(jnp.int32))
    kmn = jnp.min(jnp.where(kok, key, u32(0xFFFFFFFF)))
    kmx = jnp.max(jnp.where(kok, key, u32(0)))
    return bins, n_nan, n_pinf, n_ninf, n_key, kmn, kmx


_stats_kernel_f32 = jax.jit(
    lambda bits, v: _stats_core_f32(bits, _iota_ok(bits.shape[0], v)))
_stats_kernel_f32_pred = jax.jit(
    lambda bits, v, pred: _stats_core_f32(
        bits, _iota_ok(bits.shape[0], v) & pred))


def _f32_of_key(k: int) -> float:
    import struct

    b = (k ^ 0x80000000) if k >> 31 else (~k & 0xFFFFFFFF)
    return struct.unpack("<f", struct.pack("<I", b))[0]


def _f32_bins_to_int(bins_np: np.ndarray) -> int:
    per_bin = bins_np.astype(np.int64).sum(axis=0)
    num = 0
    half = _F32_BUCKETS * 3
    for s, sgn in ((0, 1), (1, -1)):
        for j in range(half):
            c = int(per_bin[s * half + j])
            if c:
                b, k = divmod(j, 3)
                num += sgn * (c << (16 * (b + k)))
    return num


@functools.partial(jax.jit, static_argnames=("op",))
def _hit_f32(bits, vkey, op):
    """f32 predicate mask on total-order keys — integer compares, so
    subnormals keep numpy semantics (XLA float compares flush them to
    zero); NaN matches only 'ne', -0.0 == +0.0."""
    u32 = jnp.uint32
    E = (bits >> u32(23)) & u32(0xFF)
    is_nan = (E == u32(255)) & ((bits & u32(0x7FFFFF)) != u32(0))
    bits_c = jnp.where(bits == u32(0x80000000), u32(0), bits)  # -0.0 -> +0.0
    neg = (bits_c >> u32(31)) == u32(1)
    key = jnp.where(neg, ~bits_c, bits_c ^ u32(0x80000000))
    lt = key < vkey
    eq = key == vkey
    hit = {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt,
           "eq": eq, "ne": ~eq}[op]
    return (hit | is_nan) if op == "ne" else (hit & ~is_nan)


@functools.partial(jax.jit, static_argnames=("op",))
def _hit_f64(lo, hi, vkhi, vklo, op):
    """f64 limb predicate mask with numpy comparison semantics: NaN
    positions match only 'ne'; -0.0 == +0.0 (zeros normalized before the
    total-order key)."""
    u32 = jnp.uint32
    E = (hi >> u32(20)) & u32(0x7FF)
    frac_hi = hi & u32(0xFFFFF)
    is_nan = (E == u32(2047)) & ((frac_hi != u32(0)) | (lo != u32(0)))
    negz = (hi == u32(0x80000000)) & (lo == u32(0))
    hi_c = jnp.where(negz, u32(0), hi)
    lo_c = jnp.where(negz, u32(0), lo)
    key_hi, key_lo = _f64_key(lo_c, hi_c)
    lt = (key_hi < vkhi) | ((key_hi == vkhi) & (key_lo < vklo))
    eq = (key_hi == vkhi) & (key_lo == vklo)
    hit = {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt,
           "eq": eq, "ne": ~eq}[op]
    return (hit | is_nan) if op == "ne" else (hit & ~is_nan)


@functools.partial(jax.jit, static_argnames=("op",))
def _hit_u64(lo, hi, vkey, vlo, op):
    """u64 limb predicate mask: signed-int64 compare evaluated
    lexicographically on (sign-flipped hi, lo) without 64-bit ints."""
    key = hi ^ jnp.uint32(0x80000000)
    lt = (key < vkey) | ((key == vkey) & (lo < vlo))
    eq = (key == vkey) & (lo == vlo)
    return {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt,
            "eq": eq, "ne": ~eq}[op]


@functools.partial(jax.jit, static_argnames=("op",))
def _hit_int(x, value, op):
    return _PREDS[op](x, value.astype(x.dtype))


@jax.jit
def _hit_in_sorted(x, sset):
    """Membership of x in a sorted device set (ints <= 32 bits): one
    searchsorted + one gather — scales to large IN lists."""
    i = jnp.clip(jnp.searchsorted(sset, x), 0, sset.shape[0] - 1)
    return sset[i] == x


def _membership_mask(flat, values, negate: bool):
    """IN / NOT IN over any value domain. Integer domains use a sorted
    device set; float and u64 limb domains OR per-probe equality masks
    (IN lists are short; every probe reuses the exact eq semantics —
    -0.0 == +0.0, NaN probes match nothing)."""
    vals = list(values)
    if isinstance(flat, tuple):
        m = jnp.zeros((_flat_len(flat),), bool)
        for v in vals:
            m = m | _pred_mask(flat, "eq", v)
        return ~m if negate else m
    info = np.iinfo(np.dtype(flat.dtype.name))
    keep = sorted({int(v) for v in vals
                   if info.min <= int(v) <= info.max})
    if not keep:
        m = jnp.zeros((flat.shape[0],), bool)
    else:
        sset = jnp.asarray(np.asarray(keep, np.dtype(flat.dtype.name)))
        m = _hit_in_sorted(flat, sset)
    return ~m if negate else m


def _pred_mask(flat, op, value):
    """Predicate hit mask (device bool array) over a flattened chunk, any
    domain — the probe value is key-encoded on the host to match the
    chunk's comparison domain."""
    import math
    import struct

    if op in _SET_OPS:
        return _membership_mask(flat, value, op == "notin")

    if isinstance(flat, tuple) and isinstance(flat[0], str):
        n = flat[1].shape[0]
        v = float(value)
        if math.isnan(v):  # numpy: NaN matches only 'ne', everywhere
            return jnp.full((n,), op == "ne")
        if flat[0] == "f32":
            vb = struct.unpack("<I", struct.pack(
                "<f", 0.0 if v == 0 else np.float32(v)))[0]
            vkey = (~vb & 0xFFFFFFFF) if vb >> 31 else (vb ^ 0x80000000)
            return _hit_f32(flat[1], jnp.uint32(vkey), op)
        vb = struct.unpack("<Q", struct.pack("<d", 0.0 if v == 0 else v))[0]
        vlo, vhi = vb & 0xFFFFFFFF, vb >> 32
        vkhi, vklo = ((~vhi & 0xFFFFFFFF, ~vlo & 0xFFFFFFFF) if vb >> 63
                      else (vhi ^ 0x80000000, vlo))
        return _hit_f64(flat[1], flat[2], jnp.uint32(vkhi), jnp.uint32(vklo),
                        op)
    if isinstance(flat, tuple):  # u64 integer limb planes
        u = int(value) & ((1 << 64) - 1)  # two's-complement bit pattern
        vkey = jnp.uint32(((u >> 32) ^ 0x80000000) & 0xFFFFFFFF)
        vlo = jnp.uint32(u & 0xFFFFFFFF)
        return _hit_u64(flat[0], flat[1], vkey, vlo, op)
    # probes outside the column dtype's range fold to constants on the host
    # (no 64-bit device ints without x64)
    info = np.iinfo(np.dtype(flat.dtype.name))
    v = int(value)
    if v > info.max or v < info.min:
        every = (v > info.max and op in ("lt", "le", "ne")) or \
                (v < info.min and op in ("gt", "ge", "ne"))
        return jnp.full((flat.shape[0],), every)
    return _hit_int(flat, jnp.asarray(np.dtype(flat.dtype.name).type(value)),
                    op)


_count_masked = jax.jit(lambda mask, v: jnp.sum(
    (_iota_ok(mask.shape[0], v) & mask).astype(jnp.int32)))


def _flat_len(flat) -> int:
    """Row count of a flattened chunk in any domain (marker tuples carry
    the array at index 1; (lo, hi) limb pairs are equal length)."""
    return (flat[1] if isinstance(flat, tuple) else flat).shape[0]


def _combine_sum(planes, _unused, n_neg, dtype_bits, is_float):
    if is_float:
        return float(planes.reshape(-1)[0])
    total = 0
    for k in range(planes.shape[0]):
        total += int(np.sum(np.asarray(planes[k], np.int64))) << (16 * k)
    return total - (int(n_neg) << dtype_bits)


def _merge_extreme(cur, new, op):
    """NaN-sticky cross-chunk min/max merge (python min/max with NaN is
    order-dependent; numpy semantics propagate it)."""
    import math

    if cur is None:
        return new
    if isinstance(cur, float) and math.isnan(cur):
        return cur
    if isinstance(new, float) and math.isnan(new):
        return new
    return op(cur, new)


class _StatAcc:
    """Running sum/min/max/count accumulator fed one decoded chunk at a
    time — the shared core of scan_column and scan_table."""

    def __init__(self):
        self.total = 0
        self.mn = None
        self.mx = None
        self.count = 0
        # exact-float state (f32/f64 columns): big-int superaccumulator
        # numerator (units of 2^-150 / 2^-1075), special counts, total-order
        # keys (int tuples — lexicographic compare == numeric order)
        self.float_kind = None
        self.float_num = 0
        self.n_nan = 0
        self.n_pinf = 0
        self.n_ninf = 0
        self.kmn = None
        self.kmx = None

    def feed(self, blocks, cdtype, vtype, valid, pred=None):
        """Accumulate one decoded chunk; `pred` (device bool array aligned
        with the flattened chunk) restricts to matching rows — the
        scan_where path. `count` counts CONTRIBUTING rows."""
        if valid == 0:
            return
        flat = _flatten_logical(blocks, cdtype, vtype)
        self.feed_flat(flat, valid, pred)

    def feed_flat(self, flat, valid, pred=None):
        v = jnp.int32(valid)
        n_ok = valid if pred is None else int(_count_masked(pred, v))
        if isinstance(flat, tuple) and isinstance(flat[0], str):
            if flat[0] == "f64":
                self._feed_f64(flat[1], flat[2], v, pred)
            else:
                self._feed_f32(flat[1], v, pred)
            self.count += n_ok
            return
        if n_ok == 0:  # int domains: nothing contributes, keep neutrals out
            return
        if isinstance(flat, tuple):  # u64 integer limb planes (x64-free exact)
            planes, n_neg, kmn, mn_lo, kmx, mx_lo = (
                _stats_kernel_u64(flat[0], flat[1], v) if pred is None
                else _stats_kernel_u64_pred(flat[0], flat[1], v, pred))
            self.total += _combine_sum(np.asarray(planes), None, int(n_neg),
                                       64, False)
            m1 = _i64_of(int(kmn), int(mn_lo))
            m2 = _i64_of(int(kmx), int(mx_lo))
        else:
            planes, _z, n_neg, m1, m2 = (
                _stats_kernel(flat, v) if pred is None
                else _stats_kernel_pred(flat, v, pred))
            is_float = np.issubdtype(np.asarray(m1).dtype, np.floating)
            self.total += _combine_sum(np.asarray(planes), None, int(n_neg),
                                       np.asarray(flat).dtype.itemsize * 8
                                       if not is_float else 0, is_float)
            m1, m2 = m1.item(), m2.item()
        self.mn = _merge_extreme(self.mn, m1, min)
        self.mx = _merge_extreme(self.mx, m2, max)
        self.count += n_ok

    def _feed_f64(self, lo, hi, v, pred=None):
        self.float_kind = "f64"
        (bins, n_nan, n_pinf, n_ninf, n_key,
         kh_mn, kl_mn, kh_mx, kl_mx) = (
            _stats_kernel_f64(lo, hi, v) if pred is None
            else _stats_kernel_f64_pred(lo, hi, v, pred))
        self._merge_float(_f64_bins_to_int(np.asarray(bins)), n_nan, n_pinf,
                          n_ninf, n_key, (int(kh_mn), int(kl_mn)),
                          (int(kh_mx), int(kl_mx)))

    def _feed_f32(self, bits, v, pred=None):
        self.float_kind = "f32"
        bins, n_nan, n_pinf, n_ninf, n_key, kmn, kmx = (
            _stats_kernel_f32(bits, v) if pred is None
            else _stats_kernel_f32_pred(bits, v, pred))
        self._merge_float(_f32_bins_to_int(np.asarray(bins)), n_nan, n_pinf,
                          n_ninf, n_key, (int(kmn),), (int(kmx),))

    def _merge_float(self, num, n_nan, n_pinf, n_ninf, n_key, kmn, kmx):
        self.float_num += num
        self.n_nan += int(n_nan)
        self.n_pinf += int(n_pinf)
        self.n_ninf += int(n_ninf)
        if int(n_key):  # chunk had comparable values: merge total-order keys
            self.kmn = kmn if self.kmn is None else min(self.kmn, kmn)
            self.kmx = kmx if self.kmx is None else max(self.kmx, kmx)

    def result(self) -> dict:
        if self.float_kind is None:
            return {"sum": self.total, "min": self.mn, "max": self.mx,
                    "count": self.count}
        from fractions import Fraction

        denom_bits = 1075 if self.float_kind == "f64" else 150
        of_key = (_f64_of_key if self.float_kind == "f64"
                  else lambda k: _f32_of_key(k))
        if self.n_nan or (self.n_pinf and self.n_ninf):
            total = float("nan")
        elif self.n_pinf:
            total = float("inf")
        elif self.n_ninf:
            total = float("-inf")
        else:
            total = (float(Fraction(self.float_num, 1 << denom_bits))
                     if self.float_num else 0.0)
        if self.n_nan:
            mn = mx = float("nan")
        else:
            mn = of_key(*self.kmn) if self.kmn is not None else None
            mx = of_key(*self.kmx) if self.kmx is not None else None
        return {"sum": total, "min": mn, "max": mx, "count": self.count}


def scan_column(path: str, column: Optional[str] = None, mesh=None) -> dict:
    """Fused sum/min/max/count over a compressed column — the decoded data
    never materializes in HBM for fusable codecs. Returns python scalars:
    {sum, min, max, count}."""
    paths = _paths(path)
    if len(paths) > 1 and _str_dict_of(paths[0], column) is not None:
        return _merge_str_stats([scan_column(p, column, mesh)
                                 for p in paths])
    acc = _StatAcc()
    n_null = 0
    any_null = False
    for p in paths:
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                p, column, mesh, natural=True):
            acc.feed(blocks, cdtype, vtype, valid, pred=vmask)
        nulls_meta = _column_layout(p, column)[6]
        if nulls_meta is not None:
            any_null = True
            n_null += int(nulls_meta["n_null"])
    d = _str_dict_of(paths[0], column)
    r = _map_str_result(acc.result(), d) if d is not None else acc.result()
    if any_null:
        r["n_null"] = n_null
    return r


def scan_table(path: str, columns=None, mesh=None) -> dict:
    """Single-pass fused stats over several (default: all) columns of an
    FLTTAB table file: the header parses once and every selected chunk is
    visited in payload-offset order, so the file is read sequentially
    exactly once no matter how many columns are scanned — the multi-column
    analogue of Vortex-style projection pushdown over the reference's block
    codecs (reference macros.rs:5-9 fusion invariant per chunk). Returns
    {column_name: {sum, min, max, count}}."""
    from . import fio_table

    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: per-column dataset scans
        header = fio_table.read_table_header(paths[0])
        names = list(header["columns"]) if columns is None else list(columns)
        return {name: scan_column(paths, name, mesh) for name in names}
    path = paths[0]
    header = fio_table.read_table_header(path)
    names = list(header["columns"]) if columns is None else list(columns)
    cols = {name: fio_table._col_meta(header, name) for name in names}

    # Columns' payloads are laid out sequentially (write_table appends one
    # column's chunks after another), so scanning columns in first-chunk
    # offset order IS one sequential pass over the file; within a column
    # the batched generator merges same-signature chunks into one dispatch.
    names.sort(key=lambda n: cols[n]["chunks"][0]["offset"]
               if cols[n]["chunks"] else 0)
    out = {}
    for name in names:
        acc = _StatAcc()
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, name, mesh, natural=True):
            acc.feed(blocks, cdtype, vtype, valid, pred=vmask)
        d = _str_dict_of(path, name)
        r = (_map_str_result(acc.result(), d) if d is not None
             else acc.result())
        nulls_meta = cols[name].get("nulls")
        if nulls_meta is not None:
            r["n_null"] = int(nulls_meta["n_null"])
        out[name] = r
    return out


def count_where(path: str, op: str, value, column: Optional[str] = None,
                mesh=None) -> int:
    """Fused filtered count: predicate evaluated on decoded values
    in-graph, only the running count leaves the device."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    total = 0
    for p in _paths(path):
        d = _str_dict_of(p, column)
        # string column: the predicate pushes down on THIS file's codes
        op_p, value_p = ((op, _probe_epoch(p, column, value)) if d is None
                         else _str_pred_to_code(d, op, value))
        # zone maps: 'none' chunks skip decode, 'all' chunks resolve from
        # the header alone (chunk row count minus its nulls)
        ds, chunks, n_values = _zone_decisions_col(p, column, op_p, value_p)
        keep, start_v = [], 0
        for meta, dec in zip(chunks, ds):
            cap = meta["n_blocks"] * layout.BLOCK
            n_chunk = cap if n_values is None else max(
                0, min(cap, n_values - start_v))
            start_v += cap
            if dec == "all":
                total += n_chunk - meta.get("stats", {}).get("nn", 0)
            keep.append(dec == "maybe")
        if not any(keep):
            continue
        if all(keep):
            keep = None
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                p, column, mesh, keep=keep, natural=True):
            if valid == 0:
                continue
            flat = _flatten_logical(blocks, cdtype, vtype)
            mask = _pred_mask(flat, op_p, value_p)
            if vmask is not None:  # nulls match no predicate (not even 'ne')
                mask = mask & vmask
            total += int(_count_masked(mask, jnp.int32(valid)))
    return total


def scan_where(path: str, op: str, value, column: Optional[str] = None,
               where: Optional[str] = None, mesh=None) -> dict:
    """Filtered aggregation — selection + aggregation pushdown in one pass:
    sum/min/max/count over the rows matching `OP value`, decoded and
    reduced on device per chunk (sums stay exact: the predicate just masks
    the superaccumulator / plane reduction). `where` names the predicate
    column for table files (default: the aggregated column itself); a
    cross-column predicate requires the two columns to share block layout
    (equal length and chunking — the writer's default for equal-length
    columns). Returns {sum, min, max, count} over matching rows."""
    if op not in _ALL_OPS:
        raise ValueError(f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
    paths = _paths(path)
    vdict0 = _str_dict_of(paths[0], column)
    if len(paths) > 1 and vdict0 is not None:
        return _merge_str_stats([scan_where(p, op, value, column, where,
                                            mesh) for p in paths])
    acc = _StatAcc()
    for p in paths:
        _scan_where_into(acc, p, op, value, column, where, mesh)
    return (_map_str_result(acc.result(), vdict0) if vdict0 is not None
            else acc.result())


def _scan_where_into(acc, path, op, value, column, where, mesh):
    """One file's worth of filtered aggregation fed into a shared
    accumulator (string predicates translate against THIS file's
    dictionary)."""
    vdict = _str_dict_of(path, column)
    wdict = (vdict if where is None or where == column
             else _str_dict_of(path, where))
    if wdict is not None:  # string predicate column: compare codes
        op, value = _str_pred_to_code(wdict, op, value)
    else:
        value = _probe_epoch(path, where if where is not None else column,
                             value)

    if where is None or where == column:
        keep = _zone_keep(path, [(column, op, value)])
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, column, mesh, keep=keep, natural=True):
            if valid == 0:
                continue
            flat = _flatten_logical(blocks, cdtype, vtype)
            pred = _pred_mask(flat, op, value)
            if vmask is not None:  # null rows neither match nor aggregate
                pred = pred & vmask
            acc.feed_flat(flat, valid, pred)
        return
    # cross-column predicate: walk both chunk streams in lockstep (both
    # sides share the zone-map keep so the walks stay aligned)
    keep = _zone_keep(path, [(where, op, value)], names=(column, where))
    vals = _decoded_chunks(path, column, mesh, batch=False,
                           window=_LOCKSTEP_WINDOW, keep=keep)
    preds = _decoded_chunks(path, where, mesh, batch=False,
                            window=_LOCKSTEP_WINDOW, keep=keep)
    for (vb, vdt, vvt, v_valid, v_mask), (wb, wdt, wvt, w_valid, w_mask) in \
            zip(vals, preds):
        flat_v = _flatten_logical(vb, vdt, vvt)
        flat_w = _flatten_logical(wb, wdt, wvt)
        n_v, n_w = _flat_len(flat_v), _flat_len(flat_w)
        if n_v != n_w or v_valid != w_valid:
            raise ValueError(
                f"columns {column!r} and {where!r} have mismatched chunk "
                f"layouts ({n_v}/{v_valid} vs {n_w}/{w_valid} values); "
                "cross-column scan_where needs equal length and chunking")
        if v_valid == 0:
            continue
        pred = _pred_mask(flat_w, op, value)
        if w_mask is not None:  # null predicate rows match nothing
            pred = pred & w_mask
        if v_mask is not None:  # null values don't aggregate (SQL SUM(col))
            pred = pred & v_mask
        acc.feed_flat(flat_v, v_valid, pred)
    # unequal chunk counts (zip stops early) count as mismatched layouts
    if next(vals, None) is not None or next(preds, None) is not None:
        raise ValueError(
            f"columns {column!r} and {where!r} have different chunk counts; "
            "cross-column scan_where needs equal length and chunking")


# ---------------------------------------------------------------------------
# GROUP BY pushdown: per-group sum/min/max/count of a value column grouped
# by an integer key column, computed on device per chunk (decode -> scatter
# reduce in one program) with the SAME exactness guarantees as the scans:
# integer sums are exact big-ints, float sums run per-group
# superaccumulators. Rows masked out (tail padding) route to a trash slot
# k (the kernels allocate k+1 groups), so no value masking is needed.

_GROUP_CAP_INT = 65536
_GROUP_CAP_FLOAT = 1024  # (k+1) * _F64_BINS uint32 bins per piece


@functools.partial(jax.jit, static_argnames=("k",))
def _mask_keys_kernel(keys, m, k):
    """Route null rows (key or value) to the trash slot k: every group
    kernel already drops slot k, so masked rows vanish from counts, sums,
    extremes and special tallies alike."""
    return jnp.where(m, keys.astype(jnp.int32), jnp.int32(k))


@functools.partial(jax.jit, static_argnames=("k",))
def _group_kernel_int(keys, x, v, k):
    """Per-group stats of an integer value column. Returns
    (bins (P, (k+1)*planes) u32, counts (k,) i32, n_neg (k,) i32,
    mn (k,), mx (k,))."""
    ok = _iota_ok(keys.shape[0], v)
    kk = jnp.where(ok, keys.astype(jnp.int32), jnp.int32(k))
    counts = jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]
    info = jnp.iinfo(x.dtype)
    mn = jnp.full((k + 1,), info.max, x.dtype).at[kk].min(x)[:k]
    mx = jnp.full((k + 1,), info.min, x.dtype).at[kk].max(x)[:k]
    signed = jnp.issubdtype(x.dtype, jnp.signedinteger)
    n_neg = (jnp.zeros((k + 1,), jnp.int32).at[kk].add(
        (x < 0).astype(jnp.int32))[:k] if signed
        else jnp.zeros((k,), jnp.int32))
    t = x.dtype.itemsize * 8
    xu = jax.lax.bitcast_convert_type(x, jnp.dtype(f"uint{t}"))
    n_planes = max(1, t // 16)
    pmask = jnp.asarray(min(0xFFFF, info.max - info.min), xu.dtype)
    bins = _group_scatter_planes(
        kk, [((xu >> jnp.asarray(16 * p, xu.dtype)) & pmask
              ).astype(jnp.uint32) for p in range(n_planes)], k)
    return bins, counts, n_neg, mn, mx


def _group_scatter_planes(kk, planes, k):
    """Piece-chunked scatter-add of 16-bit planes into (k+1)*n_planes bins:
    every partial < _PIECE * 2^16 <= 2^31. Returns (P, (k+1)*n) uint32."""
    n_planes = len(planes)
    width = (k + 1) * n_planes
    n = kk.shape[0]
    pad = (-n) % _PIECE
    idx = jnp.concatenate([jnp.pad(kk * n_planes + p, (0, pad),
                                   constant_values=k * n_planes)
                           for p in range(n_planes)])
    pl = jnp.concatenate([jnp.pad(p, (0, pad)) for p in planes])
    idx = idx.reshape(n_planes, -1, _PIECE).transpose(1, 0, 2).reshape(
        -1, n_planes * _PIECE)
    pl = pl.reshape(n_planes, -1, _PIECE).transpose(1, 0, 2).reshape(
        -1, n_planes * _PIECE)
    return jax.vmap(lambda i, p: jnp.zeros((width,), jnp.uint32)
                    .at[i].add(p))(idx, pl)


@functools.partial(jax.jit, static_argnames=("k",))
def _group_kernel_u64(keys, lo, hi, v, k):
    """u64/i64 limb-domain group stats: 4 planes per group + lexicographic
    (sign-flipped hi, lo) min/max per group. Returns (bins, counts, n_neg,
    kmn, mn_lo, kmx, mx_lo)."""
    u32 = jnp.uint32
    ok = _iota_ok(keys.shape[0], v)
    kk = jnp.where(ok, keys.astype(jnp.int32), jnp.int32(k))
    counts = jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]
    n_neg = jnp.zeros((k + 1,), jnp.int32).at[kk].add(
        ((hi >> u32(31)) & u32(1)).astype(jnp.int32))[:k]
    key = hi ^ u32(0x80000000)
    kmn = jnp.full((k + 1,), 0xFFFFFFFF, u32).at[kk].min(key)
    kmx = jnp.zeros((k + 1,), u32).at[kk].max(key)
    # second lexicographic stage: only rows matching their group's extreme
    # hi-key compete on lo
    sel_mn = key == kmn[kk]
    sel_mx = key == kmx[kk]
    mn_lo = jnp.full((k + 1,), 0xFFFFFFFF, u32).at[
        jnp.where(sel_mn, kk, jnp.int32(k))].min(lo)[:k]
    mx_lo = jnp.zeros((k + 1,), u32).at[
        jnp.where(sel_mx, kk, jnp.int32(k))].max(lo)[:k]
    planes = [(src >> u32(16 * p)) & u32(0xFFFF)
              for src in (lo, hi) for p in range(2)]
    bins = _group_scatter_planes(kk, planes, k)
    return bins, counts, n_neg, kmn[:k], mn_lo, kmx[:k], mx_lo


@functools.partial(jax.jit, static_argnames=("k",))
def _group_kernel_f64(keys, lo, hi, v, k):
    """f64 group stats: per-group superaccumulator (exact sums) + total-
    order lexicographic min/max + per-group special counts. Returns (bins,
    counts, n_nan, n_pinf, n_ninf, n_key, kmn_hi, kmn_lo, kmx_hi, kmx_lo)."""
    u32 = jnp.uint32
    ok = _iota_ok(keys.shape[0], v)
    kk = jnp.where(ok, keys.astype(jnp.int32), jnp.int32(k))
    counts = jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]
    sign = hi >> u32(31)
    E = (hi >> u32(20)) & u32(0x7FF)
    frac_hi = hi & u32(0xFFFFF)
    special = E == u32(2047)
    is_nan = special & ((frac_hi != u32(0)) | (lo != u32(0)))
    is_inf = special & ~is_nan
    def gcount(mask):
        return jnp.zeros((k + 1,), jnp.int32).at[
            jnp.where(mask, kk, jnp.int32(k))].add(1)[:k]
    n_nan = gcount(is_nan)
    n_pinf = gcount(is_inf & (sign == u32(0)))
    n_ninf = gcount(is_inf & (sign == u32(1)))
    # finite contribution (non-finite rows route to the trash slot)
    kfin = jnp.where(special, jnp.int32(k), kk)
    Ep = jnp.maximum(E, u32(1))
    m_lo = lo
    m_hi = frac_hi | jnp.where(E > u32(0), u32(1 << 20), u32(0))
    r = Ep & u32(15)
    sh_back = (u32(32) - r) & u32(31)
    lo_carry = jnp.where(r == u32(0), u32(0), m_lo >> sh_back)
    hi_carry = jnp.where(r == u32(0), u32(0), m_hi >> sh_back)
    m0 = m_lo << r
    m1 = (m_hi << r) | lo_carry
    m2 = hi_carry
    vplanes = (m0 & u32(0xFFFF), m0 >> u32(16),
               m1 & u32(0xFFFF), m1 >> u32(16), m2)
    bucket = (Ep >> u32(4)).astype(jnp.int32)
    # bin layout per group: sign*645 + bucket*5 + plane (matches
    # _f64_bins_to_int); _group_scatter_planes provides the plane stride,
    # so fold sign/bucket into a pseudo-key of stride 2*129 per group
    pseudo = kfin * (2 * _F64_BUCKETS) + sign.astype(jnp.int32) * \
        _F64_BUCKETS + bucket
    pseudo = jnp.where(kfin == jnp.int32(k), jnp.int32(k * 2 * _F64_BUCKETS),
                       pseudo)
    bins = _group_scatter_planes(pseudo, list(vplanes), k * 2 * _F64_BUCKETS)
    # total-order min/max per group (NaN rows to trash)
    key_hi, key_lo = _f64_key(lo, hi)
    kcmp = jnp.where(is_nan, jnp.int32(k), kk)
    n_key = jnp.zeros((k + 1,), jnp.int32).at[kcmp].add(1)[:k]
    kh_mn = jnp.full((k + 1,), 0xFFFFFFFF, u32).at[kcmp].min(key_hi)
    kh_mx = jnp.zeros((k + 1,), u32).at[kcmp].max(key_hi)
    sel_mn = key_hi == kh_mn[kcmp]
    sel_mx = key_hi == kh_mx[kcmp]
    kl_mn = jnp.full((k + 1,), 0xFFFFFFFF, u32).at[
        jnp.where(sel_mn, kcmp, jnp.int32(k))].min(key_lo)[:k]
    kl_mx = jnp.zeros((k + 1,), u32).at[
        jnp.where(sel_mx, kcmp, jnp.int32(k))].max(key_lo)[:k]
    return (bins, counts, n_nan, n_pinf, n_ninf, n_key,
            kh_mn[:k], kl_mn, kh_mx[:k], kl_mx)


@functools.partial(jax.jit, static_argnames=("k",))
def _group_kernel_f32(keys, bits, v, k):
    """f32 twin of _group_kernel_f64 (single-limb keys, 3 planes)."""
    u32 = jnp.uint32
    ok = _iota_ok(keys.shape[0], v)
    kk = jnp.where(ok, keys.astype(jnp.int32), jnp.int32(k))
    counts = jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]
    sign = bits >> u32(31)
    E = (bits >> u32(23)) & u32(0xFF)
    frac = bits & u32(0x7FFFFF)
    special = E == u32(255)
    is_nan = special & (frac != u32(0))
    is_inf = special & ~is_nan
    def gcount(mask):
        return jnp.zeros((k + 1,), jnp.int32).at[
            jnp.where(mask, kk, jnp.int32(k))].add(1)[:k]
    n_nan = gcount(is_nan)
    n_pinf = gcount(is_inf & (sign == u32(0)))
    n_ninf = gcount(is_inf & (sign == u32(1)))
    kfin = jnp.where(special, jnp.int32(k), kk)
    Ep = jnp.maximum(E, u32(1))
    m = frac | jnp.where(E > u32(0), u32(1 << 23), u32(0))
    r = Ep & u32(15)
    m0 = m << r
    m2 = jnp.where(r == u32(0), u32(0), m >> ((u32(32) - r) & u32(31)))
    vplanes = (m0 & u32(0xFFFF), m0 >> u32(16), m2)
    bucket = (Ep >> u32(4)).astype(jnp.int32)
    pseudo = kfin * (2 * _F32_BUCKETS) + sign.astype(jnp.int32) * \
        _F32_BUCKETS + bucket
    pseudo = jnp.where(kfin == jnp.int32(k), jnp.int32(k * 2 * _F32_BUCKETS),
                       pseudo)
    bins = _group_scatter_planes(pseudo, list(vplanes), k * 2 * _F32_BUCKETS)
    neg = sign == u32(1)
    key = jnp.where(neg, ~bits, bits ^ u32(0x80000000))
    kcmp = jnp.where(is_nan, jnp.int32(k), kk)
    n_key = jnp.zeros((k + 1,), jnp.int32).at[kcmp].add(1)[:k]
    kmn = jnp.full((k + 1,), 0xFFFFFFFF, u32).at[kcmp].min(key)[:k]
    kmx = jnp.zeros((k + 1,), u32).at[kcmp].max(key)[:k]
    return bins, counts, n_nan, n_pinf, n_ninf, n_key, kmn, kmx


def _nonzero_bigint_rows(bins_np: np.ndarray, n_groups: int, per_group: int,
                         layout_planes: int):
    """(P, (k+1)*per_group*layout_planes...) -> accumulate into an int64
    matrix (k, per_group) summed over pieces, trash slice dropped."""
    acc = bins_np.astype(np.int64).sum(axis=0)
    return acc[: n_groups * per_group].reshape(n_groups, per_group)


def _bigint_of_row(row: np.ndarray, plane_stride: int) -> int:
    """Sum of row[j] << (16 * weight(j)) for the standard (bucket, plane)
    layout where weight = bucket + plane (plane_stride planes per bucket)."""
    num = 0
    for j in np.nonzero(row)[0]:
        b, p = divmod(int(j), plane_stride)
        num += int(row[j]) << (16 * (b + p))
    return num


class _GroupAcc:
    """Cross-chunk per-group accumulator (host side: int64 matrices for
    bins/counts, vectorized lexicographic key merges)."""

    def __init__(self, k: int, kind: str, dtype_bits: int = 0):
        self.k = k
        self.kind = kind            # "int" | "u64" | "f32" | "f64"
        self.dtype_bits = dtype_bits
        self.bins = None            # int64 (k, per_group_bins)
        self.counts = np.zeros(k, np.int64)
        self.n_neg = np.zeros(k, np.int64)
        self.n_nan = np.zeros(k, np.int64)
        self.n_pinf = np.zeros(k, np.int64)
        self.n_ninf = np.zeros(k, np.int64)
        self.n_key = np.zeros(k, np.int64)
        self.mn = None              # dtype array (int) or key tuples
        self.mx = None
        self.kmn = None             # (hi, lo) uint32 arrays for u64/f64
        self.kmx = None

    def _add_bins(self, bins):
        self.bins = bins if self.bins is None else self.bins + bins

    def _merge_keys2(self, cur, new, is_min):
        """Vectorized lexicographic (hi, lo) merge."""
        if cur is None:
            return new
        ch, cl = cur
        nh, nl = new
        better = (nh < ch) | ((nh == ch) & (nl < cl)) if is_min else \
                 (nh > ch) | ((nh == ch) & (nl > cl))
        return np.where(better, nh, ch), np.where(better, nl, cl)

    def feed_int(self, out):
        bins, counts, n_neg, mn, mx = out
        planes = bins.shape[1] // (self.k + 1)
        self._add_bins(_nonzero_bigint_rows(np.asarray(bins), self.k, planes, 1))
        self.counts += np.asarray(counts, np.int64)
        self.n_neg += np.asarray(n_neg, np.int64)
        mn, mx = np.asarray(mn), np.asarray(mx)
        self.mn = mn if self.mn is None else np.minimum(self.mn, mn)
        self.mx = mx if self.mx is None else np.maximum(self.mx, mx)

    def feed_u64(self, out):
        bins, counts, n_neg, kmn, mn_lo, kmx, mx_lo = out
        self._add_bins(_nonzero_bigint_rows(np.asarray(bins), self.k, 4, 1))
        self.counts += np.asarray(counts, np.int64)
        self.n_neg += np.asarray(n_neg, np.int64)
        self.kmn = self._merge_keys2(
            self.kmn, (np.asarray(kmn), np.asarray(mn_lo)), True)
        self.kmx = self._merge_keys2(
            self.kmx, (np.asarray(kmx), np.asarray(mx_lo)), False)

    def feed_f64(self, out):
        (bins, counts, n_nan, n_pinf, n_ninf, n_key,
         kh_mn, kl_mn, kh_mx, kl_mx) = out
        self._add_bins(_nonzero_bigint_rows(np.asarray(bins), self.k,
                                            _F64_BINS, 1))
        self.counts += np.asarray(counts, np.int64)
        self.n_nan += np.asarray(n_nan, np.int64)
        self.n_pinf += np.asarray(n_pinf, np.int64)
        self.n_ninf += np.asarray(n_ninf, np.int64)
        self.n_key += np.asarray(n_key, np.int64)
        self.kmn = self._merge_keys2(
            self.kmn, (np.asarray(kh_mn), np.asarray(kl_mn)), True)
        self.kmx = self._merge_keys2(
            self.kmx, (np.asarray(kh_mx), np.asarray(kl_mx)), False)

    def feed_f32(self, out):
        bins, counts, n_nan, n_pinf, n_ninf, n_key, kmn, kmx = out
        self._add_bins(_nonzero_bigint_rows(np.asarray(bins), self.k,
                                            _F32_BINS, 1))
        self.counts += np.asarray(counts, np.int64)
        self.n_nan += np.asarray(n_nan, np.int64)
        self.n_pinf += np.asarray(n_pinf, np.int64)
        self.n_ninf += np.asarray(n_ninf, np.int64)
        self.n_key += np.asarray(n_key, np.int64)
        kmn, kmx = np.asarray(kmn), np.asarray(kmx)
        self.kmn = kmn if self.kmn is None else np.minimum(self.kmn, kmn)
        self.kmx = kmx if self.kmx is None else np.maximum(self.kmx, kmx)

    def result(self) -> dict:
        from fractions import Fraction

        out = {}
        for g in range(self.k):
            c = int(self.counts[g])
            if c == 0:
                continue
            row = self.bins[g]
            if self.kind == "int":
                # flat 16-bit planes: weight of bin j is exactly j
                total = _bigint_of_row(row, 1)
                total -= int(self.n_neg[g]) << self.dtype_bits
                mn, mx = int(self.mn[g]), int(self.mx[g])
            elif self.kind == "u64":
                # planes [lo0, lo1, hi0, hi1] -> weights 0,1,2,3 (= j)
                total = _bigint_of_row(row, 1)
                total -= int(self.n_neg[g]) << 64
                mn = _i64_of(int(self.kmn[0][g]), int(self.kmn[1][g]))
                mx = _i64_of(int(self.kmx[0][g]), int(self.kmx[1][g]))
            else:
                denom_bits = 1075 if self.kind == "f64" else 150
                plane_stride = 5 if self.kind == "f64" else 3
                if self.n_nan[g] or (self.n_pinf[g] and self.n_ninf[g]):
                    total = float("nan")
                elif self.n_pinf[g]:
                    total = float("inf")
                elif self.n_ninf[g]:
                    total = float("-inf")
                else:
                    num = 0
                    half = row.shape[0] // 2
                    num += _bigint_of_row(row[:half], plane_stride)
                    num -= _bigint_of_row(row[half:], plane_stride)
                    total = (float(Fraction(num, 1 << denom_bits))
                             if num else 0.0)
                if self.n_nan[g]:
                    mn = mx = float("nan")
                elif self.kind == "f64":
                    mn = _f64_of_key(int(self.kmn[0][g]), int(self.kmn[1][g]))
                    mx = _f64_of_key(int(self.kmx[0][g]), int(self.kmx[1][g]))
                else:
                    mn = _f32_of_key(int(self.kmn[g]))
                    mx = _f32_of_key(int(self.kmx[g]))
            out[g] = {"sum": total, "min": mn, "max": mx, "count": c}
        return out


# ---------------------------------------------------------------------------
# multi-predicate filtering: several ANDed (column, op, value) predicates
# evaluated in lockstep over the chunk streams — the WHERE clause of a
# SQL-ish query. scan_where_multi aggregates through the same exact
# kernels; select() materializes the matching rows of chosen columns.


def _lockstep_chunks(path: str, names, mesh, keep=None):
    """Walk several columns' chunk streams in lockstep (batch=False so
    parts align chunk-for-chunk). Yields {name: (blocks, cdtype, vtype,
    valid, vmask)} per chunk; raises on mismatched layouts. `keep` (zone
    map chunk flags) must be shared — every column skips the same
    windows, so alignment survives."""
    iters = {n: _decoded_chunks(path, n, mesh, batch=False,
                                window=_LOCKSTEP_WINDOW, keep=keep)
             for n in names}
    while True:
        rows = {}
        done = 0
        for n, it in iters.items():
            nxt = next(it, None)
            if nxt is None:
                done += 1
            rows[n] = nxt
        if done:
            if done != len(iters):
                raise ValueError(
                    f"columns {sorted(names)} have different chunk counts; "
                    "lockstep scans need equal length and chunking")
            return
        valids = {r[3] for r in rows.values()}
        if len(valids) != 1:
            raise ValueError(
                f"columns {sorted(names)} have mismatched chunk layouts; "
                "lockstep scans need equal length and chunking")
        yield rows


def _normalize_preds(path: str, preds):
    """[(column, op, value)] -> same with string predicates translated to
    the code domain and ops validated."""
    out = []
    for pcol, op, value in preds:
        if op not in _ALL_OPS:
            raise ValueError(
                f"unknown predicate {op!r}; have {sorted(_ALL_OPS)}")
        wdict = _str_dict_of(path, pcol)
        if wdict is not None:
            op, value = _str_pred_to_code(wdict, op, value)
        else:
            value = _probe_epoch(path, pcol, value)
        out.append((pcol, op, value))
    return out


def _chunk_row_mask(rows, preds):
    """AND of every predicate's hit mask for one lockstep chunk; null
    predicate rows match nothing."""
    mask = None
    for pcol, op, value in preds:
        blocks, cdtype, vtype, _valid, vmask = rows[pcol]
        flat = _flatten_logical(blocks, cdtype, vtype)
        m = _pred_mask(flat, op, value)
        if vmask is not None:
            m = m & vmask
        mask = m if mask is None else mask & m
    return mask


def scan_where_multi(path: str, preds, column: Optional[str] = None,
                     mesh=None) -> dict:
    """Filtered aggregation with several ANDed predicates — the WHERE
    clause `p1 AND p2 AND ...` pushed down in one pass: each predicate is
    (column, op, value) (string probes compare as dictionary codes; null
    rows never match), and sum/min/max/count aggregate `column` over the
    surviving rows with the scans' exactness guarantees."""
    paths = _paths(path)
    vdict0 = _str_dict_of(paths[0], column)
    if len(paths) > 1 and vdict0 is not None:
        return _merge_str_stats([scan_where_multi(p, preds, column, mesh)
                                 for p in paths])
    raw_preds = list(preds)
    acc = _StatAcc()
    for p in paths:
        preds_p = _normalize_preds(p, raw_preds)
        names = list(dict.fromkeys([q[0] for q in preds_p] + [column]))
        if None in names and len(names) > 1:
            raise ValueError("single-column files take column=None "
                             "predicates only; name table columns explicitly")
        keep = _zone_keep(p, preds_p, names=[n for n in names
                                             if n is not None])
        for rows in _lockstep_chunks(p, names, mesh, keep=keep):
            blocks, cdtype, vtype, valid, vmask = rows[column]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds_p)
            if vmask is not None:  # null values don't aggregate
                mask = vmask if mask is None else mask & vmask
            flat = _flatten_logical(blocks, cdtype, vtype)
            acc.feed_flat(flat, valid, mask)
    r = acc.result()
    return _map_str_result(r, vdict0) if vdict0 is not None else r


def _logical_vt(col_meta: dict):
    """The column's logical vtype when it rides integer storage (bool /
    datetime64[*] / timedelta64[*]), else None."""
    vt = col_meta.get("vtype")
    if vt == "bool" or (vt or "").startswith(("datetime64", "timedelta64")):
        return vt
    return None


def _host_chunk_values(blocks, cdtype, vtype, transform_signed, str_dict,
                       logical, idx):
    """Rows `idx` of one decoded chunk -> host values in the user-facing
    domain (strings, bools and temporal dtypes restored). The gather runs
    on device, so only matching rows cross to the host."""
    flat = _flatten_logical(blocks, cdtype, vtype)
    di = jnp.asarray(idx, jnp.int32)

    def take(a):
        return np.asarray(jnp.take(a, di, axis=0))

    if isinstance(flat, tuple) and isinstance(flat[0], str):
        if flat[0] == "f64":
            lo = take(flat[1]).astype(np.uint64)
            hi = take(flat[2]).astype(np.uint64)
            return ((hi << np.uint64(32)) | lo).view(np.float64)
        return take(flat[1]).view(np.float32)
    if isinstance(flat, tuple):  # u64 limbs
        lo = take(flat[0]).astype(np.uint64)
        hi = take(flat[1]).astype(np.uint64)
        wide = (hi << np.uint64(32)) | lo
        if transform_signed:
            wide = wide.view(np.int64)
        if logical is not None:  # datetime64[*] / timedelta64[*]
            wide = wide.view(np.dtype(logical))
        return wide
    vals = take(flat)
    if str_dict is not None:
        return str_dict[vals.astype(np.int64)]
    if logical == "bool":
        return vals.astype(bool)
    return vals


def select(path: str, columns=None, preds=(), limit: Optional[int] = None,
           mesh=None, order_by: Optional[str] = None,
           desc: bool = False) -> dict:
    """Materialize the rows matching every predicate — projection +
    selection pushdown: only the requested columns decode, predicate
    evaluation happens on device, and only matching rows reach the host.
    `preds` is a list of (column, op, value); `columns` defaults to every
    table column. Returns {name: np array} with nullable columns as masked
    arrays and string columns as unicode arrays.

    `order_by` sorts the result by that column (`desc` for descending;
    rows whose order key is null sort last). With `limit` the combination
    is a true ORDER BY ... LIMIT pushdown: every chunk reduces to k
    candidate rows on device (total-order key top-k) and only candidates
    reach the host. Without `order_by`, `limit` stops the file walk early
    in file order."""
    from . import fio_table

    paths = _paths(path)
    if len(paths) > 1:
        return _select_dataset(paths, columns, list(preds), limit, mesh,
                               order_by, desc)
    path = paths[0]
    with open(path, "rb") as f:
        if not f.read(8).startswith(b"FLTTAB1"):
            raise ValueError("select() takes an FLTTAB table file")
    header = fio_table.read_table_header(path)
    if columns is None:
        columns = list(header["columns"])
    preds = _normalize_preds(path, list(preds))
    names = list(dict.fromkeys(
        [p[0] for p in preds] + list(columns)
        + ([order_by] if order_by is not None else [])))
    meta = {}
    for n in names:
        cm = fio_table._col_meta(header, n)
        meta[n] = (cm.get("transform") in ("zigzag", "viewu"),
                   _str_dict_of(path, n), _logical_vt(cm))

    keep = _zone_keep(path, preds, names=names)
    if order_by is not None and limit is not None:
        return _select_topk(path, columns, preds, limit, mesh, order_by,
                            desc, names, meta, keep)

    out = {n: [] for n in columns}
    okeys = []  # order_by without limit: carry the key column, sort after
    taken = 0
    for rows in _lockstep_chunks(path, names, mesh, keep=keep):
        valid = rows[names[0]][3]
        if valid == 0:
            continue
        mask = _chunk_row_mask(rows, preds)
        if mask is None:
            keep = np.ones(valid, bool)
        else:
            keep = np.asarray(mask)[:valid]
        idx = np.flatnonzero(keep)
        if order_by is None and limit is not None and taken + idx.size > limit:
            idx = idx[: limit - taken]
        taken += idx.size
        for n in columns:
            blocks, cdtype, vtype, _v, vmask = rows[n]
            vals = _host_chunk_values(blocks, cdtype, vtype, *meta[n], idx)
            if vmask is not None:
                vals = np.ma.MaskedArray(
                    vals, mask=~np.asarray(vmask)[:valid][idx]
                    if idx.size else np.zeros(0, bool))
            out[n].append(vals)
        if order_by is not None:
            blocks, cdtype, vtype, _v, vmask = rows[order_by]
            kv = _host_chunk_values(blocks, cdtype, vtype,
                                    *meta[order_by], idx)
            if vmask is not None:
                kv = np.ma.MaskedArray(
                    kv, mask=~np.asarray(vmask)[:valid][idx]
                    if idx.size else np.zeros(0, bool))
            okeys.append(kv)
        if order_by is None and limit is not None and taken >= limit:
            break
    result = {}
    for n in columns:
        parts = out[n]
        if not parts:
            result[n] = np.empty(0)
        elif any(isinstance(p, np.ma.MaskedArray) for p in parts):
            result[n] = np.ma.concatenate(parts)
        else:
            result[n] = np.concatenate(parts)
    if order_by is not None and okeys:
        keys = (np.ma.concatenate(okeys)
                if any(isinstance(p, np.ma.MaskedArray) for p in okeys)
                else np.concatenate(okeys))
        order = _order_of(keys, desc)
        result = {n: result[n][order] for n in result}
    return result


def _order_of(keys, desc: bool) -> np.ndarray:
    """Sort order of an order-by column: stable, null keys last, u64 keys
    with the scans' int64 semantics."""
    null = (np.ma.getmaskarray(keys) if isinstance(keys, np.ma.MaskedArray)
            else np.zeros(len(keys), bool))
    kd = np.asarray(np.ma.getdata(keys))
    if kd.dtype == np.uint64:
        kd = kd.view(np.int64)
    pos = np.arange(len(kd))
    vi = pos[~null][np.argsort(kd[~null], kind="stable")]
    if desc:
        vi = vi[::-1]
    return np.concatenate([vi, pos[null]]).astype(np.int64)


def _concat_row_dicts(parts, names) -> dict:
    """Concatenate per-file select() results column-wise (mask-aware)."""
    out = {}
    for n in names:
        cols = [p[n] for p in parts if n in p and len(p[n])]
        if not cols:
            out[n] = np.empty(0)
        elif any(isinstance(c, np.ma.MaskedArray) for c in cols):
            out[n] = np.ma.concatenate(cols)
        else:
            out[n] = np.concatenate(cols)
    return out


def _select_dataset(paths, columns, preds, limit, mesh, order_by, desc):
    """select() over a sharded dataset: per-file pushdown (each file owns
    its dictionaries), then a column-wise merge; ORDER BY re-sorts the
    merged candidates on the host and trims to the limit."""
    from . import fio_table

    if columns is None:
        columns = list(fio_table.read_table_header(paths[0])["columns"])
    if order_by is None:
        parts = []
        remaining = limit
        for p in paths:
            rows = select(p, columns, preds, remaining, mesh)
            parts.append(rows)
            if remaining is not None:
                got = len(rows[columns[0]]) if columns else 0
                remaining -= got
                if remaining <= 0:
                    break
        return _concat_row_dicts(parts, columns)
    inner = list(dict.fromkeys(list(columns) + [order_by]))
    parts = [select(p, inner, preds, limit, mesh,
                    order_by if limit is not None else None, desc)
             for p in paths]
    combined = _concat_row_dicts(parts, inner)
    if len(combined[order_by]):
        order = _order_of(combined[order_by], desc)
        combined = {n: v[order] for n, v in combined.items()}
    if limit is not None:
        combined = {n: v[:limit] for n, v in combined.items()}
    if order_by not in columns:
        combined.pop(order_by)
    return combined


def _select_topk(path, columns, preds, k, mesh, order_by, desc, names,
                 meta, keep=None):
    """ORDER BY order_by [DESC] LIMIT k pushdown: each chunk reduces to k
    candidate rows on device; only candidates' projected values reach the
    host merge. Zone-map bounds on the order column visit windows
    best-bound-first and stop once the k-th candidate beats every
    remaining window — ORDER BY a clustered column LIMIT k touches ~one
    window."""
    store = []        # per contributing window: {col: gathered values}
    entries = []      # (key_tuple, window_idx, store_seq, emit_pos)
    kind = None

    def visit(keep_w, widx_of_part):
        nonlocal kind
        part_i = 0
        for rows in _lockstep_chunks(path, names, mesh, keep=keep_w):
            widx = widx_of_part[part_i]
            part_i += 1
            valid = rows[names[0]][3]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds)
            oblocks, ocdt, ovt, _ov, ovmask = rows[order_by]
            m = (jnp.ones((valid,), bool) if mask is None
                 else mask[:valid])
            if ovmask is not None:  # null order keys sort out of a top-k
                m = m & ovmask[:valid]
            n_ok = int(_count_masked(m, jnp.int32(valid)))
            if n_ok == 0:
                continue
            oflat = _flatten_logical(oblocks, ocdt, ovt)
            kind, _ib, cands = _chunk_top(oflat, m, valid, min(k, valid),
                                          largest=desc)
            cands = cands[: min(n_ok, k)]
            idx = np.asarray([i for _key, i in cands], np.int64)
            chunk_vals = {}
            for n in columns:
                blocks, cdtype, vtype, _v, vmask = rows[n]
                vals = _host_chunk_values(blocks, cdtype, vtype, *meta[n],
                                          idx)
                if vmask is not None:
                    vals = np.ma.MaskedArray(
                        vals, mask=~np.asarray(vmask)[:valid][idx]
                        if idx.size else np.zeros(0, bool))
                chunk_vals[n] = vals
            seq = len(store)
            store.append(chunk_vals)
            entries.extend((key, widx, seq, j)
                           for j, (key, _i) in enumerate(cands))

    chunks, ocdt_l, otr_l, ovt_l, _nv, _bo, _nm = _column_layout(path,
                                                                 order_by)
    n_chunks = len(chunks)
    win = _LOCKSTEP_WINDOW
    windows = list(range(0, n_chunks, win))
    if all("stats" not in c for c in chunks):
        # no zone maps: one sequential pass (old files); parts only come
        # from windows the pred-keep leaves alive
        yielding = [wi for wi, start in enumerate(windows)
                    if keep is None or any(
                        keep[c] for c in range(start,
                                               min(start + win, n_chunks)))]
        visit(keep, yielding)
    else:
        zkind, zbits = zonemaps.topk_kind(ocdt_l, ovt_l, otr_l)
        wb = {}
        for wi, start in enumerate(windows):
            bs = [zonemaps.topk_bound(chunks[c], zkind, zbits, desc)
                  for c in range(start, min(start + win, n_chunks))
                  if keep is None or keep[c]]
            bs = [b for b in bs if b is not None]
            if bs:
                wb[wi] = max(bs) if desc else min(bs)
        order = sorted(wb, key=lambda wi: wb[wi], reverse=desc)
        pos, batch = 0, 1
        while pos < len(order):
            if len(entries) >= k:
                kth = sorted((e[0] for e in entries), reverse=desc)[k - 1]
                b = wb[order[pos]]
                if (b < kth) if desc else (b > kth):
                    break
            take = sorted(order[pos:pos + batch])
            pos += batch
            batch *= 4
            kl = [False] * n_chunks
            for wi in take:
                for c in range(windows[wi], min(windows[wi] + win,
                                                n_chunks)):
                    kl[c] = keep is None or keep[c]
            # every taken window yields exactly one part iff any of its
            # chunks stays kept (wb membership guarantees it)
            visit(kl, take)
    # file order then emit order, THEN a stable key sort: equal keys
    # resolve exactly as the sequential walk did
    entries.sort(key=lambda e: (e[1], e[3]))
    entries.sort(key=lambda e: e[0], reverse=desc)
    entries = [(key, seq, j) for key, _w, seq, j in entries[:k]]
    result = {}
    for n in columns:
        if not entries:
            result[n] = np.empty(0)
            continue
        data = [np.ma.getdata(store[c][n])[j] for _key, c, j in entries]
        msk = [bool(np.ma.getmaskarray(store[c][n])[j])
               for _key, c, j in entries]
        dt = np.ma.getdata(store[entries[0][1]][n]).dtype
        # unicode widths differ per chunk: let numpy take the max
        arr = np.asarray(data) if dt.kind == "U" else np.asarray(data, dt)
        if any(isinstance(store[c][n], np.ma.MaskedArray)
               for _key, c, j in entries):
            result[n] = np.ma.MaskedArray(arr, mask=np.asarray(msk))
        else:
            result[n] = arr
    return result


def _stats_summary(paths, column):
    """scan_column-compatible {count, min, max, nan} derived purely from
    zone maps — no decode at all — or None when any chunk lacks stats.
    min/max come back in the scans' comparison conventions (logical ints,
    int64 semantics for 64-bit carriers, floats as floats, string columns
    as dictionary codes); count excludes nulls, `nan` flags any NaN."""
    total, lo, hi, nan = 0, None, None, False
    for p in paths:
        try:
            chunks, _cd, _t, _vt, n_values, _b, nulls = _column_layout(
                p, column)
        except (ValueError, KeyError):
            return None
        n_rows = (n_values if n_values is not None
                  else sum(m["n_blocks"] for m in chunks) * layout.BLOCK)
        total += n_rows - (int(nulls["n_null"]) if nulls else 0)
        for m in chunks:
            st = m.get("stats")
            if not isinstance(st, dict):
                return None
            if st.get("nan"):
                nan = True
            if "lo" in st:
                lo = st["lo"] if lo is None or st["lo"] < lo else lo
                hi = st["hi"] if hi is None or st["hi"] > hi else hi
    return {"count": total, "min": lo, "max": hi, "nan": nan}


def quantile(path, column: Optional[str] = None, q=0.5, mesh=None):
    """EXACT quantile of a compressed column (lower interpolation, the
    value at zero-based rank floor(q*(n-1)) of the sorted non-null
    values; numpy's method='lower'). Accepts a scalar q or a list.

    Strategy: when the distinct set fits value_counts, ONE scan plus a
    cumulative sum answers every q (strings/bools/low-cardinality ints).
    Otherwise a value-domain binary search runs count_where('le', mid)
    per step — ~32 scans for 32-bit ints, ~64 for f64/u64 (total-order
    key domain for floats) — every step exact, so the result is exact
    for every column type, dataset lists included. Columns containing
    NaN return NaN (numpy semantics); an empty/all-null column returns
    None."""
    qs = np.atleast_1d(np.asarray(q, np.float64))
    if ((qs < 0) | (qs > 1)).any():
        raise ValueError("quantiles must be in [0, 1]")
    # zone maps make the leading summary free: count from the headers,
    # min/max/NaN from the chunk stats — no decode before the search
    # (string columns keep the scan: their min/max are labels, not codes)
    s = (None if _str_dict_of(_paths(path)[0], column) is not None
         else _stats_summary(_paths(path), column))
    if s is not None and s["nan"]:
        s = {"count": s["count"], "min": float("nan"), "max": float("nan")}
    if s is None:
        s = scan_column(path, column=column, mesh=mesh)
    n = s["count"]
    scalar = np.isscalar(q) or np.asarray(q).ndim == 0
    if n == 0:
        return None if scalar else [None] * len(qs)
    if isinstance(s["min"], float) and np.isnan(s["min"]):
        return float("nan") if scalar else [float("nan")] * len(qs)
    ranks = [int(np.floor(qq * (n - 1))) for qq in qs]

    try:  # one-scan path: exact counts over the distinct set
        vc = value_counts(path, column=column, mesh=mesh)
    except ValueError:
        vc = None
    if vc is not None:
        keys = sorted(vc)
        cum = np.cumsum([vc[k] for k in keys])
        out = [keys[int(np.searchsorted(cum, r + 1))] for r in ranks]
        return out[0] if scalar else out

    is_float = isinstance(s["min"], float)
    if is_float:
        import struct

        # search the column's OWN key space: an f32 column must probe with
        # representable f32 values or count_where's cast would desync the
        # search from the key domain
        f32 = _column_layout(_paths(path)[0], column)[3] == "f32"
        if f32:
            def to_key(v):
                b = struct.unpack("<I", struct.pack("<f", v))[0]
                return (~b & 0xFFFFFFFF) if b >> 31 else b | 1 << 31

            def of_key(kk):
                b = (kk ^ (1 << 31)) if kk >> 31 else (~kk & 0xFFFFFFFF)
                return float(np.frombuffer(struct.pack("<I", b),
                                           np.float32)[0])
        else:
            def to_key(v):  # f64 total-order key as one python int
                b = struct.unpack("<Q", struct.pack("<d", v))[0]
                return (~b & (1 << 64) - 1) if b >> 63 else b | 1 << 63

            def of_key(kk):
                b = (kk ^ (1 << 63)) if kk >> 63 else (~kk & (1 << 64) - 1)
                return struct.unpack("<d", struct.pack("<Q", b))[0]
    else:
        def to_key(v):
            return int(v)

        def of_key(kk):
            return int(kk)

    out = []
    for r in ranks:
        lo, hi = to_key(s["min"]), to_key(s["max"])
        while lo < hi:
            mid = (lo + hi) // 2
            probe = of_key(mid)
            if is_float and not (s["min"] <= probe <= s["max"]):
                # keys between representable floats stay in range by
                # construction; guard anyway
                probe = min(max(probe, s["min"]), s["max"])
            if count_where(path, "le", probe, column=column,
                           mesh=mesh) >= r + 1:
                hi = mid
            else:
                lo = mid + 1
        out.append(of_key(lo))
    return out[0] if scalar else out


def median(path, column: Optional[str] = None, mesh=None):
    """Exact median (see quantile)."""
    return quantile(path, column=column, q=0.5, mesh=mesh)


@jax.jit
def _join_match(keys, right_sorted):
    """(row index into the sorted right keys, matched?) per left key."""
    i = jnp.clip(jnp.searchsorted(right_sorted, keys), 0,
                 right_sorted.shape[0] - 1)
    return i, right_sorted[i] == keys


def join(left_path, right_path, on: str, columns=None, right_columns=None,
         preds=(), how: str = "inner", limit: Optional[int] = None,
         mesh=None) -> dict:
    """Dimension join: enrich the (large, streamed) LEFT table with
    columns of the (small) RIGHT table matched on the `on` key column.

    The right key must be UNIQUE (a dimension table — so no row
    multiplication); the right side decodes once to the host, the left
    side streams chunk-by-chunk with `preds` pushdown and the key match
    evaluated on device (sorted-key searchsorted; string keys match by
    label through a left-code -> right-row translation table, so the
    actual match is one device gather). `how`: "inner" drops unmatched
    left rows, "left" keeps them with masked right values. Key domains:
    integers <= 32 bits and strings (u64/float keys raise). Right columns
    whose names collide get a "_right" suffix.

    Returns {name: np array} like select()."""
    from . import fio_table

    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    lpaths = _paths(left_path)
    rheader = fio_table.read_table_header(right_path)
    if right_columns is None:
        right_columns = [c for c in rheader["columns"] if c != on]
    rkeys = fio_table.read_column(right_path, on)
    if isinstance(rkeys, np.ma.MaskedArray):
        raise ValueError(f"right key column {on!r} must not contain nulls")
    rvals = {c: fio_table.read_column(right_path, c) for c in right_columns}

    lheader = fio_table.read_table_header(lpaths[0])
    if columns is None:
        columns = list(lheader["columns"])
    out_names = list(columns) + [
        (c if c not in columns else f"{c}_right") for c in right_columns]

    # sort the right side by key; uniqueness = no duplicate neighbours
    if rkeys.dtype.kind in ("U", "O"):
        rk = np.asarray(rkeys).astype(np.str_)
        order = np.argsort(rk, kind="stable")
        rk_sorted = rk[order]
        if rk_sorted.size > 1 and (rk_sorted[1:] == rk_sorted[:-1]).any():
            raise ValueError(f"right key column {on!r} has duplicates")
        str_key = True
        rkd = None
    else:
        if rkeys.dtype.itemsize * 8 == 64 or rkeys.dtype.kind == "f":
            raise ValueError("join keys must be integers <= 32 bits or "
                             f"strings; {on!r} is {rkeys.dtype}")
        order = np.argsort(rkeys, kind="stable")
        rk_sorted = np.asarray(rkeys)[order]
        if rk_sorted.size > 1 and (rk_sorted[1:] == rk_sorted[:-1]).any():
            raise ValueError(f"right key column {on!r} has duplicates")
        str_key = False
        rkd = jnp.asarray(rk_sorted)
    rvals_sorted = {c: v[order] for c, v in rvals.items()}

    out = {n: [] for n in out_names}
    taken = 0
    for p in lpaths:
        preds_p = _normalize_preds(p, list(preds))
        names = list(dict.fromkeys([q[0] for q in preds_p] + list(columns)
                                   + [on]))
        lh = fio_table.read_table_header(p)
        col_meta = {}
        for n in names:
            cm = fio_table._col_meta(lh, n)
            col_meta[n] = (cm.get("transform") in ("zigzag", "viewu"),
                           _str_dict_of(p, n), _logical_vt(cm))
        if str_key:
            ld = _str_dict_of(p, on)
            if ld is None:
                raise ValueError(f"left {on!r} is not a string column but "
                                 "the right key is")
            # left code -> right sorted row (or -1): host searchsorted of
            # the left dictionary into the right keys, then ONE device
            # gather per chunk does the whole match
            pos = np.searchsorted(rk_sorted, ld)
            pos_c = np.clip(pos, 0, max(0, rk_sorted.size - 1))
            hit = (rk_sorted[pos_c] == ld) if rk_sorted.size else \
                np.zeros(ld.size, bool)
            tr = np.where(hit, pos_c, -1).astype(np.int32)
            tr_dev = jnp.asarray(tr)
        keep = _zone_keep(p, preds_p, names=names)
        for rows in _lockstep_chunks(p, names, mesh, keep=keep):
            valid = rows[names[0]][3]
            if valid == 0:
                continue
            mask = _chunk_row_mask(rows, preds_p)
            kblocks, kdt, kvt, _kv, kmask = rows[on]
            kflat = _flatten_logical(kblocks, kdt, kvt)
            if isinstance(kflat, tuple):
                raise ValueError("join keys must be integers <= 32 bits "
                                 "or strings")
            if str_key:
                ridx = jnp.take(tr_dev, kflat.astype(jnp.int32))
                matched = ridx >= 0
            elif rk_sorted.size == 0:
                ridx = jnp.zeros(kflat.shape, jnp.int32)
                matched = jnp.zeros(kflat.shape, bool)
            else:
                if kflat.dtype != rkd.dtype:
                    raise ValueError(
                        f"join key dtypes differ ({kflat.dtype} vs "
                        f"{rkd.dtype}); store both sides as one dtype")
                ridx, matched = _join_match(kflat, rkd)
            if kmask is not None:  # null keys never match
                matched = matched & kmask
            keep = matched if how == "inner" else (
                jnp.ones(kflat.shape, bool) if mask is None else mask)
            if how == "inner" and mask is not None:
                keep = keep & mask
            keep_np = np.asarray(keep)[:valid]
            idx = np.flatnonzero(keep_np)
            if limit is not None and taken + idx.size > limit:
                idx = idx[: limit - taken]
            taken += idx.size
            # left columns: device gather at the kept rows
            for n in columns:
                blocks, cdtype, vtype, _v, vmask = rows[n]
                vals = _host_chunk_values(blocks, cdtype, vtype,
                                          *col_meta[n], idx)
                if vmask is not None:
                    vals = np.ma.MaskedArray(
                        vals, mask=~np.asarray(vmask)[:valid][idx]
                        if idx.size else np.zeros(0, bool))
                out[n].append(vals)
            # right columns: host gather by matched sorted-row index
            ridx_np = np.asarray(ridx)[:valid][idx]
            ok_np = np.asarray(matched)[:valid][idx]
            safe = np.where(ok_np, ridx_np, 0).astype(np.int64)
            for c, oname in zip(right_columns, out_names[len(columns):]):
                if rvals_sorted[c].size == 0:  # empty right: all masked
                    rv = np.ma.masked_all(
                        len(safe), dtype=np.ma.getdata(rvals_sorted[c]).dtype)
                else:
                    rv = rvals_sorted[c][safe]
                if how == "left":
                    m = ~ok_np
                    if isinstance(rv, np.ma.MaskedArray):
                        rv = np.ma.MaskedArray(np.ma.getdata(rv),
                                               mask=np.ma.getmaskarray(rv) | m)
                    elif m.any():
                        rv = np.ma.MaskedArray(rv, mask=m)
                out[oname].append(rv)
            if limit is not None and taken >= limit:
                break
        if limit is not None and taken >= limit:
            break
    result = {}
    for n in out_names:
        parts = out[n]
        if not parts:
            result[n] = np.empty(0)
        elif any(isinstance(q, np.ma.MaskedArray) for q in parts):
            result[n] = np.ma.concatenate(parts)
        else:
            result[n] = np.concatenate(parts)
    return result


# ---------------------------------------------------------------------------
# distinct / value_counts / top_k: the remaining SQL-ish pushdowns.
# distinct is metadata-only for dict/rle/string chunks (their payloads
# already carry the value sets); value_counts scatter-counts dictionary
# codes on device; top_k runs per-chunk device top-k in the total-order
# key domain and merges k-candidates on the host.


def distinct(path: str, column: Optional[str] = None) -> np.ndarray:
    """Sorted distinct values of a compressed column. dict chunks read only
    their dictionaries and rle chunks only their run values (no decode at
    all); string columns return their sorted dictionary outright; other
    codecs decode chunk-by-chunk on the host and merge. Tail padding of
    flat-written columns repeats the final value, so it never adds a
    distinct value."""
    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: exact union of per-file sets
        parts = [p for p in (distinct(q, column) for q in paths) if p.size]
        if not parts:
            return distinct(paths[0], column)
        return np.unique(np.concatenate(parts))
    path = paths[0]
    (chunks, cdtype, transform, vtype, n_values, base_off,
     nulls_meta) = _column_layout(path, column)
    if nulls_meta is not None:
        total = (n_values if n_values is not None
                 else sum(c["n_blocks"] for c in chunks) * layout.BLOCK)
        if nulls_meta["n_null"] >= total:  # all null: fillers are synthetic
            d = _str_dict_of(path, column)
            return (np.empty(0, d.dtype if d is not None
                             else layout.np_dtype(cdtype)))
        # otherwise every filler copies a value that also occurs non-null
        # (forward-fill), so the distinct set is unaffected
    d = _str_dict_of(path, column)
    if d is not None:
        return d.copy()  # built from the data: every entry occurs
    parts = []
    with open(path, "rb") as f:
        for meta in chunks:
            f.seek(base_off + meta["offset"])
            raw = f.read(meta["nbytes"])
            if meta["codec"] == "dict":
                vals, _ = fio._split_dict_payload(meta, raw,
                                                  meta["n_blocks"], cdtype)
            elif meta["codec"] == "rle":
                _c, _b, _p, rv = fio._split_rle_payload(
                    meta, raw, meta["n_blocks"], cdtype)
                vals = np.unique(rv)
            else:
                vals = np.unique(fio._decode_chunk(
                    meta, raw, meta["n_blocks"], cdtype).reshape(-1))
            parts.append(np.asarray(vals))
    if not parts:
        return np.empty(0, layout.np_dtype(cdtype))
    merged = np.unique(np.concatenate(parts))
    if transform is not None:  # transforms reorder the wire domain
        merged = np.unique(fio.apply_inverse_transform(merged, transform))
    if vtype == "bool":
        return merged.astype(bool)
    if vtype is not None and vtype.startswith(("datetime64", "timedelta64")):
        return merged.view(np.dtype(vtype))  # int64 order == temporal order
    return merged


@functools.partial(jax.jit, static_argnames=("k",))
def _count_codes_kernel(codes, v, k):
    ok = _iota_ok(codes.shape[0], v)
    kk = jnp.where(ok, codes.astype(jnp.int32), jnp.int32(k))
    return jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]


@functools.partial(jax.jit, static_argnames=("k",))
def _count_codes_kernel_m(codes, m, v, k):
    ok = _iota_ok(codes.shape[0], v) & m
    kk = jnp.where(ok, codes.astype(jnp.int32), jnp.int32(k))
    return jnp.zeros((k + 1,), jnp.int32).at[kk].add(1)[:k]


_VALUE_COUNTS_CAP = 65536


def value_counts(path: str, column: Optional[str] = None,
                 max_values: int = _VALUE_COUNTS_CAP, mesh=None) -> dict:
    """{value: count} over a compressed column, exact. The distinct set
    (see `distinct`) becomes a device dictionary; each chunk decodes and
    scatter-counts its searchsorted codes in one fused program. String
    columns count their dictionary codes directly. Capped at `max_values`
    distinct values; float and u64 columns raise (use group_stats or
    top_k — bucketing floats by exact bit pattern is rarely what a query
    means)."""
    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: exact count merge
        merged = {}
        for p in paths:
            for val, cnt in value_counts(p, column, max_values, mesh).items():
                merged[val] = merged.get(val, 0) + cnt
        if len(merged) > max_values:
            raise ValueError(f"{len(merged)} distinct values exceed "
                             f"max_values={max_values}")
        return merged
    path = paths[0]
    d = _str_dict_of(path, column)
    logical_bool = False
    if d is None:
        vals = distinct(path, column)
        logical_bool = vals.dtype == bool
        if vals.dtype.kind == "f":
            raise ValueError("value_counts over float columns is "
                             "ill-defined; use group_stats or top_k")
        if vals.dtype.itemsize * 8 == 64:
            raise ValueError("value_counts over 64-bit columns is not "
                             "supported without x64; use group_stats")
    else:
        vals = d
    if vals.size > max_values:
        raise ValueError(f"{vals.size} distinct values exceed "
                         f"max_values={max_values}")
    kcap = int(vals.size)
    if kcap == 0:
        return {}
    dict_dev = None if d is not None else jnp.asarray(
        vals.astype(np.uint8) if logical_bool else vals)
    counts = np.zeros(kcap, np.int64)
    for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
            path, column, mesh, natural=True):
        if valid == 0:
            continue
        flat = _flatten_logical(blocks, cdtype, vtype)
        codes = flat if d is not None else jnp.searchsorted(dict_dev, flat)
        got = (_count_codes_kernel(codes, jnp.int32(valid), kcap)
               if vmask is None else
               _count_codes_kernel_m(codes, vmask, jnp.int32(valid), kcap))
        counts += np.asarray(got, np.int64)
    if d is not None:
        return {str(vals[i]): int(counts[i]) for i in range(kcap)
                if counts[i]}
    if logical_bool:
        return {bool(vals[i]): int(counts[i]) for i in range(kcap)
                if counts[i]}
    return {int(vals[i]): int(counts[i]) for i in range(kcap) if counts[i]}


@functools.partial(jax.jit, static_argnames=("kind", "k", "largest"))
def _topk_chunk1(x, m, kind, k, largest):
    """Per-chunk top-k in a single-limb total-order key domain. `m` masks
    null rows to the worst key; output is best-first, so a caller keeping
    only the first n_valid candidates never sees a masked row (a masked
    row can only tie a real row with the identical key -> same value)."""
    if kind == "f32":
        bits = x
        key = jnp.where((bits >> jnp.uint32(31)) == jnp.uint32(1), ~bits,
                        bits ^ jnp.uint32(0x80000000))
    elif kind == "i":
        t = x.dtype.itemsize * 8
        ux = jax.lax.bitcast_convert_type(x, jnp.dtype(f"uint{t}"))
        key = (ux ^ jnp.asarray(1 << (t - 1), ux.dtype)).astype(jnp.uint32)
    else:  # unsigned <= 32 bits (incl. string dictionary codes)
        key = x.astype(jnp.uint32)
    key = key if largest else ~key
    key = jnp.where(m, key, jnp.uint32(0))  # worst in bigger-is-better space
    top, idx = jax.lax.top_k(key, k)
    return (top if largest else ~top), idx


@functools.partial(jax.jit, static_argnames=("kind", "k", "largest"))
def _topk_chunk2(lo, hi, m, kind, k, largest):
    """Two-limb (u64 / f64) per-chunk top-k: lexicographic two-key sort;
    ~ on both limbs reverses lexicographic order for the smallest-k case."""
    if kind == "f64":
        khi, klo = _f64_key(lo, hi)
    else:  # u64 -> signed-int64 order (the scans' convention)
        khi, klo = hi ^ jnp.uint32(0x80000000), lo
    if not largest:
        khi, klo = ~khi, ~klo
    khi = jnp.where(m, khi, jnp.uint32(0))
    klo = jnp.where(m, klo, jnp.uint32(0))
    iota = jnp.arange(khi.shape[0], dtype=jnp.int32)
    hs, ls, idx = jax.lax.sort([khi, klo, iota], num_keys=2)
    hs, ls, idx = hs[-k:][::-1], ls[-k:][::-1], idx[-k:][::-1]
    if not largest:
        hs, ls = ~hs, ~ls
    return hs, ls, idx


def _chunk_top(flat, m, valid, kk, largest):
    """One chunk's top-kk candidates in its total-order key domain:
    (kind, int_bits, [(key_tuple, local_idx), ...]) best-first. `m` is the
    device row mask (tail + nulls + any predicate)."""
    if isinstance(flat, tuple) and isinstance(flat[0], str):
        if flat[0] == "f64":
            hs, ls, ti = _topk_chunk2(flat[1][:valid], flat[2][:valid], m,
                                      "f64", kk, largest)
            return "f64", 64, [((int(a), int(b)), int(i)) for a, b, i in
                               zip(np.asarray(hs), np.asarray(ls),
                                   np.asarray(ti))]
        top, ti = _topk_chunk1(flat[1][:valid], m, "f32", kk, largest)
        return "f32", 32, [((int(a),), int(i)) for a, i in
                           zip(np.asarray(top), np.asarray(ti))]
    if isinstance(flat, tuple):
        hs, ls, ti = _topk_chunk2(flat[0][:valid], flat[1][:valid], m,
                                  "u64", kk, largest)
        return "u64", 64, [((int(a), int(b)), int(i)) for a, b, i in
                           zip(np.asarray(hs), np.asarray(ls),
                               np.asarray(ti))]
    npdt = np.dtype(flat.dtype.name)
    kind = "i" if npdt.kind == "i" else "u"
    top, ti = _topk_chunk1(flat[:valid], m, kind, kk, largest)
    return kind, npdt.itemsize * 8, [((int(a),), int(i)) for a, i in
                                     zip(np.asarray(top), np.asarray(ti))]


def _key_to_value(kind, int_bits, str_dict):
    """Host inverse of the total-order keys: key tuple -> python value."""
    if str_dict is not None:
        return lambda key: str(str_dict[key[0]])
    if kind == "u":
        return lambda key: int(key[0])
    if kind == "i":
        return lambda key: int(key[0]) - (1 << (int_bits - 1))
    if kind == "f32":
        return lambda key: _f32_of_key(key[0])
    if kind == "f64":
        return lambda key: _f64_of_key(*key)
    return lambda key: _i64_of(*key)  # u64 (int64 semantics)


def top_k(path: str, column: Optional[str] = None, k: int = 10,
          largest: bool = True, mesh=None) -> list:
    """The k largest (or smallest) values of a compressed column,
    duplicates included, sorted best-first. Each chunk reduces to k
    candidates on device in its total-order key domain (ints by value —
    u64 with the scans' int64 semantics; floats by IEEE total order, so
    NaN ranks above +inf and -NaN below -inf; strings lexicographically
    via dictionary codes); only k values per chunk reach the host merge.
    Null rows never rank."""
    if k <= 0:
        return []
    paths = _paths(path)
    if len(paths) > 1:  # sharded dataset: exact k-candidate value merge
        import math

        vals = []
        for p in paths:
            vals += top_k(p, column, k, largest, mesh)

        def keyf(v):  # IEEE total order: +NaN above +inf, -NaN below -inf
            if isinstance(v, float) and math.isnan(v):
                return (-1 if math.copysign(1.0, v) < 0 else 1, 0.0)
            return (0, v)

        return sorted(vals, key=keyf, reverse=largest)[:k]
    path = paths[0]
    d = _str_dict_of(path, column)
    cands = []
    kind = None
    int_bits = 32

    def visit(keep):
        nonlocal kind, int_bits
        for blocks, cdtype, vtype, valid, vmask in _decoded_chunks(
                path, column, mesh, keep=keep, natural=True):
            if valid == 0:
                continue
            if vmask is None:
                m = jnp.ones((valid,), bool)
                n_ok = valid
            else:
                m = vmask[:valid]
                n_ok = int(_count_masked(vmask, jnp.int32(valid)))
                if n_ok == 0:
                    continue
            flat = _flatten_logical(blocks, cdtype, vtype)
            kind, int_bits, new = _chunk_top(flat, m, valid, min(k, valid),
                                             largest)
            cands.extend(key for key, _idx in new[:n_ok])

    # zone-map bounds: visit chunks best-bound-first in growing batches and
    # stop once the k-th candidate beats every remaining chunk's best
    # achievable key (ORDER BY <col> LIMIT k on clustered data touches ~one
    # chunk). Stats-less chunks bound at the unbeatable extreme, so old
    # files degrade to a full visit.
    chunks, cdtype_l, transform_l, vtype_l, _nv, _bo, _nm = _column_layout(
        path, column)
    zkind, zbits = zonemaps.topk_kind(cdtype_l, vtype_l, transform_l)
    bounds = {i: zonemaps.topk_bound(meta, zkind, zbits, largest)
              for i, meta in enumerate(chunks)}
    order = [i for i, b in bounds.items() if b is not None]
    order.sort(key=lambda i: bounds[i], reverse=largest)
    if len(order) == len(chunks) and all(
            "stats" not in chunks[i] for i in order):
        visit(None)  # no zone maps anywhere: one grouped pass
    else:
        pos, batch = 0, 1
        while pos < len(order):
            if len(cands) >= k:
                kth = sorted(cands, reverse=largest)[k - 1]
                b = bounds[order[pos]]
                if (b < kth) if largest else (b > kth):
                    break  # no remaining chunk can beat the k-th candidate
            take = order[pos:pos + batch]
            pos += batch
            batch *= 4
            kl = [False] * len(chunks)
            for i in take:
                kl[i] = True
            visit(kl)
    if kind is None:
        return []
    of_key = _key_to_value(kind, int_bits, d)
    out = [of_key(key) for key in sorted(cands, reverse=largest)[:k]]
    vt = _column_layout(path, column)[3]
    if vt == "bool":
        return [bool(v) for v in out]
    if vt is not None and vt.startswith(("datetime64", "timedelta64")):
        dt = np.dtype(vt)
        return [np.int64(v).view(dt) for v in out]
    return out


def group_stats(path: str, key: str, value: str, max_groups: int = None,
                mesh=None, preds=()) -> dict:
    """GROUP BY pushdown over a compressed table file: per-group
    sum/min/max/count of the `value` column grouped by the integer `key`
    column, decoded and scatter-reduced on device per chunk. Sums carry the
    scans' exactness guarantees (integer big-ints; float superaccumulators,
    exactly rounded). Keys must be non-negative integers; the group count
    is discovered with a fused key scan unless `max_groups` is given
    (caps: 65536 for integer values, 1024 for float values — per-group
    superaccumulator bins scale with the cap). The two columns must share
    block layout (equal length and chunking — the writer's default).
    Returns {group: {sum, min, max, count}} for non-empty groups. A STRING
    `key` column groups by its dictionary codes and labels the result with
    the strings; a string `value` column aggregates lexicographic
    min/max/count (sum is None). A LIST of paths scans a sharded dataset:
    integer-keyed numeric groups share one exact accumulator; string-keyed
    or string-valued groups merge per-file results (float sums then add
    the per-file exactly-rounded sums). `preds` ANDs (column, op, value)
    WHERE predicates before grouping — SQL GROUP BY ... WHERE — with the
    scans' predicate semantics and zone-map chunk pruning."""
    paths = _paths(path)
    kdict = _str_dict_of(paths[0], key)
    vdict = _str_dict_of(paths[0], value)
    raw_preds = list(preds)
    if len(paths) > 1 and (kdict is not None or vdict is not None):
        subs = [group_stats(p, key, value, max_groups, mesh, raw_preds)
                for p in paths]
        return _merge_group_results(subs, vdict is not None)
    if max_groups is None:
        if kdict is not None:
            if kdict.size == 0:
                return {}
            max_groups = int(kdict.size)
        else:
            # the cap only needs the key range: header-only when zone maps
            # cover the column, one fused scan otherwise
            ks = _stats_summary(paths, key)
            if ks is None:
                ks = scan_column(path, column=key, mesh=mesh)
            if ks["count"] == 0:
                return {}
            if ks["min"] < 0:
                raise ValueError(f"group keys must be >= 0; {key!r} has "
                                 f"min {ks['min']}")
            max_groups = int(ks["max"]) + 1
    k = int(max_groups)

    kind = None
    acc = None

    def _rows():
        for p in paths:
            preds_p = _normalize_preds(p, raw_preds)
            names = list(dict.fromkeys(
                [key, value] + [q[0] for q in preds_p]))
            keep = _zone_keep(p, preds_p, names=names)
            for rows in _lockstep_chunks(p, names, mesh, keep=keep):
                yield rows, preds_p

    for rows, preds_p in _rows():
        kb, kdt, kvt, k_valid, k_mask = rows[key]
        vb, vdt, vvt, v_valid, v_mask = rows[value]
        flat_v = _flatten_logical(vb, vdt, vvt)
        flat_k = _flatten_logical(kb, kdt, kvt)
        if isinstance(flat_k, tuple):
            raise ValueError(
                f"group key column {key!r} must be an integer column of "
                "width <= 32 (u8/u16/u32 or signed)")
        if v_valid == 0:
            continue
        mask = k_mask
        if v_mask is not None:
            mask = v_mask if mask is None else mask & v_mask
        if preds_p:  # WHERE: failing rows leave every group
            pm = _chunk_row_mask(rows, preds_p)
            mask = pm if mask is None else mask & pm
        if mask is not None:  # null key OR null value: row leaves the group
            flat_k = _mask_keys_kernel(flat_k, mask, k)
        v = jnp.int32(v_valid)
        if isinstance(flat_v, tuple) and isinstance(flat_v[0], str):
            if flat_v[0] == "f64":
                if k > _GROUP_CAP_FLOAT:
                    raise ValueError(
                        f"group_stats over float columns caps at "
                        f"{_GROUP_CAP_FLOAT} groups (got {k})")
                kind = kind or "f64"
                acc = acc or _GroupAcc(k, "f64")
                acc.feed_f64(_group_kernel_f64(flat_k, flat_v[1], flat_v[2],
                                               v, k))
            else:
                if k > _GROUP_CAP_FLOAT:
                    raise ValueError(
                        f"group_stats over float columns caps at "
                        f"{_GROUP_CAP_FLOAT} groups (got {k})")
                kind = kind or "f32"
                acc = acc or _GroupAcc(k, "f32")
                acc.feed_f32(_group_kernel_f32(flat_k, flat_v[1], v, k))
        elif isinstance(flat_v, tuple):
            kind = kind or "u64"
            acc = acc or _GroupAcc(k, "u64")
            acc.feed_u64(_group_kernel_u64(flat_k, flat_v[0], flat_v[1],
                                           v, k))
        else:
            if k > _GROUP_CAP_INT:
                raise ValueError(f"group_stats caps at {_GROUP_CAP_INT} "
                                 f"groups (got {k})")
            kind = kind or "int"
            acc = acc or _GroupAcc(k, "int",
                                   np.dtype(flat_v.dtype.name).itemsize * 8)
            acc.feed_int(_group_kernel_int(flat_k, flat_v, v, k))
    out = acc.result() if acc is not None else {}
    if vdict is not None:  # string value column: codes -> labels
        out = {g: _map_str_result(s, vdict) for g, s in out.items()}
    if kdict is not None:  # string key column: label groups
        out = {str(kdict[g]): s for g, s in out.items()}
    return out
