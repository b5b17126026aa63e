"""Device-side FLT reads: host IO ships only compressed bytes; the
accelerator decodes.

The IO story the host-only `fio` module cannot tell: for a width-W u32
column only W/32 of the raw bytes cross PCIe/host memory — the routed
decode entries (kernels.*) expand to full values directly in device
memory, optionally
sharded over a `jax.sharding.Mesh` (each device decodes its shard of blocks,
collective-free; reference has no IO layer — this is new surface mandated by
the north star, composing fio's chunk format with ops/kernels/parallel).

u64 integer columns come back as `limbs.LimbPlanes` — separate (lo, hi)
uint32 planes, the fast device form (decode never pays the strided limb
interleave). `np.asarray(result)`
still yields the (..., 2) uint32 byte image; `.interleaved()` gives it on
device; `.to_u64()` a host uint64 array.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax.numpy as jnp
import numpy as np

from . import fio, transforms
from .core import layout
from .kernels import codecs as pk
from .limbs import LimbPlanes
from .parallel import shard as psh


class NullableColumn:
    """Device-decoded nullable column: decoded values (array, LimbPlanes or
    StringColumn) plus a device validity mask (True = present). The filler
    values at null positions are real neighbours (fio null compression) —
    consumers must gate on `valid`."""

    def __init__(self, values, valid):
        self.values = values
        self.valid = valid

    @property
    def n_null(self) -> int:
        return int(self.valid.size - int(jnp.sum(self.valid)))

    def materialize(self) -> np.ma.MaskedArray:
        """Host masked array (one device fetch of values + mask)."""
        from . import fio_table

        mask = ~np.asarray(self.valid)
        if isinstance(self.values, fio_table.StringColumn):
            return np.ma.MaskedArray(self.values.materialize(), mask=mask)
        return np.ma.MaskedArray(np.asarray(self.values), mask=mask)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"NullableColumn(valid_shape={tuple(self.valid.shape)}, "
                f"n_null={self.n_null})")


def _np_to_device_form(arr: np.ndarray, dtype: str):
    """Host buffer -> engine-friendly array: u64 becomes (..., 2) uint32."""
    if dtype == "u64":
        limbs = arr.view(np.uint32).reshape(*arr.shape, 2)
        return jnp.asarray(limbs)
    return jnp.asarray(arr)


def _is_planes(blocks) -> bool:
    return isinstance(blocks, (tuple, LimbPlanes))


def _unzigzag_device(codes, dtype: str):
    """Zigzag codes -> two's-complement bits, in the wire's unsigned domain
    ((lo, hi) planes for u64; see transforms.zigzag_decode_limb)."""
    import jax

    if dtype == "u64":
        lo, hi = codes if isinstance(codes, tuple) else (codes.lo, codes.hi)
        return transforms.zigzag_decode_limb(lo, hi)
    t = layout.bit_width(dtype)
    return jax.lax.bitcast_convert_type(
        transforms.zigzag_decode(codes), jnp.dtype(f"uint{t}"))


def _decode_chunk_device(meta: dict, raw: bytes, n_blocks: int, dtype: str,
                         mesh=None, natural=False):
    nl = layout.lanes(dtype)
    np_dt = layout.np_dtype(dtype)
    w = meta["width"]
    codec = meta["codec"]
    plen = layout.packed_len(dtype, w)

    if codec == "rle":
        return _decode_rle_batched([(meta, raw)], dtype, mesh)

    if codec == "dict":
        return _decode_dict_batched([(meta, raw)], dtype, mesh)

    if codec == "alp":
        return _decode_alp_batched([(meta, raw)], dtype, mesh)

    if codec == "alprd":
        from . import alp as alp_mod

        np_float = fio._VTYPES[meta["vtype"]]
        packed_r, packed_i, exc_pos, exc_left = fio._split_alprd_payload(
            meta, raw, n_blocks, dtype)
        pr = _np_to_device_form(np.ascontiguousarray(packed_r), dtype)
        pi = jnp.asarray(np.ascontiguousarray(packed_i))
        if mesh is not None:
            rights = psh.sharded_unpack(mesh, pr, meta["width"], dtype)
            left_idx = psh.sharded_unpack(mesh, pi, meta["idx_width"], "u16")
        else:
            rights = pk.unpack(pr, meta["width"], dtype)
            left_idx = pk.unpack(pi, meta["idx_width"], "u16")
        return alp_mod.rd_decode_device(
            left_idx, rights, np.asarray(meta["dict"], np.uint32),
            meta["width"], np_float, exc_pos, exc_left)

    if codec in ("delta", "zdelta"):
        base_np, packed_np = _parse_delta_payload(raw, n_blocks, dtype, nl,
                                                  np_dt, plen)
        return _decode_packed_device(
            codec, _np_to_device_form(packed_np, dtype),
            _np_to_device_form(base_np, dtype), w, None, dtype, mesh,
            natural=natural)
    packed = _np_to_device_form(np.frombuffer(raw, np_dt).reshape(n_blocks, plen), dtype)
    if codec in ("bitpack", "ffor"):
        return _decode_packed_device(codec, packed, None, w,
                                     meta.get("reference"), dtype, mesh)
    raise ValueError(f"unknown codec {codec!r}")


def _parse_delta_payload(raw, n_blocks, dtype, nl, np_dt, plen):
    """Host views of a delta/zdelta chunk payload: (base, packed) numpy."""
    base_bytes = n_blocks * nl * np_dt.itemsize
    base = np.frombuffer(raw[:base_bytes], np_dt).reshape(n_blocks, nl)
    packed = np.frombuffer(raw[base_bytes:], np_dt).reshape(n_blocks, plen)
    return base, packed


@functools.lru_cache(maxsize=None)
def _jitted_chunk_decode(codec, w, dtype, planes, orig=True):
    """One jit-compiled executable per (codec, width, dtype): the routed
    decode entries are otherwise traced EAGERLY here (the ops strategy
    would run op-by-op, one dispatch per op).
    Shape-keyed by jit's own cache; ffor's reference rides in-graph.
    `orig=False` (delta-family only) returns the NATURAL transposed-domain
    image — order-insensitive consumers (analytics reductions) skip the
    untranspose relayout entirely."""
    import jax

    if codec == "zdelta":
        if not orig:
            return jax.jit(lambda p, b: pk.unzdelta_pack(p, b, w, dtype,
                                                         planes=planes))
        return jax.jit(lambda p, b: pk.unzdelta_pack_orig(p, b, w, dtype,
                                                          planes=planes))
    if codec == "delta":
        if not orig:
            return jax.jit(lambda p, b: pk.undelta_pack(p, b, w, dtype,
                                                        planes=planes))
        return jax.jit(lambda p, b: pk.undelta_pack_orig(p, b, w, dtype,
                                                         planes=planes))
    if codec == "bitpack":
        return jax.jit(lambda p: pk.unpack(p, w, dtype, planes=planes))
    if codec == "ffor":
        return jax.jit(lambda p, r: pk.unfor_pack(p, r, w, dtype,
                                                  planes=planes))
    raise ValueError(f"unknown codec {codec!r}")


def _decode_packed_device(codec, packed, base, w, ref_val, dtype, mesh,
                          natural=False):
    """Device decode of a parsed (possibly multi-chunk batched) payload.
    `natural=True` (delta-family only) keeps the transposed-domain image —
    no untranspose relayout; callers must be order-insensitive."""
    planes = dtype == "u64"  # u64 decodes stay in the (lo, hi) plane domain
    if codec in ("delta", "zdelta"):
        # original-order fused decode: the untranspose takes the routed
        # strategy per (op, dtype, width) (kernels.*_orig routing)
        orig = not natural
        if codec == "zdelta":
            if mesh is not None:
                return psh.sharded_unzdelta_pack(mesh, packed, base, w, dtype,
                                                 planes=planes, orig=orig)
        elif mesh is not None:
            return psh.sharded_undelta_pack(mesh, packed, base, w, dtype,
                                            planes=planes, orig=orig)
        if mesh is None:
            return _jitted_chunk_decode(codec, w, dtype, planes,
                                        orig)(packed, base)
    if codec == "bitpack":
        if mesh is not None:
            return psh.sharded_unpack(mesh, packed, w, dtype, planes=planes)
        return _jitted_chunk_decode(codec, w, dtype, planes)(packed)
    if codec == "ffor":
        if mesh is not None:
            return psh.sharded_unfor_pack(mesh, packed, ref_val, w, dtype,
                                          planes=planes)
        ref_arr = np.asarray(ref_val, layout.np_dtype(dtype))
        if dtype == "u64":
            ref_arr = ref_arr.reshape(1).view(np.uint32)  # (2,) limb pair
        return _jitted_chunk_decode(codec, w, dtype, planes)(packed, ref_arr)
    raise ValueError(f"unknown codec {codec!r}")


#: codecs whose payloads batch across chunks (same width) into ONE device
#: dispatch — a 64-chunk file decoded chunk-at-a-time pays 64 dispatches
#: and 64 host-to-device transfers. rle always batches (the run-index stream is W=1 by
#: construction; run values concatenate into one flat gather). ffor stays
#: per-chunk: its per-chunk scalar reference would need per-block
#: reference plumbing through the decode entries.
_BATCHABLE = ("bitpack", "delta", "zdelta", "rle", "dict")


def _group_sig(meta):
    import os

    if os.environ.get("FASTLANES_NO_CHUNK_BATCH") == "1":
        return None  # A/B lever for benchmarks: force chunk-at-a-time
    if meta["codec"] in _BATCHABLE:
        return (meta["codec"], meta["width"])
    if meta["codec"] == "alp":
        # alp chunks batch when the whole decode recipe matches; exception
        # positions are chunk-relative and get block offsets when merged
        return ("alp", meta["width"], meta["e"], meta["f"],
                meta["reference"], meta["vtype"])
    return None


def _decode_alp_batched(run, dtype, mesh):
    """One unpack + one scale/scatter pass for a run of alp chunks sharing
    (width, e, f, reference, vtype)."""
    from . import alp as alp_mod

    meta0 = run[0][0]
    w = meta0["width"]
    np_float = fio._VTYPES[meta0["vtype"]]
    np_dt = layout.np_dtype(dtype)
    plen = layout.packed_len(dtype, w)
    packeds, poss, vals_list = [], [], []
    block_off = 0
    for meta, raw in run:
        packed, exc_pos, exc_val = fio._split_alp_payload(
            meta, raw, meta["n_blocks"], dtype, np_float)
        packeds.append(packed)
        poss.append(np.asarray(exc_pos, np.int64) + block_off * layout.BLOCK)
        vals_list.append(exc_val)
        block_off += meta["n_blocks"]
    packed_dev = _np_to_device_form(
        np.concatenate(packeds) if len(packeds) > 1
        else np.ascontiguousarray(packeds[0]), dtype)
    exc_pos = np.concatenate(poss) if len(poss) > 1 else poss[0]
    exc_val = np.concatenate(vals_list) if len(vals_list) > 1 else vals_list[0]
    if mesh is not None:
        shifted = psh.sharded_unpack(mesh, packed_dev, w, dtype)
    else:
        shifted = pk.unpack(packed_dev, w, dtype)
    # u64 payloads pass through as the (..., 2) uint32 limb image:
    # decode_device runs the spec's correctly-rounded division in the
    # limb domain (x64-free; float64 comes back as the f64 bit image
    # unless jax x64 is enabled)
    return alp_mod.decode_device(shifted, meta0["e"], meta0["f"],
                                 meta0["reference"], np_float,
                                 exc_pos, exc_val)


def _decode_dict_batched(run, dtype, mesh):
    """All dict chunks of a run decode in ONE u16 unpack dispatch + ONE
    gather: concatenated code streams index a flat concatenated dictionary
    via per-chunk offsets (the rle flat-run-stream trick)."""
    dicts, packeds, n_blocks_each = [], [], []
    for meta, raw in run:
        dictionary, packed = fio._split_dict_payload(
            meta, raw, meta["n_blocks"], dtype)
        dicts.append(dictionary)
        packeds.append(packed)
        n_blocks_each.append(meta["n_blocks"])
    pi = jnp.asarray(np.concatenate([np.ascontiguousarray(p) for p in packeds]))
    w = run[0][0]["width"]
    if mesh is not None:
        codes = psh.sharded_unpack(mesh, pi, w, "u16")
    else:
        codes = pk.unpack(pi, w, "u16")
    sizes = np.array([d.size for d in dicts], np.int64)
    chunk_offsets = np.cumsum(sizes) - sizes
    block_offsets = np.repeat(chunk_offsets, n_blocks_each).astype(np.int32)
    flat_idx = codes.astype(jnp.int32) + jnp.asarray(block_offsets)[:, None]
    dv = _np_to_device_form(np.ascontiguousarray(np.concatenate(dicts)), dtype)
    if dtype == "u64":
        return (jnp.take(dv[..., 0], flat_idx, axis=0),
                jnp.take(dv[..., 1], flat_idx, axis=0))
    return jnp.take(dv, flat_idx, axis=0)


def _decode_rle_batched(run, dtype, mesh):
    """All rle chunks of a run decode in ONE index-decode dispatch + ONE
    gather: per-chunk host payload splits, then concatenated index streams
    and a flat run-value stream with global offsets."""
    pis, bvs, all_counts, rvs = [], [], [], []
    for meta, raw in run:
        counts, basev, packed_idx, run_values = fio._split_rle_payload(
            meta, raw, meta["n_blocks"], dtype)
        pis.append(packed_idx)
        bvs.append(basev)
        all_counts.append(counts)
        rvs.append(run_values)
    pi = jnp.asarray(np.concatenate([np.ascontiguousarray(p) for p in pis]))
    bv = jnp.asarray(np.concatenate([np.ascontiguousarray(b) for b in bvs]))
    counts = np.concatenate(all_counts)
    run_values = np.concatenate(rvs)
    return _rle_gather(pi, bv, counts, run_values, dtype, mesh)


def _rle_gather(pi, bv, counts, run_values, dtype, mesh):
    if mesh is not None:
        idx_u16 = psh.sharded_undelta_pack(mesh, pi, bv, 1, "u16", orig=True)
    else:
        idx_u16 = pk.undelta_pack_orig(pi, bv, 1, "u16")
    idx = idx_u16.astype(jnp.int32)
    # gather: per-block run index + the block's offset into the flat run
    # value stream = one vectorized device gather. No per-block host loop,
    # and memory stays at the exact run count (a padded (n_blocks,
    # max_count) staging table is worst-case 1024x larger when any block
    # is run-dense).
    offsets = (np.cumsum(counts) - counts).astype(np.int32)
    flat_idx = idx + jnp.asarray(offsets)[:, None]
    rv = _np_to_device_form(np.ascontiguousarray(run_values), dtype)
    if dtype == "u64":
        # separate planes out — no interleaving stack (the fast form)
        return (jnp.take(rv[..., 0], flat_idx, axis=0),
                jnp.take(rv[..., 1], flat_idx, axis=0))
    return jnp.take(rv, flat_idx, axis=0)


def _decode_chunks_grouped(covering, dtype, mesh, natural=False):
    """Decode a list of (meta, raw) chunks, batching consecutive runs with
    the same (codec, width) signature into one device dispatch. Returns
    device arrays/plane tuples in chunk order (merged runs yield one).
    `natural=True`: delta-family chunks keep the transposed-domain image
    (order-insensitive consumers only)."""
    parts = []
    i = 0
    while i < len(covering):
        meta, raw = covering[i]
        sig = _group_sig(meta)
        j = i + 1
        while sig is not None and j < len(covering) and \
                _group_sig(covering[j][0]) == sig:
            j += 1
        if j - i == 1:
            parts.append(_decode_chunk_device(meta, raw, meta["n_blocks"],
                                              dtype, mesh=mesh,
                                              natural=natural))
            i = j
            continue
        parts.append(_decode_run_batched(sig, covering[i:j], dtype, mesh,
                                         natural=natural))
        i = j
    return parts


def _decode_run_batched(sig, run, dtype, mesh, natural=False):
    """Decode a run of same-signature (meta, raw) chunks in ONE device
    dispatch; returns the merged (sum-of-n_blocks, 1024) output."""
    nl = layout.lanes(dtype)
    np_dt = layout.np_dtype(dtype)
    codec = sig[0]
    # concatenate payloads on the HOST, then one transfer + one dispatch
    if codec == "rle":
        return _decode_rle_batched(run, dtype, mesh)
    if codec == "dict":
        return _decode_dict_batched(run, dtype, mesh)
    if codec == "alp":
        return _decode_alp_batched(run, dtype, mesh)
    w = sig[1]
    plen = layout.packed_len(dtype, w)
    if codec in ("delta", "zdelta"):
        pairs = [_parse_delta_payload(r, m["n_blocks"], dtype, nl, np_dt,
                                      plen) for m, r in run]
        base = _np_to_device_form(
            np.concatenate([p[0] for p in pairs], axis=0), dtype)
        packed = _np_to_device_form(
            np.concatenate([p[1] for p in pairs], axis=0), dtype)
    else:  # bitpack
        base = None
        packed = _np_to_device_form(np.concatenate(
            [np.frombuffer(r, np_dt).reshape(m["n_blocks"], plen)
             for m, r in run], axis=0), dtype)
    return _decode_packed_device(codec, packed, base, w, None,
                                 dtype, mesh, natural=natural)


def _concat_parts(parts, dtype):
    """Concatenate decoded chunk outputs (plane-pair aware)."""
    if not parts:
        if dtype == "u64":
            z = jnp.zeros((0, layout.BLOCK), jnp.uint32)
            return z, z
        return jnp.zeros((0, layout.BLOCK), layout.np_dtype(dtype))
    if len(parts) == 1:
        return parts[0]
    if _is_planes(parts[0]):
        pairs = [(p.lo, p.hi) if isinstance(p, LimbPlanes) else p
                 for p in parts]
        return (jnp.concatenate([p[0] for p in pairs], axis=0),
                jnp.concatenate([p[1] for p in pairs], axis=0))
    return jnp.concatenate(parts, axis=0)


def _read_chunks_device(f, chunks, base_off: int, chunk_blocks: int,
                        start: int, stop: int, dtype: str, mesh):
    """Device twin of fio.read_chunk_range: only covering chunks decode, and
    consecutive same-(codec, width) chunks decode in ONE batched dispatch
    (_decode_chunks_grouped)."""
    covering = []
    first_start = None
    for ci, meta in enumerate(chunks):
        c_start = ci * chunk_blocks
        c_stop = c_start + meta["n_blocks"]
        if c_stop <= start or c_start >= stop:
            continue
        if first_start is None:
            first_start = c_start
        f.seek(base_off + meta["offset"])
        covering.append((meta, f.read(meta["nbytes"])))
    if not covering:
        return _concat_parts([], dtype)
    parts = _decode_chunks_grouped(covering, dtype, mesh)
    blocks = _concat_parts(parts, dtype)
    lohi = slice(start - first_start,
                 stop - first_start)  # trim to the requested block range
    if _is_planes(blocks):
        lo, hi = blocks if isinstance(blocks, tuple) else (blocks.lo, blocks.hi)
        return lo[lohi], hi[lohi]
    return blocks[lohi]


def _apply_transform_device(blocks, transform, dtype: str):
    if transform is None:
        return blocks
    if transform == "zigzag":
        if dtype == "u64":
            # limb-domain unzigzag yields the int64 bit pattern — the
            # (lo, hi) planes of the signed values
            return _unzigzag_device(blocks, dtype)
        return transforms.zigzag_decode(blocks)
    if transform == "viewu":
        if dtype == "u64":  # the limb planes already carry the raw bits
            return blocks
        import jax

        t = layout.bit_width(dtype)
        return jax.lax.bitcast_convert_type(blocks, jnp.dtype(f"int{t}"))
    raise ValueError(f"unknown transform {transform!r}")


def _trim_flat(blocks, n_values, dtype: str):
    if _is_planes(blocks):
        lo, hi = blocks if isinstance(blocks, tuple) else (blocks.lo, blocks.hi)
        if n_values is not None:
            lo, hi = lo.reshape(-1)[:n_values], hi.reshape(-1)[:n_values]
        return lo, hi
    if n_values is None:
        return blocks
    if jnp.issubdtype(blocks.dtype, jnp.floating):  # ALP column: real floats
        return blocks.reshape(-1)[:n_values]
    if dtype == "u64":  # legacy interleaved image (ALP f64 bit image)
        return blocks.reshape(-1, 2)[:n_values]
    return blocks.reshape(-1)[:n_values]


def _publish(blocks):
    """Internal (lo, hi) tuples -> the public LimbPlanes carrier."""
    if isinstance(blocks, tuple):
        return LimbPlanes(*blocks)
    return blocks


def _wrap_column_nulls(result, path, base_off, nulls_meta, start, stop,
                       n_values):
    """Attach the device validity mask for blocks [start, stop); `n_values`
    trims the mask like the values (full flat reads)."""
    valid = fio.read_validity_range(path, nulls_meta, base_off, start, stop)
    if n_values is not None:
        valid = valid.reshape(-1)[:n_values]
    return NullableColumn(result, jnp.asarray(valid))


def read_blocks_device(path: str, start: int = 0, stop: Optional[int] = None,
                       mesh=None):
    """Decode blocks [start, stop) of an FLT file on the accelerator.

    Returns a jax array of shape (stop-start, 1024); u64 integer columns
    return `limbs.LimbPlanes` (separate lo/hi uint32 planes — np.asarray
    gives the (..., 2) byte image). With `mesh`, each chunk's decode is
    shard_mapped over the block axis — multi-chip decode of one file."""
    header = fio.read_header(path)
    dtype = header["dtype"]
    n = header["n_blocks"]
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    with open(path, "rb") as f:
        blocks = _read_chunks_device(f, header["chunks"], fio._payload_base(path),
                                     header["chunk_blocks"], start, stop, dtype,
                                     mesh)
    out = _publish(_apply_transform_device(blocks, header.get("transform"), dtype))
    if "nulls" in header and stop > start:
        return _wrap_column_nulls(out, path, fio._payload_base(path),
                                  header["nulls"], start, stop, None)
    return out


def read_file_device(path: str, mesh=None):
    """Whole-file device decode; flat-written columns come back flat and
    trimmed to their exact original length (see fio.write_file). u64
    integer columns return `limbs.LimbPlanes`."""
    header = fio.read_header(path)
    blocks = read_blocks_device(path, mesh=mesh)
    valid = None
    if isinstance(blocks, NullableColumn):
        valid, blocks = blocks.valid, blocks.values
    if isinstance(blocks, LimbPlanes):
        blocks = (blocks.lo, blocks.hi)
    out = _publish(_trim_flat(blocks, header.get("n_values"), header["dtype"]))
    if valid is not None:
        nv = header.get("n_values")
        if nv is not None:
            valid = valid.reshape(-1)[:nv]
        return NullableColumn(out, valid)
    return out


def _slice_blocks(blocks, start: int, stop: int):
    if _is_planes(blocks):
        lo, hi = blocks if isinstance(blocks, tuple) else (blocks.lo, blocks.hi)
        return lo[start:stop], hi[start:stop]
    return blocks[start:stop]


def read_files_device(paths, mesh=None) -> dict:
    """Whole-file device decode of MANY FLT files with CROSS-FILE batched
    dispatch: every chunk sharing a (dtype, codec, width[, alp recipe])
    signature — regardless of which file it came from — decodes in ONE
    device call, then per-file outputs are sliced back out. A 100-shard
    dataset of same-codec columns costs one decode dispatch + one slice
    per file instead of >=100 dispatches (see _BATCHABLE). Returns {path: decoded} with the same
    per-file semantics as read_file_device (transform applied, flat
    columns trimmed, u64 integer columns as LimbPlanes).

    The extension of the reference's fused-composition story (macros.rs
    :5-9) to serving: the batch axis is just more blocks."""
    paths = list(dict.fromkeys(paths))  # dedupe, keep order
    headers, file_chunks = {}, {}
    for path in paths:
        header = fio.read_header(path)
        headers[path] = header
        base = fio._payload_base(path)
        chunks = []
        with open(path, "rb") as f:
            for meta in header["chunks"]:
                f.seek(base + meta["offset"])
                chunks.append((meta, f.read(meta["nbytes"])))
        file_chunks[path] = chunks

    # group every batchable chunk across files by (dtype, signature); slots
    # keep (path, chunk index) so merged outputs route back in order
    groups, singles = {}, []
    for path in paths:
        dtype = headers[path]["dtype"]
        for ci, (meta, raw) in enumerate(file_chunks[path]):
            sig = _group_sig(meta)
            if sig is None:
                singles.append((path, ci, meta, raw))
            else:
                groups.setdefault((dtype, sig), []).append((path, ci, meta, raw))

    decoded = {}  # (path, ci) -> device part
    for (dtype, sig), members in groups.items():
        if len(members) == 1:
            path, ci, meta, raw = members[0]
            decoded[(path, ci)] = _decode_chunk_device(
                meta, raw, meta["n_blocks"], dtype, mesh=mesh)
            continue
        merged = _decode_run_batched(sig, [(m, r) for _, _, m, r in members],
                                     dtype, mesh)
        # slice per (path, ci); consecutive same-file members merge into one
        # slice when the file's parts are later concatenated anyway
        off = 0
        for path, ci, meta, _ in members:
            n = meta["n_blocks"]
            decoded[(path, ci)] = _slice_blocks(merged, off, off + n)
            off += n
    for path, ci, meta, raw in singles:
        decoded[(path, ci)] = _decode_chunk_device(
            meta, raw, meta["n_blocks"], headers[path]["dtype"], mesh=mesh)

    out = {}
    for path in paths:
        header = headers[path]
        dtype = header["dtype"]
        parts = [decoded[(path, ci)] for ci in range(len(file_chunks[path]))]
        blocks = _concat_parts(parts, dtype)
        blocks = _apply_transform_device(blocks, header.get("transform"), dtype)
        result = _publish(
            _trim_flat(blocks if not isinstance(blocks, LimbPlanes)
                       else (blocks.lo, blocks.hi),
                       header.get("n_values"), dtype))
        if "nulls" in header:
            result = _wrap_column_nulls(
                result, path, fio._payload_base(path), header["nulls"],
                0, header["n_blocks"], header.get("n_values"))
        out[path] = result
    return out


def _read_raw_file(path: str):
    """Host side of the pipeline: header + every chunk's raw bytes."""
    header = fio.read_header(path)
    base = fio._payload_base(path)
    raws = []
    with open(path, "rb") as f:
        for meta in header["chunks"]:
            f.seek(base + meta["offset"])
            raws.append(f.read(meta["nbytes"]))
    return header, raws


def iter_files_device(paths, mesh=None, prefetch: int = 2):
    """Pipelined multi-file device decode: yields (path, decoded array) in
    order, with host IO for upcoming files prefetched on a reader thread
    while the chip decodes the current one (jax dispatch is async, so
    decode of file k overlaps the read of file k+1 naturally; the thread
    additionally overlaps the blocking disk reads). The streaming form of
    read_file_device for feeding a mesh from many FLT files."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    paths = list(paths)
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = collections.deque()
        it = iter(paths)
        for _ in range(max(1, prefetch)):
            p = next(it, None)
            if p is not None:
                pending.append((p, ex.submit(_read_raw_file, p)))
        while pending:
            path, fut = pending.popleft()
            header, raws = fut.result()
            nxt = next(it, None)
            if nxt is not None:
                pending.append((nxt, ex.submit(_read_raw_file, nxt)))
            dtype = header["dtype"]
            parts = _decode_chunks_grouped(list(zip(header["chunks"], raws)),
                                           dtype, mesh)
            blocks = _concat_parts(parts, dtype)
            blocks = _apply_transform_device(blocks, header.get("transform"), dtype)
            result = _publish(_trim_flat(blocks, header.get("n_values"), dtype))
            if "nulls" in header:
                result = _wrap_column_nulls(
                    result, path, fio._payload_base(path), header["nulls"],
                    0, header["n_blocks"], header.get("n_values"))
            yield path, result


def read_column_device(path: str, name: str, start: int = 0,
                       stop: Optional[int] = None, mesh=None):
    """Decode one column of an FLTTAB table file on the accelerator —
    touches only the covering chunks, applies the column's transform, and
    (for full reads of flat-written columns) trims to exact length."""
    from . import fio_table

    header = fio_table.read_table_header(path)
    col = fio_table._col_meta(header, name)
    dtype = col["dtype"]
    n = col["n_blocks"]
    full = start == 0 and stop is None
    stop = n if stop is None else min(stop, n)
    if not 0 <= start <= stop:
        raise IndexError(f"bad block range [{start}, {stop})")
    base_off = fio.payload_base_of(path, fio_table.MAGIC)
    with open(path, "rb") as f:
        blocks = _read_chunks_device(f, col["chunks"], base_off,
                                     col["chunk_blocks"], start, stop, dtype,
                                     mesh)
        dictionary = (fio_table._load_str_dict(f, base_off, col)
                      if col.get("vtype") == "str" else None)
    blocks = _apply_transform_device(blocks, col.get("transform"), dtype)
    if full:
        blocks = _trim_flat(blocks, col.get("n_values"), dtype)
    if dictionary is not None:
        # codes stay on device; predicates/group-bys run as code compares
        out = fio_table.StringColumn(blocks, dictionary)
    else:
        out = _publish(blocks)
    if "nulls" in col and stop > start:
        return _wrap_column_nulls(
            out, path, base_off, col["nulls"], start, stop,
            col.get("n_values") if full else None)
    return out
