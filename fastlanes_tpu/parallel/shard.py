"""shard_map codec execution over the block axis.

Blocks are independent (SURVEY.md §5 long-context note), so the core ops run
collective-free per shard; collectives appear only where the *framework*
adds cross-block coordination:

  * global_max_bits  — pmax over the mesh to agree on one packing width
  * all_gather_packed — gather per-device payloads back in vector order
  * sharded_roundtrip_check — psum'd mismatch count (validation/monitoring)

Per-column scalars (FoR reference, delta base) are replicated via P(None).
Works identically on a virtual CPU mesh, the GPUs of one host, or several
hosts (mesh built over jax.devices() after jax.distributed.initialize)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core import layout
from ..ops import _engine as eng


def _block_spec(dtype, axis):
    """PartitionSpec for a (B, cols[, limb]) array sharded on blocks."""
    if eng.is_limb(dtype):
        return P(axis, None, None)
    return P(axis, None)


def _pad_to(arr, mult):
    b = arr.shape[0]
    pad = (-b) % mult
    if pad:
        arr = jnp.concatenate([arr, jnp.zeros((pad, *arr.shape[1:]), arr.dtype)], axis=0)
    return arr, b


@functools.lru_cache(maxsize=None)
def _build_sharded(name, width, dtype, axis, mesh, param, planes=False):
    """jit(shard_map(codec)) — cached so repeated calls with the same
    (op, mesh, width, dtype) hit one compiled executable instead of
    re-tracing an eager shard_map per call. `param` describes the second
    operand: None, ('rep', ndim) replicated, or ('blk', ndim) block-sharded.
    planes=True (u64 decode): the codec returns separate (lo, hi) uint32
    planes, each block-sharded — no interleaving stack on the device."""
    fn = _codec_fn(name, planes=planes)
    spec = _block_spec(dtype, axis)
    out_spec = (P(axis, None), P(axis, None)) if planes else spec
    if param is None:
        sharded = jax.shard_map(lambda v: fn(v, width, dtype), mesh=mesh,
                                in_specs=(spec,), out_specs=out_spec)
    else:
        kind, ndim = param
        if kind == "blk":
            p_spec = P(axis, *([None] * (ndim - 1)))
        else:
            p_spec = P(*([None] * ndim))
        sharded = jax.shard_map(lambda v, p: fn(v, p, width, dtype), mesh=mesh,
                                in_specs=(spec, p_spec), out_specs=out_spec)
    return jax.jit(sharded)


def _slice_out(out, b, planes):
    if planes:
        return out[0][:b], out[1][:b]
    return out[:b]


def _sharded_unary(name, mesh, arr, width, dtype, axis, planes=False):
    call = _build_sharded(name, width, dtype, axis, mesh, None, planes=planes)
    padded, b = _pad_to(jnp.asarray(arr), mesh.shape[axis])
    return _slice_out(call(padded), b, planes)


def sharded_pack(mesh, values, width, dtype, axis="blocks"):
    """Data-parallel pack: each device packs its shard of blocks. No
    collectives."""
    return _sharded_unary("pack", mesh, values, width, dtype, axis)


def sharded_unpack(mesh, packed, width, dtype, axis="blocks", planes=False,
                   orig=False):
    """planes=True (u64 only): (lo, hi) uint32 plane outputs, block-sharded —
    the fast device form (no interleaving stack). orig=True: decode straight
    to ORIGINAL order (untranspose fused per shard; see kernels.unpack_orig)."""
    name = "unpack_orig" if orig else "unpack"
    return _sharded_unary(name, mesh, packed, width, dtype, axis, planes=planes)


def _sharded_delta_family(op, mesh, packed, base, width, dtype, axis, planes,
                          orig):
    packed, base = jnp.asarray(packed), jnp.asarray(base)
    per_block = base.ndim == packed.ndim and base.shape[0] == packed.shape[0]
    param = ("blk" if per_block else "rep", base.ndim)
    call = _build_sharded(op + "_orig" if orig else op, width, dtype, axis,
                          mesh, param, planes=planes)
    padded, b = _pad_to(packed, mesh.shape[axis])
    if per_block:
        base, _ = _pad_to(base, mesh.shape[axis])
    return _slice_out(call(padded, base), b, planes)


def sharded_undelta_pack(mesh, packed, base, width, dtype, axis="blocks",
                         planes=False, orig=False):
    """Fused delta decode. A shared per-lane base ((LANES,) or limb image) is
    replicated (P(None)); a per-block base ((B, LANES)[, 2]) is sharded along
    the block axis with the packed payload. orig=True decodes straight to
    original order (untranspose fused per shard)."""
    return _sharded_delta_family("undelta_pack", mesh, packed, base, width,
                                 dtype, axis, planes, orig)


def sharded_unzdelta_pack(mesh, packed, base, width, dtype, axis="blocks",
                          planes=False, orig=False):
    """Fused zdelta decode (unpack -> unzigzag -> prefix-sum) sharded over
    blocks; base replication/sharding rules as sharded_undelta_pack."""
    return _sharded_delta_family("unzdelta_pack", mesh, packed, base, width,
                                 dtype, axis, planes, orig)


def sharded_for_pack(mesh, values, reference, width, dtype, axis="blocks"):
    """FFoR encode with replicated scalar reference."""
    ref_arr = _ref_array(reference, dtype)
    call = _build_sharded("for_pack", width, dtype, axis, mesh,
                          ("rep", ref_arr.ndim))
    padded, b = _pad_to(jnp.asarray(values), mesh.shape[axis])
    return call(padded, ref_arr)[:b]


def sharded_unfor_pack(mesh, packed, reference, width, dtype, axis="blocks",
                       planes=False):
    ref_arr = _ref_array(reference, dtype)
    call = _build_sharded("unfor_pack", width, dtype, axis, mesh,
                          ("rep", ref_arr.ndim), planes=planes)
    padded, b = _pad_to(jnp.asarray(packed), mesh.shape[axis])
    return _slice_out(call(padded, ref_arr), b, planes)


def global_max_bits(mesh, values, dtype, axis="blocks"):
    """Agree on one packing width across the whole mesh: per-device max, then
    pmax over the block axis.
    Returns a replicated scalar uint32 of the max value's bit count."""
    dtype = layout.canon_dtype(dtype)

    def local(v):
        vec = eng.to_vec(v, dtype)
        if eng.is_limb(dtype):
            lo, hi = vec
            g_hi = jax.lax.pmax(jnp.max(hi), axis)
            # lo-max restricted to elements at the *global* hi-max
            l_lo = jnp.max(jnp.where(hi == g_hi, lo, jnp.uint32(0)))
            g_lo = jax.lax.pmax(l_lo, axis)
            return jnp.where(g_hi > 0, _bit_len_u32(g_hi) + jnp.uint32(32),
                             _bit_len_u32(g_lo))
        m = jax.lax.pmax(jnp.max(vec), axis)
        return _bit_len_u32(m.astype(jnp.uint32))

    spec = _block_spec(dtype, axis)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=P()))
    padded, _ = _pad_to(jnp.asarray(values), mesh.shape[axis])
    return fn(padded)


def _bit_len_u32(x):
    """bit_length of a uint32 scalar array (0 -> 0)."""
    x = x.astype(jnp.uint32)
    return (jnp.uint32(32) - jax.lax.clz(x)).astype(jnp.uint32) * (x > 0).astype(jnp.uint32)


def all_gather_packed(mesh, packed_sharded, dtype, axis="blocks"):
    """Gather per-device packed shards into a replicated array, preserving
    vector (block) order — the 'all-gather packed outputs' collective of the
    north star. Input must be block-sharded; output is fully replicated."""
    spec = _block_spec(dtype, axis)

    def gather(p):
        return jax.lax.all_gather(p, axis, axis=0, tiled=True)

    out_spec = P(*([None] * len(spec)))
    # all_gather makes the value replicated, but shard_map cannot infer that
    # statically -> disable the replication check for this one collective.
    return jax.jit(jax.shard_map(gather, mesh=mesh, in_specs=(spec,), out_specs=out_spec,
                                 check_vma=False))(jnp.asarray(packed_sharded))


def sharded_roundtrip_check(mesh, values, width, dtype, axis="blocks"):
    """pack -> unpack per shard, psum the mismatch count over the mesh.
    Returns a replicated scalar int32 (0 == bit-exact everywhere). The
    framework's distributed self-validation step."""
    pack_fn = _codec_fn("pack")
    unpack_fn = _codec_fn("unpack")

    def local(v):
        p = pack_fn(v, width, dtype)
        u = unpack_fn(p, width, dtype)
        bad = jnp.sum((u != v).astype(jnp.int32))  # elementwise incl. limb axis
        return jax.lax.psum(bad, axis)

    spec = _block_spec(dtype, axis)
    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(spec,), out_specs=P()))
    padded, _ = _pad_to(jnp.asarray(values), mesh.shape[axis])
    return fn(padded)


_ORIG = ("unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig")
_DECODES = ("unpack", "undelta_pack", "unzdelta_pack", "unfor_pack") + _ORIG


def _codec_fn(name, planes=False):
    """The per-shard codec: the public entry kernels.<name>. *_orig names
    decode straight to ORIGINAL order, in the formulation kernels.routing
    picks. planes=True: decodes return (lo, hi) uint32 planes (u64 fast
    path)."""
    from .. import kernels

    if planes and name not in _DECODES:
        raise ValueError(f"planes output is decode-only, not {name!r}")
    fn = getattr(kernels, name)
    return functools.partial(fn, planes=True) if planes else fn


def _ref_array(reference, dtype):
    import numpy as np

    if eng.is_limb(dtype):
        if isinstance(reference, int):
            return jnp.array([reference & 0xFFFFFFFF, (reference >> 32) & 0xFFFFFFFF],
                             jnp.uint32)
        return jnp.asarray(reference)
    return jnp.asarray(np.asarray(reference, layout.np_dtype(dtype)))
