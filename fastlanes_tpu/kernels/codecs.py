"""Public codec entry points.

The transposed-order codecs are the XLA ops compositions themselves
(ops/*), imported here unchanged. The original-order decodes and their
encode dual below have several correct formulations each; the one measured
fastest on the running device kind is taken (kernels.routing), and the
documented default where nothing was measured. The entries accept what the
ops layer accepts: batched or unbatched arrays, uint64 (x64 on) or (..., 2)
uint32 limb images for u64; `planes=True` (u64 decode only) returns
separate (lo, hi) uint32 planes, the fast device form.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core import layout
from ..ops import _engine as eng
from ..ops import delta as ops_delta
from ..ops.bitpack import pack, unpack
from ..ops.delta import delta_pack, undelta_pack, unzdelta_pack
from ..ops.ffor import for_pack, unfor_pack
from . import routing

# -- original-order decode. FLT delta/zdelta/rle chunks store transposed
#    blocks; these entries return ORIGINAL order directly. Strategies,
#    measured per (op, dtype, width): 'od' / 'gat' / 'rep' are the
#    output-domain formulations of ops/orig.py (no transposed image is
#    materialized); 'compose' is the transposed decode + the standalone
#    untranspose, traced together. u64 composes in the (lo, hi) plane
#    domain.

_ORIG_STRATEGIES = ("od", "gat", "rep", "compose")


def _route_orig(op, width, dtype, strategy):
    if strategy is not None:
        if strategy not in _ORIG_STRATEGIES:
            raise ValueError(
                f"strategy must be one of {_ORIG_STRATEGIES}, got {strategy!r}")
        return strategy
    return routing.best_path(op, layout.canon_dtype(dtype), width)


def _orig_entry(op, decode_fn, od_fn, packed, width, dtype, strategy,
                planes):
    """Shared driver of the *_orig entries. decode_fn is the transposed
    decode, od_fn(f) the output-domain formulation f."""
    from ..ops import transpose as transpose_mod

    dtype = layout.canon_dtype(dtype)
    strat = _route_orig(op, width, dtype, strategy)
    limb = eng.is_limb(dtype)
    if not limb and planes:
        raise ValueError("planes=True is the u64 limb-plane API")
    if strat == "compose":
        out = transpose_mod.untranspose(decode_fn(), dtype, planes=limb)
    else:
        out = od_fn(strat)
    if limb and not planes:
        return eng.from_vec(out, dtype, like=packed)
    return out


def unpack_orig(packed, width, dtype, *, strategy=None, planes=False):
    """unpack straight to original order (macros.rs:101-174 composed with
    transpose.rs:18-22 in one pass)."""
    from ..ops import orig as ops_orig

    return _orig_entry(
        "unpack_orig",
        lambda: unpack(packed, width, dtype, planes=eng.is_limb(dtype)),
        lambda f: ops_orig.unpack_orig(packed, width, dtype, formulation=f),
        packed, width, dtype, strategy, planes)


def undelta_pack_orig(packed, base, width, dtype, *, strategy=None,
                      planes=False):
    """Fused delta decode straight to original order (delta.rs:48-63
    composed with transpose.rs:18-22) — the sorted-column file-read path."""
    from ..ops import orig as ops_orig

    return _orig_entry(
        "undelta_pack_orig",
        lambda: undelta_pack(packed, base, width, dtype,
                             planes=eng.is_limb(dtype)),
        lambda f: ops_orig.undelta_pack_orig(packed, base, width, dtype,
                                             formulation=f),
        packed, width, dtype, strategy, planes)


def unzdelta_pack_orig(packed, base, width, dtype, *, strategy=None,
                       planes=False):
    """Fused zdelta decode straight to original order."""
    from ..ops import orig as ops_orig

    return _orig_entry(
        "unzdelta_pack_orig",
        lambda: unzdelta_pack(packed, base, width, dtype,
                              planes=eng.is_limb(dtype)),
        lambda f: ops_orig.unzdelta_pack_orig(packed, base, width, dtype,
                                              formulation=f),
        packed, width, dtype, strategy, planes)


def delta_pack_orig(values, width, dtype, *, zigzag=False, strategy=None):
    """ENCODE dual: ORIGINAL-order values -> (packed, base) for the
    delta/zdelta wire format. 'od' (default) traces transpose + delta
    (+ zigzag) + pack in one pass with no transposed image; 'compose'
    materializes the transpose first."""
    dtype = layout.canon_dtype(dtype)
    op = "zdelta_pack_orig_enc" if zigzag else "delta_pack_orig_enc"
    if _route_orig(op, width, dtype, strategy) == "od":
        from ..ops import orig as ops_orig

        return ops_orig.delta_pack_orig(values, width, dtype, zigzag=zigzag)
    from .. import transforms as _tr
    from ..ops import transpose as transpose_mod

    nl = layout.lanes(dtype)
    tr = jnp.asarray(transpose_mod.transpose(values, dtype))
    # slice the POSITION axis: axis 0 when unbatched (or an unbatched u64
    # limb image, whose trailing axis is the limb pair)
    pos_axis0 = tr.ndim == 1 or (eng.is_limb(dtype) and tr.ndim == 2
                                 and tr.dtype == jnp.uint32)
    base = tr[:nl] if pos_axis0 else tr[:, :nl]
    if not zigzag:
        return delta_pack(tr, base, width, dtype), base
    arr = jnp.asarray(ops_delta.delta(tr, base, dtype))
    if eng.is_limb(dtype) and arr.dtype == jnp.uint32:
        zz = jnp.stack(_tr.zigzag_encode_limb(arr[..., 0], arr[..., 1]), -1)
    else:
        t = layout.bit_width(dtype)
        zz = _tr.zigzag_encode(
            jax.lax.bitcast_convert_type(arr, jnp.dtype(f"int{t}")))
    return pack(zz, width, dtype), base


def warmup(ops=("pack", "unpack"), dtypes=layout.DTYPES, widths=None,
           n_blocks=1024):
    """Compile the ROUTED public entry for each (op, dtype, width) ahead of
    first use — the serving cold-start mitigation (jit caches are
    shape-keyed, so pass your production n_blocks). Fused ops take
    zero/dummy parameters. Returns the number of entries compiled."""
    import numpy as np

    count = 0
    for dt in dtypes:
        dt = layout.canon_dtype(dt)
        t = layout.bit_width(dt)
        nl = layout.lanes(dt)
        limb = eng.is_limb(dt)
        ws = widths if widths is not None else range(1, t + 1)
        for w in ws:
            layout.check_width(dt, w)
            plen = layout.packed_len(dt, w)
            vshape = (n_blocks, layout.BLOCK, 2) if limb else (n_blocks, layout.BLOCK)
            pshape = (n_blocks, plen, 2) if limb else (n_blocks, plen)
            vals = jnp.zeros(vshape, jnp.uint32 if limb else eng.jnp_dtype(dt))
            pkd = jnp.zeros(pshape, jnp.uint32 if limb else eng.jnp_dtype(dt))
            base = (np.zeros((nl, 2), np.uint32) if limb
                    else np.zeros(nl, layout.np_dtype(dt)))
            calls = {
                "pack": lambda: pack(vals, w, dt),
                "unpack": lambda: unpack(pkd, w, dt),
                "undelta_pack": lambda: undelta_pack(pkd, base, w, dt),
                "unzdelta_pack": lambda: unzdelta_pack(pkd, base, w, dt),
                "for_pack": lambda: for_pack(vals, 0, w, dt),
                "unfor_pack": lambda: unfor_pack(pkd, 0, w, dt),
                "unpack_orig": lambda: unpack_orig(pkd, w, dt),
                "undelta_pack_orig": lambda: undelta_pack_orig(pkd, base, w, dt),
                "unzdelta_pack_orig":
                    lambda: unzdelta_pack_orig(pkd, base, w, dt),
                "delta_pack_orig": lambda: delta_pack_orig(vals, w, dt)[0],
            }
            for op in ops:
                if op not in calls:
                    raise ValueError(f"unknown op {op!r}")
                jax.block_until_ready(calls[op]())
                count += 1
    return count
