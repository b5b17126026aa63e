"""jnp Transpose codec (reference src/transpose.rs:11-22, 29-36).

Instead of the reference's fully-unrolled 1024-element gather, the 04261537
interleave is expressed as reshape + small-axis permutation + axis
transpose, which XLA lowers without a gather:

  transpose:    out[(r,g,l)] = in[(l, FL_ORDER[g], r)]   with in as (16,8,8)
  untranspose:  inverse (FL_ORDER is self-inverse)

where out is viewed as (row:8, order:8, lane:16) and in as (lane:16, o:8, row:8).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core import layout
from . import _engine as eng

_FL = list(layout.FL_ORDER)


def _transpose_one(arr2d):
    b = arr2d.shape[0]
    x = arr2d.reshape(b, 16, 8, 8)          # (B, lane, order-source, row)
    x = x[:, :, _FL, :]                     # apply FL_ORDER on the middle axis
    x = jnp.transpose(x, (0, 3, 2, 1))      # -> (B, row, order, lane)
    return x.reshape(b, 1024)


def _untranspose_one(arr2d):
    b = arr2d.shape[0]
    x = arr2d.reshape(b, 8, 8, 16)          # (B, row, order, lane)
    x = jnp.transpose(x, (0, 3, 2, 1))      # -> (B, lane, order, row)
    x = x[:, :, _FL, :]                     # FL_ORDER self-inverse
    return x.reshape(b, 1024)


# -- standalone relayout strategies (routing keys transpose_st /
#    untranspose_st): the reshape/permute composite, one static
#    1024-gather, or a pure axis reversal. The default original-order
#    decodes fuse the untranspose (ops/orig.py) and the encode dual the
#    transpose (delta_pack_orig); these entries serve the composed
#    strategies and the parity API.


import functools


def _gather_one(perm):
    idx = jnp.asarray(perm)

    def fn(arr2d):
        return arr2d[:, idx]

    return fn


def _transpose_axes_one(arr2d):
    """The 04261537 interleave as ONE pure axis reversal — no gather, no
    take: with i = a*128 + b*16 + g (a,b<8, g<16), transpose_index maps
    (a, b, g) -> (g, bitrev3(b), a), and FL_ORDER's bit-reversal of the
    middle 3 bits IS the reversal of three split 2-axes. So
    out = in.reshape(16,2,2,2,8) with axes fully reversed."""
    b = arr2d.shape[0]
    x = arr2d.reshape(b, 16, 2, 2, 2, 8)
    return jnp.transpose(x, (0, 5, 4, 3, 2, 1)).reshape(b, 1024)


def _untranspose_axes_one(arr2d):
    b = arr2d.shape[0]
    x = arr2d.reshape(b, 8, 2, 2, 2, 16)
    return jnp.transpose(x, (0, 5, 4, 3, 2, 1)).reshape(b, 1024)


@functools.lru_cache(maxsize=None)
def _st_strategy(op: str) -> str:
    from ..kernels import routing

    strat = routing.best_path(op, "u32", 0)  # dtype-independent permutation
    return strat if strat in ("permute", "gather", "axes") else "permute"


@functools.lru_cache(maxsize=None)
def _one_fn(kind: str, strategy: str):
    if strategy == "gather":
        return _gather_one(layout.transpose_perm() if kind == "transpose"
                           else layout.untranspose_perm())
    if strategy == "axes":
        return (_transpose_axes_one if kind == "transpose"
                else _untranspose_axes_one)
    return _transpose_one if kind == "transpose" else _untranspose_one


def _apply(kind, values, dtype, planes=False):
    from .bitpack import _check_planes

    dtype = layout.canon_dtype(dtype)
    _check_planes(planes, dtype)
    fn = _one_fn(kind, _st_strategy(f"{kind}_st"))
    vec = eng.to_vec(values, dtype)
    vec, had_batch = eng.promote_shape(vec, dtype)
    if eng.is_limb(dtype):
        out = (fn(vec[0]), fn(vec[1]))
    else:
        out = fn(vec)
    out = eng.squeeze_shape(out, had_batch, dtype)
    if planes:
        return out
    return eng.from_vec(out, dtype, like=values)


def transpose(values, dtype, *, planes: bool = False):
    """Transpose::transpose: out[i] = in[transpose_index(i)] (transpose.rs:11-15).
    planes=True (u64 only): (lo, hi) uint32 planes in/out."""
    return _apply("transpose", values, dtype, planes)


def untranspose(values, dtype, *, planes: bool = False):
    """Transpose::untranspose: out[transpose_index(i)] = in[i] (transpose.rs:18-22).
    planes=True (u64 only): (lo, hi) uint32 planes in/out."""
    return _apply("untranspose", values, dtype, planes)
