"""pack_map: the fused-encode public entry (producer applied per row-slice
read so XLA fuses it into the packed-word production)."""

import jax.numpy as jnp
import numpy as np
import pytest

import fastlanes_tpu as fl
import fastlanes_tpu.kernels as kernels
from fastlanes_tpu.core import layout
from fastlanes_tpu.ops import bitpack, ffor
from fastlanes_tpu.ref import numpy_ref as ref

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("dt", ["u8", "u16", "u32"])
def test_identity_producer_equals_pack(dt):
    t = layout.bit_width(dt)
    np_dt = layout.np_dtype(dt)
    for w in (0, 1, 3, t):
        vals = RNG.integers(0, 1 << max(w, 1), (4, 1024),
                            dtype=np.uint64).astype(np_dt)
        got = np.asarray(bitpack.pack_map(lambda v: v, vals, w, dt))
        assert np.array_equal(got, ref.pack(vals, w, dt)), f"{dt} w={w}"


def test_elementwise_producer_fuses_correctly():
    vals = RNG.integers(0, 1 << 31, (6, 1024), np.int64).astype(np.uint32)
    c = np.uint32(0x5A5A5A5A)
    got = np.asarray(bitpack.pack_map(lambda v: v ^ c, vals, 7, "u32"))
    assert np.array_equal(got, ref.pack((vals ^ c) & 0x7F, 7, "u32"))


def test_subtract_producer_matches_for_pack():
    vals = (RNG.integers(0, 1 << 10, (5, 1024), np.int64) + 50_000
            ).astype(np.uint32)
    refv = int(vals.min())
    w = int((vals - refv).max()).bit_length()
    got = np.asarray(bitpack.pack_map(
        lambda v: v - jnp.uint32(refv), vals, w, "u32"))
    want = np.asarray(ffor.for_pack(vals, refv, w, "u32"))
    assert np.array_equal(got, want)


def test_u64_plane_producer():
    vals = RNG.integers(0, 1 << 40, (3, 1024), dtype=np.uint64)
    img = vals.view(np.uint32).reshape(3, 1024, 2)
    got = np.asarray(bitpack.pack_map(
        lambda lohi: (lohi[0] ^ jnp.uint32(3), lohi[1]), img, 41, "u64"))
    want = np.ascontiguousarray(ref.pack(vals ^ np.uint64(3), 41, "u64")
                                ).view(np.uint32).reshape(3, -1, 2)
    assert np.array_equal(got, want)


def test_unbatched_and_public_reexports():
    vals = RNG.integers(0, 8, 1024, dtype=np.int64).astype(np.uint32)
    got = np.asarray(fl.pack_map(lambda v: v, vals, 3, "u32"))
    assert np.array_equal(got, ref.pack(vals[None], 3, "u32")[0])
    got = np.asarray(kernels.pack_map(lambda v: v + jnp.uint32(1), vals, 3, "u32"))
    assert np.array_equal(got, ref.pack((vals[None] + 1) & 7, 3, "u32")[0])


@pytest.mark.parametrize("dt", ["u8", "u16", "u32", "u64"])
@pytest.mark.parametrize("strategy", ["assemble", "gather", "grouptake",
                                      "bitrev"])
def test_wt_strategies_bit_exact(dt, strategy):
    """Every W=T relayout strategy decodes
    bit-exactly; the routed default stays 'assemble' until measured."""
    from fastlanes_tpu.kernels import routing
    from fastlanes_tpu.ops import _engine as eng

    t = layout.bit_width(dt)
    vals = RNG.integers(0, 1 << min(t, 63), (4, 1024),
                        dtype=np.uint64).astype(layout.np_dtype(dt))
    if dt == "u64":
        vals |= np.uint64(1) << np.uint64(63)
    packed = ref.pack(vals, t, dt)
    arg = (np.ascontiguousarray(packed).view(np.uint32).reshape(4, 1024, 2)
           if dt == "u64" else packed)
    try:
        routing.set_table({f"unpack_wt:{dt}:{t}": {strategy: 1.0},
                           f"pack_wt:{dt}:{t}": {strategy: 1.0}})
        bitpack._wt_strategy.cache_clear()
        bitpack._pack_wt_strategy.cache_clear()
        got = np.asarray(bitpack.unpack(arg, t, dt))
        want = (np.ascontiguousarray(vals).view(np.uint32).reshape(4, 1024, 2)
                if dt == "u64" else vals)
        assert np.array_equal(got, want), f"{dt} {strategy}"
        # pack dual: strategy-packed bytes identical to the oracle's
        varg = (np.ascontiguousarray(vals).view(np.uint32).reshape(4, 1024, 2)
                if dt == "u64" else vals)
        gp = np.asarray(bitpack.pack(varg, t, dt))
        wantp = (np.ascontiguousarray(packed).view(np.uint32)
                 .reshape(4, 1024, 2) if dt == "u64" else packed)
        assert np.array_equal(gp, wantp), f"pack {dt} {strategy}"
    finally:
        routing.set_table(None)
        bitpack._wt_strategy.cache_clear()
        bitpack._pack_wt_strategy.cache_clear()


@pytest.mark.parametrize("kind", ["transpose", "untranspose"])
@pytest.mark.parametrize("strategy", ["permute", "gather"])
def test_standalone_relayout_strategies(kind, strategy):
    from fastlanes_tpu.kernels import routing
    from fastlanes_tpu.ops import transpose as tr_mod

    vals = RNG.integers(0, 1 << 31, (3, 1024), np.int64).astype(np.uint32)
    want = (ref.transpose(vals, "u32") if kind == "transpose"
            else ref.untranspose(vals, "u32"))
    try:
        routing.set_table({f"{kind}_st:u32:0": {strategy: 1.0}})
        tr_mod._st_strategy.cache_clear()
        fn = tr_mod.transpose if kind == "transpose" else tr_mod.untranspose
        got = np.asarray(fn(vals, "u32"))
        assert np.array_equal(got, want), f"{kind} {strategy}"
    finally:
        routing.set_table(None)
        tr_mod._st_strategy.cache_clear()
