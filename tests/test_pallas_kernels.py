"""Public codec entries (kernels.*) vs the NumPy oracle, padding and shapes
included. The transposed-order entries are the XLA ops codecs; tests marked
`gpu` run the entries as XLA compiles them for the card."""

import numpy as np
import pytest

from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import codecs as pk
from fastlanes_tpu.ref import numpy_ref as ref

from conftest import random_values, width_sample
from test_ops_vs_ref import from_jax_form, to_jax_form


@pytest.mark.parametrize("dt,w", width_sample())
def test_kernel_pack_unpack(dt, w, rng):
    values = random_values(rng, dt, w, n_blocks=24)
    gold = ref.pack(values, w, dt)

    got = from_jax_form(pk.pack(to_jax_form(values, dt), w, dt), dt)
    np.testing.assert_array_equal(got, gold)

    out = from_jax_form(pk.unpack(to_jax_form(gold, dt), w, dt), dt)
    np.testing.assert_array_equal(out, values)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_kernel_fused_delta(dt, rng):
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    w = t // 2 + 1
    values = np.sort(random_values(rng, dt, w - 1, n_blocks=8), axis=1)
    base = np.zeros(nl, layout.np_dtype(dt))
    transposed = ref.transpose(values, dt)
    deltas = ref.delta(transposed, np.broadcast_to(base, (8, nl)), dt)
    gold_packed = ref.pack(deltas, w, dt)

    got_packed = from_jax_form(
        pk.delta_pack(to_jax_form(transposed, dt), to_jax_form(base, dt), w, dt), dt)
    np.testing.assert_array_equal(got_packed, gold_packed)

    got_dec = from_jax_form(
        pk.undelta_pack(to_jax_form(gold_packed, dt), to_jax_form(base, dt), w, dt), dt)
    np.testing.assert_array_equal(got_dec, transposed)


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_kernel_fused_ffor(dt, rng):
    t = layout.bit_width(dt)
    w = max(2, t // 3)
    reference = (1 << (w - 1)) + 3
    values = (random_values(rng, dt, w - 1, n_blocks=8)
              + layout.np_dtype(dt).type(reference))
    gold_packed = ref.for_pack(values, reference, w, dt)

    got_packed = from_jax_form(
        pk.for_pack(to_jax_form(values, dt), reference, w, dt), dt)
    np.testing.assert_array_equal(got_packed, gold_packed)

    got_dec = from_jax_form(
        pk.unfor_pack(to_jax_form(gold_packed, dt), reference, w, dt), dt)
    np.testing.assert_array_equal(got_dec, values)


def test_kernel_fallback_without_table(rng):
    """The public pack is the XLA ops codec, with no routing in between."""
    from fastlanes_tpu.ops import bitpack

    assert pk.pack is bitpack.pack
    values = random_values(rng, "u32", 7, n_blocks=4)
    got = np.asarray(pk.pack(values, 7, "u32"))
    np.testing.assert_array_equal(got, ref.pack(values, 7, "u32"))


def test_kernel_width_zero(rng):
    values = random_values(rng, "u16", 0, n_blocks=4)
    got = pk.pack(values, 0, "u16")
    assert got.shape == (4, 0)
    out = np.asarray(pk.unpack(np.zeros((4, 0), np.uint16), 0, "u16"))
    np.testing.assert_array_equal(out, np.zeros((4, 1024), np.uint16))


@pytest.mark.gpu
@pytest.mark.parametrize("dt,w", [("u8", 3), ("u16", 9), ("u32", 11),
                                  ("u64", 41)])
def test_fused_decodes_compiled_on_gpu(dt, w, rng):
    """The fused delta entries as XLA compiles them for the card, against
    the oracle."""
    n_blocks, nl = 1029, layout.lanes(dt)
    values = np.sort(random_values(rng, dt, w - 1, n_blocks=n_blocks), axis=1)
    transposed = ref.transpose(values, dt)
    base = np.ascontiguousarray(transposed[:, :nl])
    packed = ref.pack(ref.delta(transposed, base, dt), w, dt)
    got = pk.undelta_pack_orig(to_jax_form(packed, dt), to_jax_form(base, dt),
                               w, dt)
    np.testing.assert_array_equal(from_jax_form(got, dt), values)
