"""Distribution tests on the virtual 8-device CPU mesh: data-parallel codec
execution, replicated params, pmax width agreement, all-gather in vector
order, psum'd round-trip validation."""

import jax
import numpy as np
import pytest

from fastlanes_tpu import parallel
from fastlanes_tpu.core import layout
from fastlanes_tpu.ref import numpy_ref as ref

from conftest import random_values
from test_ops_vs_ref import from_jax_form, to_jax_form


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return parallel.make_mesh()


def test_mesh_shape(mesh):
    assert mesh.shape["blocks"] == 8


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_sharded_pack_unpack(mesh, dt, rng):
    w = max(1, layout.bit_width(dt) // 2 - 1)
    values = random_values(rng, dt, w, n_blocks=32)
    gold = ref.pack(values, w, dt)

    packed = parallel.sharded_pack(mesh, to_jax_form(values, dt), w, dt)
    np.testing.assert_array_equal(from_jax_form(packed, dt), gold)

    out = parallel.sharded_unpack(mesh, to_jax_form(gold, dt), w, dt)
    np.testing.assert_array_equal(from_jax_form(out, dt), values)


def test_sharded_uneven_blocks(mesh, rng):
    """Block counts not divisible by the mesh get padded and un-padded."""
    values = random_values(rng, "u32", 9, n_blocks=13)
    packed = parallel.sharded_pack(mesh, values, 9, "u32")
    np.testing.assert_array_equal(np.asarray(packed), ref.pack(values, 9, "u32"))


def test_sharded_fused_delta(mesh, rng):
    values = np.sort(random_values(rng, "u16", 15, n_blocks=16), axis=1)
    base = np.zeros(64, np.uint16)
    transposed = ref.transpose(values, "u16")
    deltas = ref.delta(transposed, np.broadcast_to(base, (16, 64)), "u16")
    packed = ref.pack(deltas, 15, "u16")

    out = parallel.sharded_undelta_pack(mesh, packed, base, 15, "u16")
    np.testing.assert_array_equal(np.asarray(out), transposed)


def test_sharded_ffor(mesh, rng):
    w, reference = 8, 1000
    values = random_values(rng, "u32", 7, n_blocks=16) + np.uint32(reference)
    packed = parallel.sharded_for_pack(mesh, values, reference, w, "u32")
    np.testing.assert_array_equal(np.asarray(packed),
                                  ref.for_pack(values, reference, w, "u32"))
    out = parallel.sharded_unfor_pack(mesh, packed, reference, w, "u32")
    np.testing.assert_array_equal(np.asarray(out), values)


@pytest.mark.parametrize("dt", ["u32", "u64"])
def test_global_max_bits(mesh, dt, rng):
    values = random_values(rng, dt, 5, n_blocks=8)
    # plant a single large value on what will land on the last device
    big = (1 << 22) + 5
    values[-1, -1] = layout.np_dtype(dt).type(big)
    got = int(parallel.global_max_bits(mesh, to_jax_form(values, dt), dt))
    assert got == big.bit_length() == 23


def test_global_max_bits_u64_high_limb(mesh, rng):
    values = random_values(rng, "u64", 10, n_blocks=8)
    values[3, 100] = np.uint64((1 << 45) + 17)
    got = int(parallel.global_max_bits(mesh, to_jax_form(values, "u64"), "u64"))
    assert got == 46


def test_all_gather_packed(mesh, rng):
    values = random_values(rng, "u32", 9, n_blocks=16)
    gold = ref.pack(values, 9, "u32")
    packed = parallel.sharded_pack(mesh, values, 9, "u32")
    gathered = parallel.all_gather_packed(mesh, packed, "u32")
    np.testing.assert_array_equal(np.asarray(gathered), gold)


def test_sharded_roundtrip_check(mesh, rng):
    values = random_values(rng, "u32", 13, n_blocks=24)
    bad = int(parallel.sharded_roundtrip_check(mesh, values, 13, "u32"))
    assert bad == 0


# ---------------------------------------------------------------------------
# the public kernels.* entries under shard_map on the CPU mesh: uneven block
# counts, original-order decodes (routed per device; the documented default
# formulation when no table exists), u64 planes and per-block bases.


@pytest.fixture(autouse=True, scope="module")
def _fresh_compiler_state():
    """Drop the in-process jit/executable caches before this module, so
    its shard_map programs compile against a fresh compiler state."""
    jax.clear_caches()
    from fastlanes_tpu.parallel import shard

    shard._build_sharded.cache_clear()
    yield


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_sharded_kernel_pack_unpack(mesh, dt, rng):
    """13 blocks over 8 devices: pack, and unpack straight to original
    order, both padded and trimmed."""
    w = max(1, layout.bit_width(dt) // 2 - 1)
    values = random_values(rng, dt, w, n_blocks=13)
    packed = parallel.sharded_pack(mesh, to_jax_form(values, dt), w, dt)
    np.testing.assert_array_equal(from_jax_form(packed, dt),
                                  ref.pack(values, w, dt))
    tr_packed = ref.pack(ref.transpose(values, dt), w, dt)
    out = parallel.sharded_unpack(mesh, to_jax_form(tr_packed, dt), w, dt,
                                  orig=True)
    np.testing.assert_array_equal(from_jax_form(out, dt), values)


@pytest.mark.parametrize("dt", ["u16", "u64"])
def test_sharded_kernel_fused_delta(mesh, dt, rng):
    """Fused delta decode under shard_map: shared (replicated) base AND
    per-block (block-sharded) base."""
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    w = t - 1
    values = np.sort(random_values(rng, dt, w, n_blocks=16), axis=1)
    transposed = ref.transpose(values, dt)
    # per-block row-0 base (the fio/file layout)
    base_b = np.ascontiguousarray(transposed[:, :nl])
    deltas = ref.delta(transposed, base_b, dt)
    packed = ref.pack(deltas, w, dt)
    out = parallel.sharded_undelta_pack(
        mesh, to_jax_form(packed, dt), to_jax_form(base_b, dt), w, dt)
    np.testing.assert_array_equal(from_jax_form(out, dt), transposed)

    # shared zero base, replicated over the mesh
    base_s = np.zeros(nl, layout.np_dtype(dt))
    deltas = ref.delta(transposed, np.broadcast_to(base_s, (16, nl)), dt)
    packed = ref.pack(deltas, w, dt)
    out = parallel.sharded_undelta_pack(
        mesh, to_jax_form(packed, dt), to_jax_form(base_s, dt), w, dt)
    np.testing.assert_array_equal(from_jax_form(out, dt), transposed)


def test_sharded_kernel_ffor(mesh, rng):
    """u64 FFoR over the mesh: limb-image encode, (lo, hi) plane decode."""
    w, reference = 20, (1 << 40) + 3
    values = random_values(rng, "u64", 19, n_blocks=12) + np.uint64(reference)
    packed = parallel.sharded_for_pack(mesh, to_jax_form(values, "u64"),
                                       reference, w, "u64")
    np.testing.assert_array_equal(from_jax_form(packed, "u64"),
                                  ref.for_pack(values, reference, w, "u64"))
    lo, hi = parallel.sharded_unfor_pack(mesh, packed, reference, w, "u64",
                                         planes=True)
    img = np.asarray(to_jax_form(values, "u64"))
    np.testing.assert_array_equal(np.asarray(lo), img[..., 0])
    np.testing.assert_array_equal(np.asarray(hi), img[..., 1])


@pytest.mark.parametrize("orig", [False, True])
def test_sharded_unzdelta_pack(mesh, rng, orig):
    """Sharded fused zdelta decode, transposed and original order."""
    from fastlanes_tpu import fio

    dt, nl = "u32", 32
    steps = rng.integers(-3, 20, (16, 1024), np.int64)
    values = (np.cumsum(steps, axis=1) + 50_000).astype(np.uint32)
    transposed = ref.transpose(values, dt)
    base = np.ascontiguousarray(transposed[:, :nl])
    zz = fio._zigzag_deltas(ref.delta(transposed, base, dt))
    w = int(zz.max()).bit_length()
    packed = ref.pack(zz, w, dt)
    out = parallel.sharded_unzdelta_pack(mesh, packed, base, w, dt, orig=orig)
    np.testing.assert_array_equal(np.asarray(out),
                                  values if orig else transposed)


def test_sharded_kernel_roundtrip_check(mesh, rng):
    """psum'd round trip over u64 limb images, 11 blocks (padded)."""
    values = random_values(rng, "u64", 37, n_blocks=11)
    bad = int(parallel.sharded_roundtrip_check(
        mesh, to_jax_form(values, "u64"), 37, "u64"))
    assert bad == 0


def test_full_distributed_pipeline(mesh, rng):
    """The end-to-end distributed flow of the north star: agree on width via
    pmax -> FFoR-encode data-parallel -> all-gather packed in vector order ->
    decode -> bit-exact."""
    reference = 5000
    values = random_values(rng, "u32", 11, n_blocks=32) + np.uint32(reference)
    width = int(parallel.global_max_bits(mesh, values - np.uint32(reference), "u32"))
    packed = parallel.sharded_for_pack(mesh, values, reference, width, "u32")
    gathered = parallel.all_gather_packed(mesh, packed, "u32")
    out = parallel.sharded_unfor_pack(mesh, gathered, reference, width, "u32")
    np.testing.assert_array_equal(np.asarray(out), values)
