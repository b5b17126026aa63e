"""Seeded differential fuzzing: random (dtype, width, data shape, pipeline)
configs must agree bit-for-bit across the NumPy oracle, the XLA ops layer,
the C++ host codec and the routed public entries.

The fixed sweeps cover the (dtype, width) grid; this covers the *seams*:
odd batch sizes (kernel grid padding), extreme values (all-zeros, all-max),
random per-block bases, and composed pipelines.
"""

import numpy as np
import pytest

from fastlanes_tpu import native
from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import codecs as pk
from fastlanes_tpu.ops import bitpack, delta as delta_ops, ffor as ffor_ops
from fastlanes_tpu.ref import numpy_ref as ref
from fastlanes_tpu.utils.testing import from_jax_form, to_jax_form

N_CASES = 60
_HAVE_NATIVE = native.available()


def _gen_case(rng):
    dt = rng.choice(layout.DTYPES)
    t = layout.bit_width(dt)
    w = int(rng.integers(1, t + 1))
    b = int(rng.choice([1, 2, 3, 5, 7, 16]))
    kind = rng.choice(["random", "zeros", "max", "sorted"])
    if kind == "zeros":
        vals = np.zeros((b, 1024), layout.np_dtype(dt))
    elif kind == "max":
        vals = np.full((b, 1024), (1 << w) - 1, dtype=np.uint64).astype(
            layout.np_dtype(dt))
    else:
        vals = rng.integers(0, 1 << min(w, 63), (b, 1024), np.uint64).astype(
            layout.np_dtype(dt))
        if kind == "sorted":
            vals = np.sort(vals, axis=1)
    return dt, w, vals


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_pack_roundtrip_all_impls(seed):
    rng = np.random.default_rng(0xF022 + seed)
    dt, w, vals = _gen_case(rng)
    gold = ref.pack(vals, w, dt)
    np.testing.assert_array_equal(ref.unpack(gold, w, dt), vals)

    ops_packed = from_jax_form(bitpack.pack(to_jax_form(vals, dt), w, dt), dt)
    np.testing.assert_array_equal(ops_packed, gold)
    np.testing.assert_array_equal(
        from_jax_form(bitpack.unpack(to_jax_form(gold, dt), w, dt), dt), vals)

    if _HAVE_NATIVE:
        np.testing.assert_array_equal(native.pack(vals, w, dt), gold)
        np.testing.assert_array_equal(native.unpack(gold, w, dt), vals)

    # unpack_single at random indices
    idx = rng.integers(0, 1024, 8)
    np.testing.assert_array_equal(
        ref.unpack_single(gold, w, idx, dt), vals[:, idx])


@pytest.mark.parametrize("seed", range(N_CASES))
def test_fuzz_delta_ffor_pipelines(seed):
    rng = np.random.default_rng(0xD317 + seed)
    dt, w, vals = _gen_case(rng)
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    np_dt = layout.np_dtype(dt)

    # delta with a RANDOM per-block base (not just row-0 seeds)
    transposed = ref.transpose(vals, dt)
    base = rng.integers(0, 1 << min(t - 1, 63), (vals.shape[0], nl),
                        np.uint64).astype(np_dt)
    deltas = ref.delta(transposed, base, dt)
    wd = max(1, min(t, int(deltas.max()).bit_length()))
    dp = ref.pack(deltas, wd, dt)
    np.testing.assert_array_equal(ref.undelta_pack(dp, base, wd, dt), transposed)
    got = from_jax_form(delta_ops.undelta_pack(
        to_jax_form(dp, dt), to_jax_form(base, dt), wd, dt), dt)
    np.testing.assert_array_equal(got, transposed)
    if _HAVE_NATIVE:
        np.testing.assert_array_equal(native.undelta_pack(dp, base, wd, dt),
                                      transposed)
    np.testing.assert_array_equal(ref.untranspose(transposed, dt), vals)

    # ffor with a random reference
    refc = int(rng.integers(0, 1 << min(t - 1, 63)))
    fp = ref.for_pack(vals, refc, w, dt)
    want = ((vals.astype(np.uint64) - refc) & ((1 << w) - 1)).astype(np_dt) \
        if w < t else (vals.astype(np.uint64) - refc).astype(np_dt)
    np.testing.assert_array_equal(ref.unpack(fp, w, dt), want)
    got = from_jax_form(ffor_ops.for_pack(to_jax_form(vals, dt), refc, w, dt), dt)
    np.testing.assert_array_equal(got, fp)
    if _HAVE_NATIVE:
        np.testing.assert_array_equal(native.for_pack(vals, refc, w, dt), fp)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_pallas_interpret(seed):
    """Random configs through the public routed entries (kernels.*)."""
    rng = np.random.default_rng(0x9A11 + seed)
    dt, w, vals = _gen_case(rng)
    gold = ref.pack(vals, w, dt)
    got = from_jax_form(pk.pack(to_jax_form(vals, dt), w, dt), dt)
    np.testing.assert_array_equal(got, gold)
    out = from_jax_form(pk.unpack(to_jax_form(gold, dt), w, dt), dt)
    np.testing.assert_array_equal(out, vals)


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_zdelta_and_signed_files(seed, tmp_path):
    """Random signed/unsigned columns of random lengths round-trip through
    the FLT writer's full auto pipeline (transform choice + codec choice)."""
    from fastlanes_tpu import fio

    rng = np.random.default_rng(0x2D31 + seed)
    t = int(rng.choice([8, 16, 32, 64]))
    n = int(rng.integers(1, 6000))
    kind = rng.choice(["walk", "clustered", "sorted", "random"])
    if kind == "walk":
        col = np.cumsum(rng.integers(-5, 7, n, np.int64))
    elif kind == "clustered":
        col = rng.integers(-40, 40, n, np.int64)
    elif kind == "sorted":
        col = np.sort(rng.integers(0, 1 << min(t - 1, 40), n, np.int64))
    else:
        col = rng.integers(-(1 << min(t - 2, 30)), 1 << min(t - 2, 30), n, np.int64)
    signed = bool(rng.integers(0, 2))
    dt = np.dtype(f"{'int' if signed else 'uint'}{t}")
    col = col.astype(dt) if signed else np.abs(col).astype(dt)
    path = str(tmp_path / "f.flt")
    fio.write_file(path, col, chunk_blocks=int(rng.choice([1, 2, 1024])))
    got = fio.read_file(path)
    assert got.dtype == col.dtype
    np.testing.assert_array_equal(got, col)
    if n > 1:
        idx = int(rng.integers(0, n))
        assert fio.read_single(path, idx // 1024, idx % 1024) == col[idx]


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_float_and_runs_files(seed, tmp_path):
    """Random float columns (decimal-like, random-mantissa, special values)
    and run-heavy integer columns through the full FLT auto pipeline —
    hardening for the ALP/ALP_RD/RLE codecs."""
    from fastlanes_tpu import fio

    rng = np.random.default_rng(0xF10A7 + seed)
    n = int(rng.integers(1, 6000))
    kind = rng.choice(["decimal", "normal", "special", "runs"])
    if kind == "decimal":
        digits = int(rng.integers(0, 4))
        col = (rng.integers(-10 ** 6, 10 ** 6, n) / 10 ** digits)
        col = col.astype(rng.choice([np.float32, np.float64]))
    elif kind == "normal":
        col = (rng.standard_normal(n) * 10.0 ** rng.integers(-3, 12)).astype(
            rng.choice([np.float32, np.float64]))
    elif kind == "special":
        col = (rng.standard_normal(n) * 100).astype(np.float64)
        for v in (np.nan, np.inf, -np.inf, -0.0, 5e-324, 1.7e308):
            col[rng.integers(0, n)] = v
    else:  # runs
        t = int(rng.choice([8, 16, 32, 64]))
        reps = rng.integers(1, 120, max(1, n // 30))
        vals = rng.integers(0, 1 << min(t, 30), len(reps), np.int64)
        col = np.repeat(vals, reps)[:n].astype(np.dtype(f"uint{t}"))
        if len(col) < n:
            col = np.concatenate([col, np.full(n - len(col), col[-1] if len(col)
                                               else 0, col.dtype)])
    path = str(tmp_path / "f.flt")
    fio.write_file(path, col, chunk_blocks=int(rng.choice([1, 2, 1024])))
    got = fio.read_file(path)
    assert got.dtype == col.dtype
    if np.issubdtype(col.dtype, np.floating):
        u = np.uint32 if col.dtype == np.float32 else np.uint64
        np.testing.assert_array_equal(got.view(u), col.view(u))  # bitwise
    else:
        np.testing.assert_array_equal(got, col)
    if n > 1:
        idx = int(rng.integers(0, n))
        want = col[idx]
        val = fio.read_single(path, idx // 1024, idx % 1024)
        if np.issubdtype(col.dtype, np.floating):
            assert np.asarray(val).tobytes() == np.asarray(want).tobytes()
        else:
            assert val == want


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_fused_kernels_interpret(seed):
    """Random configs through the FUSED public entries (undelta_pack /
    unzdelta_pack / unfor_pack), vs the oracle pipeline."""
    from fastlanes_tpu import fio
    from fastlanes_tpu.kernels import codecs as pk
    from fastlanes_tpu.utils.testing import from_jax_form, to_jax_form

    rng = np.random.default_rng(0xFD5 + seed)
    dt = str(rng.choice(["u8", "u16", "u32", "u64"]))
    t = {"u8": 8, "u16": 16, "u32": 32, "u64": 64}[dt]
    nl = 1024 // t
    n_blocks = int(rng.integers(1, 5))
    w = int(rng.integers(1, t + 1))
    vals = rng.integers(0, 1 << min(w, t), (n_blocks, 1024),
                        dtype=np.uint64).astype(f"uint{t}")
    transposed = ref.transpose(vals, dt)
    base = np.ascontiguousarray(transposed[:, :nl])
    kind = rng.choice(["delta", "zdelta", "ffor"])
    if kind == "ffor":
        reference = int(vals.min())
        packed = ref.for_pack(vals, reference, w, dt)
        got = from_jax_form(pk.unfor_pack(to_jax_form(packed, dt), reference,
                                          w, dt), dt)
        want = ref.unfor_pack(packed, reference, w, dt)
    elif kind == "delta":
        deltas = ref.delta(transposed, base, dt)
        wd = max(w, int(deltas.max()).bit_length())
        packed = ref.pack(deltas, wd, dt)
        got = from_jax_form(pk.undelta_pack(
            to_jax_form(packed, dt), to_jax_form(base, dt), wd, dt), dt)
        want = transposed
    else:
        deltas = ref.delta(transposed, base, dt)
        zz = fio._zigzag_deltas(deltas)
        wz = max(1, int(zz.max()).bit_length())
        packed = ref.pack(zz, wz, dt)
        got = from_jax_form(pk.unzdelta_pack(
            to_jax_form(packed, dt), to_jax_form(base, dt), wz, dt), dt)
        want = transposed
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_orig_decode_and_encode_duals(seed):
    """Differential fuzz for the round-3 original-order paths: od decode ==
    untranspose(oracle decode); encode dual == oracle transpose+delta(+zz)
    +pack — random dtypes/widths/shapes/content incl. degenerate blocks."""
    from fastlanes_tpu.ops import orig as ops_orig

    def as_host(x, _dt):
        """Plane tuples (u64 od outputs) -> host values like from_jax_form."""
        if isinstance(x, tuple):
            img = np.stack([np.asarray(x[0]), np.asarray(x[1])], axis=-1)
            return np.ascontiguousarray(img).view("<u8")[..., 0]
        return from_jax_form(x, _dt)

    rng = np.random.default_rng(0x0819 + seed)
    dt, w, vals = _gen_case(rng)
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)

    transposed = ref.transpose(vals, dt)
    base = np.ascontiguousarray(transposed[:, :nl])
    deltas = ref.delta(transposed, base, dt)
    wd = max(1, min(t, int(deltas.max()).bit_length()))
    dp = ref.pack(deltas, wd, dt)
    want = ref.untranspose(ref.undelta_pack(dp, base, wd, dt), dt)

    got = ops_orig.undelta_pack_orig(to_jax_form(dp, dt),
                                     to_jax_form(base, dt), wd, dt)
    np.testing.assert_array_equal(as_host(got, dt), want)

    # encode dual reproduces the oracle wire bytes
    packed_enc, base_enc = ops_orig.delta_pack_orig(to_jax_form(vals, dt),
                                                    wd, dt)
    np.testing.assert_array_equal(from_jax_form(packed_enc, dt), dp)
    np.testing.assert_array_equal(from_jax_form(base_enc, dt), base)

    # zdelta round: encode dual -> od decode == original values
    from fastlanes_tpu import fio as fio_mod

    zz = fio_mod._zigzag_deltas(deltas)
    wz = max(1, min(t, int(zz.max()).bit_length()))
    packed_z, _ = ops_orig.delta_pack_orig(to_jax_form(vals, dt), wz, dt,
                                           zigzag=True)
    np.testing.assert_array_equal(from_jax_form(packed_z, dt),
                                  ref.pack(zz, wz, dt))
    rt = ops_orig.unzdelta_pack_orig(packed_z, to_jax_form(base, dt), wz, dt)
    np.testing.assert_array_equal(as_host(rt, dt), vals)

    # plain unpack_orig at the case width
    pv = ref.pack(transposed, w, dt)
    got_u = ops_orig.unpack_orig(to_jax_form(pv, dt), w, dt)
    np.testing.assert_array_equal(
        as_host(got_u, dt),
        ref.untranspose(ref.unpack(pv, w, dt), dt))
