"""Original-order (untranspose-fused) decode: ops/orig.py formulation,
kernels.*_orig routed entries, sharded orig legs, and the fio_device
integration (delta/zdelta/rle file reads must not pay a standalone
untranspose pass)."""

import numpy as np
import pytest

import fastlanes_tpu.kernels as kernels
from fastlanes_tpu import fio, fio_device, transforms
from fastlanes_tpu.core import layout
from fastlanes_tpu.kernels import routing
from fastlanes_tpu.ops import orig as ops_orig
from fastlanes_tpu.parallel import mesh as mesh_mod, shard as psh
from fastlanes_tpu.ref import numpy_ref as ref

RNG = np.random.default_rng(7)

NON_LIMB = ("u8", "u16", "u32")


def _delta_fixture(dt, w, n_blocks=6):
    """(packed deltas, base, transposed, original) for a width-w column."""
    t = layout.bit_width(dt)
    nl = layout.lanes(dt)
    np_dt = layout.np_dtype(dt)
    vals = RNG.integers(0, 1 << w if w else 1, (n_blocks, 1024),
                        dtype=np.uint64).astype(np_dt)
    tr = ref.transpose(vals, dt)
    base = np.ascontiguousarray(tr[:, :nl])
    deltas = ref.delta(tr, base, dt)
    wd = int(deltas.max()).bit_length() if w else 0
    packed = ref.pack(deltas, wd, dt)
    return packed, base, wd, tr


FORMULATIONS = ("od", "gat", "rep")


@pytest.mark.parametrize("form", FORMULATIONS)
@pytest.mark.parametrize("dt", NON_LIMB)
def test_unpack_orig_matches_untranspose_of_unpack(dt, form):
    t = layout.bit_width(dt)
    for w in sorted({0, 1, 3, t // 2, t - 1, t}):
        vals = RNG.integers(0, 1 << w if w else 1, (5, 1024),
                            dtype=np.uint64).astype(layout.np_dtype(dt))
        tr = ref.transpose(vals, dt)
        packed = ref.pack(tr, w, dt)
        want = ref.untranspose(ref.unpack(packed, w, dt), dt)
        got = np.asarray(ops_orig.unpack_orig(packed, w, dt,
                                              formulation=form))
        assert np.array_equal(got, want), f"{dt} w={w} {form}"
        assert np.array_equal(got, vals)  # round-trips the original column


@pytest.mark.parametrize("form", FORMULATIONS)
@pytest.mark.parametrize("dt", NON_LIMB)
def test_undelta_pack_orig_conformance(dt, form):
    t = layout.bit_width(dt)
    for w in sorted({1, 3, t - 1, t}):
        packed, base, wd, tr = _delta_fixture(dt, w)
        want = ref.untranspose(ref.undelta_pack(packed, base, wd, dt), dt)
        got = np.asarray(ops_orig.undelta_pack_orig(packed, base, wd, dt,
                                                    formulation=form))
        assert np.array_equal(got, want), f"{dt} w={w}->{wd} {form}"


@pytest.mark.parametrize("form", FORMULATIONS)
@pytest.mark.parametrize("dt", NON_LIMB)
def test_unzdelta_pack_orig_conformance(dt, form):
    t = layout.bit_width(dt)
    np_dt = layout.np_dtype(dt)
    packed, base, wd, tr = _delta_fixture(dt, t // 2)
    deltas = ref.unpack(packed, wd, dt)
    zz = transforms.zigzag_encode_np(deltas.astype(np.dtype(f"int{t}")))
    wz = int(zz.max()).bit_length()
    pz = ref.pack(zz.astype(np_dt), wz, dt)
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, dt), dt)
    got = np.asarray(ops_orig.unzdelta_pack_orig(pz, base, wz, dt,
                                                 formulation=form))
    assert np.array_equal(got, want), form


def test_unbatched_and_base_forms():
    packed, base, wd, _ = _delta_fixture("u32", 7)
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, "u32"), "u32")
    one = np.asarray(ops_orig.undelta_pack_orig(packed[0], base[0], wd, "u32"))
    assert np.array_equal(one, want[0])
    # scalar base broadcast
    got = np.asarray(ops_orig.undelta_pack_orig(
        packed, np.uint32(5), wd, "u32"))
    base5 = np.full_like(base, 5)
    want5 = ref.untranspose(ref.undelta_pack(packed, base5, wd, "u32"), "u32")
    assert np.array_equal(got, want5)


def test_orig_rejects_bad_base():
    packed, base, wd, _ = _delta_fixture("u32", 4)
    with pytest.raises(ValueError):
        ops_orig.undelta_pack_orig(packed, base[:, :5], wd, "u32")


def _u64_img(arr):
    return np.ascontiguousarray(arr).view(np.uint32).reshape(*arr.shape, 2)


@pytest.mark.parametrize("form", FORMULATIONS)
@pytest.mark.parametrize("w", [1, 3, 31, 33, 40, 63, 64])
def test_u64_od_unpack_orig(w, form):
    """u64 output-domain unpack: vector-shift limb funnels across word
    boundaries, bit-exact vs untranspose(unpack) at every shift regime."""
    vals = RNG.integers(0, 1 << min(w, 63), (4, 1024), dtype=np.uint64)
    if w == 64:
        vals |= np.uint64(1) << np.uint64(63)
    tr = ref.transpose(vals, "u64")
    packed = ref.pack(tr, w, "u64")
    want = _u64_img(ref.untranspose(ref.unpack(packed, w, "u64"), "u64"))
    lo, hi = ops_orig.unpack_orig(_u64_img(packed), w, "u64",
                                  formulation=form)
    assert np.array_equal(np.asarray(lo), want[..., 0]), f"lo w={w} {form}"
    assert np.array_equal(np.asarray(hi), want[..., 1]), f"hi w={w} {form}"


def test_u64_od_undelta_carry_propagation():
    """The carry-propagating segmented cumsum: values cross the 2^32
    boundary repeatedly so low-limb overflows MUST carry into the high
    limb."""
    nl = layout.lanes("u64")
    # steps near 2^31 force frequent low-limb wraps in the prefix sums
    steps = RNG.integers((1 << 31) - 5, (1 << 31) + 5, (6, 1024),
                         dtype=np.uint64)
    vals = np.cumsum(steps, axis=1, dtype=np.uint64) + np.uint64(0xFFFF0000)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    deltas = ref.delta(tr, base, "u64")
    wd = int(deltas.max()).bit_length()
    packed = ref.pack(deltas, wd, "u64")
    want = _u64_img(ref.untranspose(ref.undelta_pack(packed, base, wd, "u64"),
                                    "u64"))
    for form in FORMULATIONS:
        lo, hi = ops_orig.undelta_pack_orig(_u64_img(packed), _u64_img(base),
                                            wd, "u64", formulation=form)
        assert np.array_equal(np.asarray(lo), want[..., 0]), form
        assert np.array_equal(np.asarray(hi), want[..., 1]), form


def test_u64_od_unzdelta():
    nl = layout.lanes("u64")
    steps = RNG.integers(-9, 9, (4, 1024), dtype=np.int64)
    vals = (np.cumsum(steps, axis=1) + (1 << 40)).astype(np.uint64)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    zz = fio._zigzag_deltas(ref.delta(tr, base, "u64"))
    wz = int(zz.max()).bit_length()
    packed = ref.pack(zz, wz, "u64")
    want = _u64_img(vals)
    for form in FORMULATIONS:
        lo, hi = ops_orig.unzdelta_pack_orig(_u64_img(packed), _u64_img(base),
                                             wz, "u64", formulation=form)
        assert np.array_equal(np.asarray(lo), want[..., 0]), form
        assert np.array_equal(np.asarray(hi), want[..., 1]), form


def test_u64_kernel_entry_od_strategy():
    nl = layout.lanes("u64")
    vals = np.sort(RNG.integers(0, 1 << 45, (4, 1024), dtype=np.uint64),
                   axis=1)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    deltas = ref.delta(tr, base, "u64")
    wd = int(deltas.max()).bit_length()
    packed = ref.pack(deltas, wd, "u64")
    want = _u64_img(vals)
    for strategy in ("od", "gat", "rep", "compose"):
        lo, hi = kernels.undelta_pack_orig(
            _u64_img(packed), _u64_img(base), wd, "u64", planes=True,
            strategy=strategy)
        assert np.array_equal(np.asarray(lo), want[..., 0]), strategy
        assert np.array_equal(np.asarray(hi), want[..., 1]), strategy
    # planes=False: the interleaved byte image
    img = kernels.undelta_pack_orig(_u64_img(packed), _u64_img(base), wd,
                                    "u64", strategy="od")
    assert np.array_equal(np.asarray(img), want)


def test_u64_sharded_orig_od_planes():
    """The output-domain 'od' formulation under shard_map, taken through
    the routing table, returns (lo, hi) planes."""
    m = mesh_mod.make_mesh()
    nl = layout.lanes("u64")
    vals = np.sort(RNG.integers(0, 1 << 50, (16, 1024), dtype=np.uint64),
                   axis=1)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    deltas = ref.delta(tr, base, "u64")
    wd = int(deltas.max()).bit_length()
    packed = ref.pack(deltas, wd, "u64")
    try:
        routing.set_table({f"undelta_pack_orig:u64:{wd}": {"od": 1.0}})
        lo, hi = psh.sharded_undelta_pack(
            m, _u64_img(packed), _u64_img(base), wd, "u64", planes=True,
            orig=True)
    finally:
        routing.set_table(None)
    want = _u64_img(vals)
    assert np.array_equal(np.asarray(lo), want[..., 0])
    assert np.array_equal(np.asarray(hi), want[..., 1])


@pytest.mark.parametrize("strategy", ["od", "gat", "rep", "compose"])
def test_kernel_entries_both_strategies(strategy):
    packed, base, wd, _ = _delta_fixture("u32", 9)
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, "u32"), "u32")
    got = np.asarray(kernels.undelta_pack_orig(packed, base, wd, "u32",
                                               strategy=strategy))
    assert np.array_equal(got, want)
    vals_packed = ref.pack(ref.transpose(want, "u32"), 32, "u32")
    got = np.asarray(kernels.unpack_orig(vals_packed, 32, "u32",
                                         strategy=strategy))
    assert np.array_equal(got, want)


def test_routing_table_drives_orig_strategy():
    """A table entry where compose wins must route the public entry to
    compose (and the flat 'gat' formulation by default when unmeasured)."""
    if "undelta_pack_orig:u32:3" not in routing._entries():
        assert routing.best_path("undelta_pack_orig", "u32", 3) == "gat"
    try:
        routing.set_table({"undelta_pack_orig:u32:3":
                           {"od": 1.0, "compose": 2.0}})
        assert routing.best_path("undelta_pack_orig", "u32", 3) == "compose"
        packed, base, wd, _ = _delta_fixture("u32", 2)
        want = ref.untranspose(ref.undelta_pack(packed, base, wd, "u32"), "u32")
        got = np.asarray(kernels.undelta_pack_orig(packed, base, wd, "u32"))
        assert np.array_equal(got, want)
    finally:
        routing.set_table(None)


def test_kernel_entry_u64_composes_in_planes():
    nl = layout.lanes("u64")
    vals = RNG.integers(0, 1 << 40, (4, 1024), dtype=np.uint64)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    deltas = ref.delta(tr, base, "u64")
    wd = int(deltas.max()).bit_length()
    packed = ref.pack(deltas, wd, "u64")
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, "u64"), "u64")
    want_img = np.ascontiguousarray(want).view(np.uint32).reshape(4, 1024, 2)
    lo, hi = kernels.undelta_pack_orig(
        packed.view(np.uint32).reshape(4, -1, 2),
        base.view(np.uint32).reshape(4, nl, 2), wd, "u64", planes=True)
    assert np.array_equal(np.asarray(lo), want_img[..., 0])
    assert np.array_equal(np.asarray(hi), want_img[..., 1])


@pytest.mark.parametrize("dt", NON_LIMB)
def test_sharded_orig_legs(dt):
    """Sharded original-order delta decode and unpack, 13 blocks on the
    8-device mesh (padded and trimmed)."""
    m = mesh_mod.make_mesh()
    t = layout.bit_width(dt)
    packed, base, wd, _ = _delta_fixture(dt, t - 2, n_blocks=13)
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, dt), dt)
    got = psh.sharded_undelta_pack(m, packed, base, wd, dt, orig=True)
    assert np.array_equal(np.asarray(got), want)
    tr_packed = ref.pack(ref.transpose(want, dt), t, dt)
    got = psh.sharded_unpack(m, tr_packed, t, dt, orig=True)
    assert np.array_equal(np.asarray(got), want)


def test_sharded_orig_zdelta_u64_planes():
    m = mesh_mod.make_mesh()
    nl = layout.lanes("u64")
    steps = RNG.integers(-5, 9, (16, 1024), dtype=np.int64)
    vals = (np.cumsum(steps, axis=1) + (1 << 35)).astype(np.uint64)
    tr = ref.transpose(vals, "u64")
    base = np.ascontiguousarray(tr[:, :nl])
    zz = fio._zigzag_deltas(ref.delta(tr, base, "u64"))
    wz = int(zz.max()).bit_length()
    packed = ref.pack(zz, wz, "u64")
    lo, hi = psh.sharded_unzdelta_pack(
        m, packed.view(np.uint32).reshape(16, -1, 2),
        base.view(np.uint32).reshape(16, nl, 2), wz, "u64", planes=True,
        orig=True)
    want_img = vals.view(np.uint32).reshape(16, 1024, 2)
    assert np.array_equal(np.asarray(lo), want_img[..., 0])
    assert np.array_equal(np.asarray(hi), want_img[..., 1])


def _roundtrip_device(vals, tmp_path, name, mesh=None):
    p = str(tmp_path / name)
    fio.write_file(p, vals)
    got = fio_device.read_file_device(p, mesh=mesh)
    return p, got


def test_fio_device_delta_reads_via_orig(tmp_path, monkeypatch):
    """Sorted columns (delta codec) decode bit-exactly through the orig
    path, taking the MEASURED fastest strategy: a standalone untranspose
    runs in fio_device iff the routing table records 'compose' as the
    winner for some chunk's (op, dtype, width) (the
    invariant is measured-winner routing, in both directions, not
    "never untranspose")."""
    from fastlanes_tpu.kernels import routing
    from fastlanes_tpu.ops import transpose as transpose_mod

    calls = []
    real = transpose_mod.untranspose
    monkeypatch.setattr(transpose_mod, "untranspose",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    vals = np.sort(RNG.integers(0, 1 << 30, (8, 1024), np.int64)
                   .astype(np.uint32), axis=1)
    p, got = _roundtrip_device(vals, tmp_path, "sorted.flt")
    hdr = fio.read_header(p)
    assert hdr["chunks"][0]["codec"] in ("delta", "zdelta")
    assert np.array_equal(np.asarray(got).reshape(8, 1024), vals)
    op_of = {"delta": "undelta_pack_orig", "zdelta": "unzdelta_pack_orig"}
    expect_compose = any(
        routing.best_path(op_of[c["codec"]], hdr["dtype"], c["width"])
        == "compose"
        for c in hdr["chunks"] if c["codec"] in op_of)
    assert bool(calls) == expect_compose, (
        f"untranspose calls={len(calls)} but routing says "
        f"compose={'expected' if expect_compose else 'not expected'} for "
        f"chunks {[(c['codec'], c['width']) for c in hdr['chunks']]}")


def test_fio_device_rle_reads_via_orig(tmp_path):
    reps = RNG.integers(1, 50, 400)
    flat = np.repeat(RNG.integers(0, 1000, 400).astype(np.uint32), reps)
    flat = flat[:8 * 1024]
    vals = flat.reshape(-1)
    p = str(tmp_path / "rle.flt")
    fio.write_file(p, vals, codec="rle")
    got = fio_device.read_file_device(p)
    assert np.array_equal(np.asarray(got).reshape(-1), vals)


def test_fio_device_u64_delta_planes_roundtrip(tmp_path):
    vals = np.sort(RNG.integers(0, 1 << 45, 4 * 1024, dtype=np.uint64))
    p = str(tmp_path / "u64sorted.flt")
    fio.write_file(p, vals)
    got = fio_device.read_file_device(p)
    assert got.to_u64().reshape(-1).shape == vals.shape
    assert np.array_equal(got.to_u64().reshape(-1), vals)


def test_fio_device_delta_sharded_orig(tmp_path):
    m = mesh_mod.make_mesh()
    vals = np.sort(RNG.integers(0, 1 << 28, (16, 1024), np.int64)
                   .astype(np.uint32), axis=1)
    p, got = _roundtrip_device(vals, tmp_path, "sorted8.flt", mesh=m)
    assert np.array_equal(np.asarray(got).reshape(16, 1024), vals)


def test_chunk_batching_merges_dispatches(tmp_path, monkeypatch):
    """Consecutive same-(codec, width) chunks decode in ONE batched device
    dispatch; mixed-width files split into per-signature runs."""
    from fastlanes_tpu import fio_device as fd

    calls = []
    real = fd._decode_packed_device
    monkeypatch.setattr(
        fd, "_decode_packed_device",
        lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    # 8 chunks of identical width: sorted data with the same gap structure
    base_col = np.arange(8 * 1024, dtype=np.uint32) * 7
    p = str(tmp_path / "uniform.flt")
    fio.write_file(p, base_col, chunk_blocks=1)
    hdr = fio.read_header(p)
    assert len(hdr["chunks"]) == 8
    widths = {c["width"] for c in hdr["chunks"]}
    got = fio_device.read_file_device(p)
    assert np.array_equal(np.asarray(got).reshape(-1), base_col)
    if len(widths) == 1 and hdr["chunks"][0]["codec"] in ("delta", "zdelta",
                                                          "bitpack"):
        assert len(calls) == 1, f"expected 1 batched dispatch, got {calls}"


def test_chunk_batching_partial_range(tmp_path):
    vals = np.sort(RNG.integers(0, 1 << 29, (32, 1024), np.int64)
                   .astype(np.uint32), axis=1)
    p = str(tmp_path / "range.flt")
    fio.write_file(p, vals, chunk_blocks=4)
    want = fio.read_blocks(p, 3, 29)
    got = fio_device.read_blocks_device(p, 3, 29)
    assert np.array_equal(np.asarray(got), want)


def test_chunk_batching_mixed_codecs(tmp_path):
    """A file whose chunks pick different codecs/widths still reads exactly."""
    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 1 << 30, 4 * 1024, np.int64).astype(np.uint32))
    b = rng.integers(50_000, 50_000 + 128, 4 * 1024, np.int64).astype(np.uint32)
    c = rng.integers(0, 8, 4 * 1024, np.int64).astype(np.uint32)
    vals = np.concatenate([a, b, c])
    p = str(tmp_path / "mixed.flt")
    fio.write_file(p, vals, chunk_blocks=4)
    hdr = fio.read_header(p)
    assert len({ch["codec"] for ch in hdr["chunks"]}) >= 2
    got = fio_device.read_file_device(p)
    assert np.array_equal(np.asarray(got).reshape(-1), vals)


def test_rle_multichunk_batched(tmp_path, monkeypatch):
    """Multiple rle chunks decode through ONE index-decode dispatch with a
    single flat run-value gather across the whole file."""
    from fastlanes_tpu import fio_device as fd

    calls = []
    real = fd._rle_gather
    monkeypatch.setattr(fd, "_rle_gather",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    reps = rng.integers(1, 200, 800)
    flat = np.repeat(rng.integers(0, 50, 800).astype(np.uint32), reps)
    flat = flat[:16 * 1024]
    p = str(tmp_path / "runs.flt")
    fio.write_file(p, flat, codec="rle", chunk_blocks=4)
    assert len(fio.read_header(p)["chunks"]) == 4
    got = fio_device.read_file_device(p)
    assert np.array_equal(np.asarray(got).reshape(-1), flat)
    assert len(calls) == 1, f"expected one batched rle dispatch, got {len(calls)}"


def test_rle_multichunk_partial_range(tmp_path):
    rng = np.random.default_rng(6)
    reps = rng.integers(1, 100, 2000)
    flat = np.repeat(rng.integers(0, 1 << 40, 2000).astype(np.uint64), reps)
    flat = flat[:24 * 1024]
    p = str(tmp_path / "runs64.flt")
    fio.write_file(p, flat, codec="rle", chunk_blocks=4)
    want = fio.read_blocks(p, 3, 21)
    got = fio_device.read_blocks_device(p, 3, 21)
    got_img = np.asarray(got)
    assert np.array_equal(
        np.ascontiguousarray(got_img).view(np.uint64)[..., 0], want)


def test_orig_interpret_forces_compose(monkeypatch):
    """A table naming 'compose' for the original-order entry runs the
    transposed decode and then the standalone untranspose."""
    from fastlanes_tpu.ops import transpose as transpose_mod

    calls = []
    real = transpose_mod.untranspose
    monkeypatch.setattr(transpose_mod, "untranspose",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    packed, base, wd, _ = _delta_fixture("u16", 5)
    want = ref.untranspose(ref.undelta_pack(packed, base, wd, "u16"), "u16")
    try:
        routing.set_table({f"undelta_pack_orig:u16:{wd}": {"compose": 1.0}})
        got = np.asarray(kernels.undelta_pack_orig(packed, base, wd, "u16"))
    finally:
        routing.set_table(None)
    assert calls, "the routed compose path did not run the untranspose"
    assert np.array_equal(got, want)


def test_alp_multichunk_batched(tmp_path, monkeypatch):
    """alp chunks sharing (width, e, f, reference) decode in one dispatch;
    exception positions offset per chunk; bit-exact float round trip."""
    from fastlanes_tpu import fio_device as fd

    calls = []
    real = fd._decode_alp_batched
    monkeypatch.setattr(
        fd, "_decode_alp_batched",
        lambda run, *a, **k: calls.append(len(run)) or real(run, *a, **k))
    rng = np.random.default_rng(9)
    prices = (rng.integers(0, 1 << 16, 16 * 1024) / 100.0).astype(np.float32)
    # a few exact-exception values (non-decimal) sprinkled in
    prices[::1500] = np.float32(np.pi)
    p = str(tmp_path / "prices.flt")
    fio.write_file(p, prices, chunk_blocks=4)
    hdr = fio.read_header(p)
    assert hdr["chunks"][0]["codec"] == "alp" and len(hdr["chunks"]) == 4
    got = np.asarray(fio_device.read_file_device(p))
    assert np.array_equal(got.view(np.uint32), prices.view(np.uint32))
    sigs = {fd._group_sig(c) for c in hdr["chunks"]}
    if len(sigs) == 1:
        assert calls == [4], f"expected one 4-chunk dispatch, got {calls}"
