"""Natural-order (transposed-domain) analytics consumption:
order-insensitive consumers (reductions, counts, value-domain
aggregates) skip the per-block untranspose relayout entirely on
delta-family chunks. These tests pin BOTH directions: exactness of every
enabled surface, and that the untranspose/orig decode genuinely never runs
when it's safe to skip — while positional reads (read_file_device,
select/scan_where values) keep original order bit-exactly."""

import numpy as np
import pytest

from fastlanes_tpu import analytics, fio, fio_device

RNG = np.random.default_rng(11)


def _spy_orig_and_untranspose(monkeypatch):
    """Count every standalone untranspose and every *_orig fused decode."""
    from fastlanes_tpu.kernels import codecs as pk
    from fastlanes_tpu.ops import transpose as transpose_mod

    calls = {"untranspose": 0, "orig": 0}
    real_ut = transpose_mod.untranspose
    monkeypatch.setattr(
        transpose_mod, "untranspose",
        lambda *a, **k: calls.__setitem__(
            "untranspose", calls["untranspose"] + 1) or real_ut(*a, **k))
    for name in ("undelta_pack_orig", "unzdelta_pack_orig", "unpack_orig"):
        real = getattr(pk, name)
        monkeypatch.setattr(
            pk, name,
            (lambda real: lambda *a, **k: calls.__setitem__(
                "orig", calls["orig"] + 1) or real(*a, **k))(real))
    # fio_device holds no direct refs (calls pk.<name> at runtime), so the
    # monkeypatch above is what its decode path sees
    return calls


def _sorted_u32(n):
    return np.sort(RNG.integers(0, 1 << 28, n, np.int64).astype(np.uint32))


def test_scan_column_sorted_skips_untranspose(tmp_path, monkeypatch):
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = _sorted_u32(8 * 1024)  # full blocks: no padded tail
    p = str(tmp_path / "s.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    assert fio.read_header(p)["chunks"][0]["codec"] in ("delta", "zdelta")
    stats = analytics.scan_column(p)
    assert stats == {"sum": int(vals.sum()), "min": int(vals.min()),
                     "max": int(vals.max()), "count": vals.size}
    assert calls["untranspose"] == 0 and calls["orig"] == 0, calls


def test_count_where_sorted_skips_untranspose(tmp_path, monkeypatch):
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = _sorted_u32(8 * 1024)
    p = str(tmp_path / "s.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    probe = int(vals[3000])
    assert analytics.count_where(p, "le", probe) == int(
        (vals <= probe).sum())
    assert calls["untranspose"] == 0 and calls["orig"] == 0, calls


def test_scan_where_single_column_sorted(tmp_path, monkeypatch):
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = _sorted_u32(8 * 1024)
    p = str(tmp_path / "s.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    probe = int(vals[5000])
    m = vals >= probe
    r = analytics.scan_where(p, "ge", probe)
    assert r == {"sum": int(vals[m].sum()), "min": int(vals[m].min()),
                 "max": int(vals[m].max()), "count": int(m.sum())}
    assert calls["untranspose"] == 0 and calls["orig"] == 0, calls


def test_partial_tail_splits_run(tmp_path, monkeypatch):
    """A padded tail block forces orig order for the TAIL chunk only; the
    bulk still decodes naturally. Stats stay exact."""
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = _sorted_u32(6 * 1024 + 700)  # 7 blocks, last one padded
    p = str(tmp_path / "t.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    stats = analytics.scan_column(p)
    assert stats == {"sum": int(vals.sum()), "min": int(vals.min()),
                     "max": int(vals.max()), "count": vals.size}
    # tail chunk (padded) must have taken a positional-safe path
    assert calls["orig"] + calls["untranspose"] >= 1


def test_nullable_column_keeps_positional_path(tmp_path, monkeypatch):
    """Validity bitmaps are positional: natural order must stay OFF."""
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = _sorted_u32(4 * 1024)
    mask = np.zeros(vals.size, bool)
    mask[::7] = True
    p = str(tmp_path / "n.flt")
    fio.write_file(p, np.ma.MaskedArray(vals, mask=mask))
    hdr = fio.read_header(p)
    if hdr["chunks"][0]["codec"] not in ("delta", "zdelta"):
        pytest.skip("writer chose a non-delta codec for this data")
    want = vals[~mask]
    stats = analytics.scan_column(p)
    assert stats["count"] == want.size
    assert stats["min"] == int(want.min()) and stats["max"] == int(want.max())
    assert calls["orig"] + calls["untranspose"] >= 1


def test_value_counts_and_top_k_sorted(tmp_path, monkeypatch):
    calls = _spy_orig_and_untranspose(monkeypatch)
    base = np.sort(RNG.integers(0, 50, 8 * 1024, np.int64).astype(np.uint32))
    p = str(tmp_path / "v.flt")
    fio.write_file(p, base, codec="delta", chunk_blocks=2)
    vc = analytics.value_counts(p)
    want_vals, want_counts = np.unique(base, return_counts=True)
    assert {int(k): int(v) for k, v in vc.items()} == \
        dict(zip(want_vals.tolist(), want_counts.tolist()))
    got = analytics.top_k(p, k=5)
    want_top = np.sort(base)[-5:][::-1].tolist()
    assert list(got) == want_top
    assert calls["untranspose"] == 0 and calls["orig"] == 0, calls


def test_positional_reads_unchanged(tmp_path):
    """read_file_device still returns exact ORIGINAL order for sorted
    (delta) columns — natural order never leaks into positional reads."""
    vals = _sorted_u32(4 * 1024)
    p = str(tmp_path / "o.flt")
    fio.write_file(p, vals, chunk_blocks=2)
    got = fio_device.read_file_device(p)
    assert np.array_equal(np.asarray(got).reshape(-1), vals)


def test_scan_matches_orig_path_u64(tmp_path, monkeypatch):
    """u64 plane-domain natural decode agrees with ground truth."""
    calls = _spy_orig_and_untranspose(monkeypatch)
    vals = np.sort(RNG.integers(0, 1 << 45, 4 * 1024, dtype=np.uint64))
    p = str(tmp_path / "u64.flt")
    fio.write_file(p, vals)
    if fio.read_header(p)["chunks"][0]["codec"] not in ("delta", "zdelta"):
        pytest.skip("writer chose a non-delta codec")
    stats = analytics.scan_column(p)
    assert stats["sum"] == int(vals.sum())
    assert stats["min"] == int(vals.min())
    assert stats["max"] == int(vals.max())
    assert calls["untranspose"] == 0 and calls["orig"] == 0, calls
