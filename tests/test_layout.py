"""Layout-core invariants, mirroring reference tests lib.rs:53-59 and the
verified layout semantics of SURVEY.md §2."""

import numpy as np
import pytest

from fastlanes_tpu.core import layout


def test_fl_order_self_inverse():
    # reference lib.rs:53-59
    for i in range(8):
        assert layout.FL_ORDER[layout.FL_ORDER[i]] == i


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_index_bijection(dt):
    t, nl = layout.bit_width(dt), layout.lanes(dt)
    assert t * nl == 1024
    seen = sorted(layout.index(r, l) for r in range(t) for l in range(nl))
    assert seen == list(range(1024))


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_inverse_tables(dt):
    # reference bitpacking.rs:207-232
    lt, rt = layout.lanes_by_index(dt), layout.rows_by_index(dt)
    for r in range(layout.bit_width(dt)):
        for l in range(layout.lanes(dt)):
            idx = layout.index(r, l)
            assert lt[idx] == l
            assert rt[idx] == r


@pytest.mark.parametrize("dt", layout.DTYPES)
def test_rows_are_contiguous_slices(dt):
    """The layout fact everything is built on: transposed row (row, :) is
    the contiguous flat slice [row_offset(row), row_offset(row)+LANES)."""
    nl = layout.lanes(dt)
    for r in range(layout.bit_width(dt)):
        off = layout.row_offset(r)
        for l in (0, nl // 2, nl - 1):
            assert layout.index(r, l) == off + l
    # offsets of all rows with the same s tile exactly [0,128)
    offs = sorted(layout.FL_ORDER[o] * 16 for o in range(layout.bit_width(dt) // 8))
    assert offs == list(range(0, 128, nl))


def test_transpose_bijection_not_self_inverse():
    p = layout.transpose_perm()
    assert sorted(p.tolist()) == list(range(1024))
    # NOT self-inverse (SURVEY §2 C11) ...
    assert not np.array_equal(p[p], np.arange(1024))
    # ... but untranspose_perm inverts it.
    q = layout.untranspose_perm()
    assert np.array_equal(p[q], np.arange(1024))
    assert np.array_equal(q[p], np.arange(1024))


def test_row_walk_visits_contiguous_originals():
    """Walking rows 0..T at fixed lane through transpose∘index visits T
    contiguous original indices (SURVEY §2, e.g. u16 lane 0 -> 0..15)."""
    tp = layout.transpose_perm()
    for dt in layout.DTYPES:
        t = layout.bit_width(dt)
        for lane in (0, 1, layout.lanes(dt) - 1):
            orig = [tp[layout.index(r, lane)] for r in range(t)]
            assert orig == list(range(orig[0], orig[0] + t))


def test_packed_len():
    assert layout.packed_len("u16", 3) == 192  # README example
    assert layout.packed_len("u16", 15) == 960
    assert layout.packed_len("u32", 10) == 320
    assert layout.packed_len("u64", 64) == 1024
    assert layout.packed_len("u8", 0) == 0
    with pytest.raises(ValueError):
        layout.packed_len("u8", 9)
    with pytest.raises(ValueError):
        layout.check_width("u32", -1)


def test_validate_layout():
    layout.validate_layout()


def test_canon_dtype():
    assert layout.canon_dtype(np.uint32) == "u32"
    assert layout.canon_dtype("uint8") == "u8"
    assert layout.canon_dtype(np.dtype("uint64")) == "u64"
    with pytest.raises(ValueError):
        layout.canon_dtype("int32")
