"""Fastest-path routing: the public entry points take the winner per
(op, dtype, width) from the table measured on the running device kind
(kernels.routing), and the plain XLA paths when no table covers it."""

import json

import numpy as np
import pytest

from fastlanes_tpu.kernels import codecs as pk
from fastlanes_tpu.kernels import routing


@pytest.fixture(autouse=True)
def _restore_table():
    yield
    routing.set_table(None)


def test_no_table_takes_plain_defaults():
    routing.set_table(None)
    assert routing._entries() == {}
    for dt in ("u8", "u16", "u32", "u64"):
        assert routing.best_path("unzdelta_pack_orig", dt, 3) == "gat"
        assert routing.best_path("undelta_pack_orig", dt, 3) == "gat"
        assert routing.best_path("unpack_wt", dt, 8) == "assemble"
        assert routing.best_path("delta_pack_orig_enc", dt, 3) == "od"
    assert routing.best_path("untranspose_st", "u32", 0) == "permute"
    assert routing.best_path("unpack_single", "u16", 9) == "gather"


def test_canonical_dtype_and_nearest_width():
    routing.set_table({
        "undelta_pack_orig:u32:4": {"compose": 10.0, "gat": 20.0},
        "undelta_pack_orig:u32:16": {"compose": 30.0, "gat": 5.0},
    })
    assert routing.best_path("undelta_pack_orig", "uint32", 4) == "gat"
    # nearest measured width stands in: W=6 -> 4 (gat), W=12 -> 16 (compose)
    assert routing.best_path("undelta_pack_orig", "u32", 6) == "gat"
    assert routing.best_path("undelta_pack_orig", "u32", 12) == "compose"
    # equidistant ties toward the lower width: W=10 -> 4 -> gat
    assert routing.best_path("undelta_pack_orig", "u32", 10) == "gat"


def test_unmeasured_op_has_no_slot():
    """Entries with one formulation are not routed at all."""
    routing.set_table({"undelta_pack_orig:u32:4": {"gat": 2.0}})
    with pytest.raises(ValueError, match="no routing slot"):
        routing.best_path("unzdelta_pack", "u32", 4)


def _spy_untranspose(monkeypatch):
    from fastlanes_tpu.ops import transpose as transpose_mod

    calls = []
    real = transpose_mod.untranspose
    monkeypatch.setattr(transpose_mod, "untranspose",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _delta_case(rng, dt, w, n_blocks=5):
    from fastlanes_tpu.core import layout
    from fastlanes_tpu.ref import numpy_ref as ref

    np_dt = layout.np_dtype(dt)
    nl = layout.lanes(dt)
    packed = rng.integers(0, np.iinfo(np_dt).max, (n_blocks, layout.packed_len(dt, w)),
                          dtype=np_dt, endpoint=True)
    base = rng.integers(0, np.iinfo(np_dt).max, nl, dtype=np_dt, endpoint=True)
    want = ref.undelta_pack(packed, np.broadcast_to(base, (n_blocks, nl)), w, dt)
    return packed, base, ref.untranspose(want, dt)


def test_entry_without_table_takes_default(monkeypatch, rng):
    calls = _spy_untranspose(monkeypatch)
    packed, base, want = _delta_case(rng, "u32", 7)
    got = np.asarray(pk.undelta_pack_orig(packed, base, 7, "u32"))
    np.testing.assert_array_equal(got, want)
    assert not calls  # 'gat' writes original order in one pass


@pytest.mark.parametrize("dt,w", [("u16", 9), ("u32", 3)])
def test_entry_follows_table_to_compose(monkeypatch, rng, dt, w):
    calls = _spy_untranspose(monkeypatch)
    packed, base, want = _delta_case(rng, dt, w)
    routing.set_table({f"undelta_pack_orig:{dt}:{w}":
                       {"compose": 2.0, "gat": 1.0}})
    got = np.asarray(pk.undelta_pack_orig(packed, base, w, dt))
    np.testing.assert_array_equal(got, want)
    assert calls == [1]
    # a table where the one-pass form wins keeps the entry off compose
    routing.set_table({f"undelta_pack_orig:{dt}:{w}":
                       {"compose": 1.0, "gat": 2.0}})
    np.testing.assert_array_equal(
        np.asarray(pk.undelta_pack_orig(packed, base, w, dt)), want)
    assert calls == [1]


def test_sharded_orig_follows_table(monkeypatch, rng):
    """The per-shard original-order decode takes the routed formulation:
    a table where compose wins runs the standalone untranspose inside
    shard_map, and the result stays bit-exact."""
    from fastlanes_tpu.parallel import mesh as pmesh
    from fastlanes_tpu.parallel import shard

    calls = _spy_untranspose(monkeypatch)
    packed, base, want = _delta_case(rng, "u32", 5, n_blocks=16)
    mesh = pmesh.make_mesh(8)
    routing.set_table({"undelta_pack_orig:u32:5": {"compose": 2.0, "gat": 1.0}})
    got = np.asarray(shard.sharded_undelta_pack(mesh, packed, base, 5, "u32",
                                                orig=True))
    np.testing.assert_array_equal(got, want)
    assert calls == [1]


def test_public_entry_routes_to_ops_without_table(rng):
    """kernels.unpack with no table == the ops path, bit-exact."""
    from fastlanes_tpu.ref import numpy_ref as ref

    values = rng.integers(0, 8, (4, 1024), np.int64).astype(np.uint32)
    gold = ref.pack(values, 3, "u32")
    packed = pk.pack(values, 3, "u32")
    np.testing.assert_array_equal(np.asarray(packed), gold)
    out = pk.unpack(packed, 3, "u32")
    np.testing.assert_array_equal(np.asarray(out), values)


def test_warmup_compiles_routed_entries(rng):
    """kernels.warmup drives every requested routed entry once without
    error and reports the entry count."""
    from fastlanes_tpu import kernels

    n = kernels.warmup(ops=("pack", "unpack", "undelta_pack", "unfor_pack"),
                       dtypes=("u16", "u64"), widths=(1, 3), n_blocks=4)
    assert n == 2 * 2 * 4


def test_metadata_keys_ignored_by_argmax():
    """Per-entry provenance fields (blocks, K, ...) must not participate in
    the strategy argmax."""
    routing.set_table({"undelta_pack_orig:u32:3":
                       {"gat": 2.0, "compose": 1.0, "blocks": 131072}})
    assert routing.best_path("undelta_pack_orig", "u32", 3) == "gat"
    routing.set_table({"undelta_pack_orig:u32:3":
                       {"od": 5.0, "compose": 1.0, "blocks": 99}})
    assert routing.best_path("undelta_pack_orig", "u32", 3) == "od"


@pytest.fixture
def table_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(routing, "_TABLE_DIR", str(tmp_path))
    routing.load_table.cache_clear()
    yield tmp_path
    routing.load_table.cache_clear()


def _write_table(kind, recorded_kind, entries):
    with open(routing.table_path(kind), "w") as f:
        json.dump({"device_kind": recorded_kind, "entries": entries}, f)


def test_table_used_only_on_its_device_kind(table_dir, monkeypatch):
    _write_table("Example GPU 80GB", "Example GPU 80GB",
                 {"undelta_pack_orig:u32:3": {"compose": 2.0, "gat": 1.0}})
    monkeypatch.setattr(routing, "_device_kind", lambda: "Example GPU 80GB")
    routing.set_table(None)
    assert routing.best_path("undelta_pack_orig", "u32", 3) == "compose"
    monkeypatch.setattr(routing, "_device_kind", lambda: "Other GPU")
    routing.set_table(None)
    assert routing.best_path("undelta_pack_orig", "u32", 3) == "gat"


def test_table_recording_another_kind_is_ignored(table_dir):
    _write_table("Example GPU 80GB", "Other GPU",
                 {"undelta_pack_orig:u32:3": {"compose": 2.0}})
    assert routing.load_table("Example GPU 80GB") == {}
    assert routing.load_table("cpu") == {}


def test_table_path_is_keyed_by_kind():
    p = routing.table_path("NVIDIA H100 80GB HBM3")
    assert p.endswith("NVIDIA_H100_80GB_HBM3.json")
    assert routing.table_path("NVIDIA H100 PCIe") != p


def test_unpack_single_decode_strategy_bit_exact(rng):
    """The routed 'decode' strategy of unpack_single (full decode + one
    gather, taken for dense index sets) must agree with the 2-word 'gather'
    strategy and the oracle on every index."""
    from conftest import random_values
    from fastlanes_tpu.ops import single
    from fastlanes_tpu.ref import numpy_ref as ref
    from fastlanes_tpu.utils.testing import to_jax_form

    idx = np.arange(1024)
    for dt, w in (("u32", 3), ("u16", 9), ("u8", 7), ("u64", 33),
                  ("u32", 32), ("u64", 64)):
        values = random_values(rng, dt, w, n_blocks=3)
        packed = ref.pack(values, w, dt)
        want = ref.unpack_single(packed, w, idx, dt)
        arg = to_jax_form(packed, dt)
        try:
            routing.set_table({f"unpack_single:{dt}:{w}": {"decode": 1.0}})
            got_dec = np.asarray(single.unpack_single(arg, w, idx, dt))
            # sparse index sets stay on the gather path regardless
            got_sparse = np.asarray(single.unpack_single(arg, w, idx[:7], dt))
            routing.set_table({f"unpack_single:{dt}:{w}": {"gather": 1.0}})
            got_gat = np.asarray(single.unpack_single(arg, w, idx, dt))
        finally:
            routing.set_table(None)
        if dt == "u64":
            want_j = np.asarray(to_jax_form(want, dt))
            np.testing.assert_array_equal(got_dec, want_j)
            np.testing.assert_array_equal(got_gat, want_j)
            np.testing.assert_array_equal(got_sparse, want_j[:, :7])
        else:
            np.testing.assert_array_equal(got_dec, want)
            np.testing.assert_array_equal(got_gat, want)
            np.testing.assert_array_equal(got_sparse, want[:, :7])


def test_transpose_st_strategies_bit_exact(rng):
    """Every standalone-relayout strategy (permute/gather/axes) must equal
    the oracle in both directions; 'axes' is the pure-axis-reversal form
    (FL_ORDER bit-reversal == reversing three split 2-axes)."""
    from fastlanes_tpu.ops import transpose as tr
    from fastlanes_tpu.ref import numpy_ref as ref

    values = rng.integers(0, 1 << 31, (5, 1024), np.int64).astype(np.uint32)
    want_t = ref.transpose(values, "u32")
    want_u = ref.untranspose(values, "u32")
    for strat in ("permute", "gather", "axes"):
        try:
            routing.set_table({"transpose_st:u32:0": {strat: 1.0},
                               "untranspose_st:u32:0": {strat: 1.0}})
            tr._one_fn.cache_clear()
            np.testing.assert_array_equal(
                np.asarray(tr.transpose(values, "u32")), want_t, err_msg=strat)
            np.testing.assert_array_equal(
                np.asarray(tr.untranspose(values, "u32")), want_u,
                err_msg=strat)
        finally:
            routing.set_table(None)
            tr._one_fn.cache_clear()
