"""Regression tests for review findings: input normalization, index bounds,
delta base cost accounting."""

import numpy as np
import pytest

from fastlanes_tpu import fio
from fastlanes_tpu.kernels import codecs as pk
from fastlanes_tpu.models.codecs import auto_encode
from fastlanes_tpu.ref import numpy_ref as ref


def test_kernel_entries_accept_unbatched(rng):
    values = rng.integers(0, 8, 1024, np.int64).astype(np.uint16)
    packed = pk.pack(values, 3, "u16")
    assert packed.shape == (192,)  # unbatched in -> unbatched out
    out = np.asarray(pk.unpack(packed, 3, "u16"))
    np.testing.assert_array_equal(out, values)


def test_kernel_entries_accept_u64_limb_image(rng):
    values = rng.integers(0, 1 << 40, (4, 1024), np.int64).astype(np.uint64)
    limbs = np.ascontiguousarray(values).view(np.uint32).reshape(4, 1024, 2)
    packed = pk.pack(limbs, 41, "u64")
    assert packed.dtype == np.uint32 and packed.shape[-1] == 2
    gold = ref.pack(values, 41, "u64")
    np.testing.assert_array_equal(
        np.asarray(packed).view(np.uint8).reshape(4, -1),
        np.ascontiguousarray(gold).view(np.uint8).reshape(4, -1))


def test_kernel_entries_reject_wrong_dtype(rng):
    values = rng.integers(0, 8, (4, 1024), np.int64)  # int64, not uint16
    with pytest.raises(ValueError):
        pk.pack(values, 3, "u16")


def test_native_unpack_single_bounds(rng):
    native = pytest.importorskip("fastlanes_tpu.native")
    if not native.available():
        pytest.skip("native lib not built")
    values = rng.integers(0, 8, (2, 1024), np.int64).astype(np.uint32)
    packed = native.pack(values, 3, "u32")
    with pytest.raises(IndexError):
        native.unpack_single(packed, 3, np.array([1024]), "u32")
    with pytest.raises(IndexError):
        native.unpack_single(packed, 3, np.array([-1]), "u32")


def test_fio_read_single_bounds(tmp_path, rng):
    values = np.sort(rng.integers(0, 1 << 20, (4, 1024), np.int64)
                     .astype(np.uint32), axis=1)
    path = str(tmp_path / "c.flt")
    fio.write_file(path, values, dtype="u32")
    with pytest.raises(IndexError):
        fio.read_single(path, 0, 1024)
    with pytest.raises(IndexError):
        fio.read_single(path, 0, -1)  # no silent negative-index wrap


def test_auto_encode_charges_delta_base(rng):
    """When delta saves <1 bit/value vs ffor, the base overhead must tip the
    choice to ffor (delta's true cost includes +1 bit/value of base)."""
    # construct: ffor width 10, delta width 10 -> delta cost 11 > 10
    base_vals = rng.integers(0, 1 << 10, (2, 1024), np.int64).astype(np.uint32)
    values = base_vals + np.uint32(1 << 20)  # offset cluster, unsorted
    enc = auto_encode(values, "u32")
    assert enc.codec == "ffor"


def test_encoded_packed_bytes_includes_base(rng):
    values = np.sort(rng.integers(0, 1 << 24, (4, 1024), np.int64)
                     .astype(np.uint32), axis=1)
    enc = auto_encode(values, "u32")
    if enc.codec == "delta":
        payload = np.asarray(enc.payload).nbytes
        base = np.asarray(enc.params["base"]).nbytes
        assert enc.packed_bytes == payload + base


def test_ragged_read_single_rejects_padding(tmp_path):
    col = np.arange(1500, dtype=np.uint32)
    path = str(tmp_path / "r.flt")
    fio.write_file(path, col)
    assert fio.read_single(path, 1, 400) == col[1424]
    with pytest.raises(IndexError):
        fio.read_single(path, 1, 500)  # linear 1524 >= n_values=1500


def test_u64_packed_bytes_counts_limb_params(rng):
    from fastlanes_tpu.models.codecs import DeltaCodec
    vals = np.sort(rng.integers(0, 1 << 40, (4, 1024), np.int64)
                   .astype(np.uint64), axis=1)
    limbs = np.ascontiguousarray(vals).view(np.uint32).reshape(4, 1024, 2)
    enc = DeltaCodec("u64").encode(limbs)
    assert enc.packed_bytes == (np.asarray(enc.payload).nbytes
                                + np.asarray(enc.params["base"]).nbytes)


def test_lazy_reexports_do_not_import_ops():
    """Host-IO re-exports must not pull in the jax-backed ops modules."""
    import os
    import subprocess
    import sys as _sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        f"import sys; sys.path.insert(0, {repo!r})\n"
        "import fastlanes_tpu as fl\n"
        "_ = fl.write_file\n"
        "assert 'fastlanes_tpu.ops' not in sys.modules\n"
    )
    r = subprocess.run([_sys.executable, "-c", code], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-1000:]
