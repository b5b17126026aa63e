"""LimbPlanes carrier + plane-form u64 fast paths.

u64 device decodes return separate (lo, hi) uint32 planes by default —
the fast form that never pays the interleaving stack — wrapped in
`limbs.LimbPlanes` with byte-image compatibility via np.asarray.
"""

import numpy as np
import pytest

import fastlanes_tpu as fl
from fastlanes_tpu import fio, fio_device
from fastlanes_tpu.limbs import LimbPlanes
from fastlanes_tpu.ops import bitpack, delta as delta_mod, ffor, transpose
from fastlanes_tpu.parallel import mesh as pmesh, shard as psh


def _u64(rng, shape, hi_bits=40):
    return rng.integers(0, 1 << hi_bits, shape, np.int64).astype(np.uint64)


def test_limbplanes_structure_and_conversions(rng):
    vals = _u64(rng, (3, 1024))
    p = LimbPlanes.from_u64(vals)
    assert p.shape == (3, 1024) and p.ndim == 2 and len(p) == 3
    # slicing / reshape hit both planes
    assert p[1:].shape == (2, 1024)
    assert p.reshape(-1).shape == (3 * 1024,)
    # byte-image round trips
    img = np.asarray(p)
    assert img.shape == (3, 1024, 2) and img.dtype == np.uint32
    np.testing.assert_array_equal(
        np.ascontiguousarray(img).view(np.uint64)[..., 0], vals)
    np.testing.assert_array_equal(p.to_u64(), vals)
    np.testing.assert_array_equal(
        np.asarray(LimbPlanes.from_interleaved(img).to_u64()), vals)
    # mismatched planes rejected
    with pytest.raises(ValueError, match="match in shape"):
        LimbPlanes(img[..., 0], img[0, :, 1])
    # package-level export
    assert fl.LimbPlanes is LimbPlanes


def test_planes_flag_rejected_for_narrow_dtypes():
    arr = np.zeros((2, 96), np.uint32)
    with pytest.raises(ValueError, match="limb-plane"):
        bitpack.unpack(arr, 3, "u32", planes=True)


@pytest.mark.parametrize("w", [0, 1, 7, 33, 64])
def test_unpack_planes_matches_interleaved(rng, w):
    vals = _u64(rng, (4, 1024), hi_bits=min(w, 63)) if w else np.zeros(
        (4, 1024), np.uint64)
    vals &= (np.uint64((1 << w) - 1) if 0 < w < 64 else np.uint64(0xFFFFFFFFFFFFFFFF))
    if w == 0:
        vals[:] = 0
    packed = np.asarray(bitpack.pack(LimbPlanes.from_u64(vals).interleaved(),
                                     w, "u64"))
    lo, hi = bitpack.unpack(packed, w, "u64", planes=True)
    img = np.asarray(bitpack.unpack(packed, w, "u64"))
    np.testing.assert_array_equal(np.asarray(lo), img[..., 0])
    np.testing.assert_array_equal(np.asarray(hi), img[..., 1])


def test_fused_decode_planes_match(rng):
    vals = np.sort(_u64(rng, (4, 1024), hi_bits=30), axis=1)
    img = LimbPlanes.from_u64(vals).interleaved()
    tr = transpose.transpose(img, "u64")
    base = np.asarray(tr)[:, :layout_lanes()]  # per-block base limb image
    deltas = delta_mod.delta(tr, base, "u64")
    w = 31
    packed = bitpack.pack(deltas, w, "u64")
    want = np.asarray(delta_mod.undelta_pack(packed, base, w, "u64"))
    lo, hi = delta_mod.undelta_pack(packed, base, w, "u64", planes=True)
    np.testing.assert_array_equal(np.asarray(lo), want[..., 0])
    np.testing.assert_array_equal(np.asarray(hi), want[..., 1])
    # untranspose in the plane domain
    ulo, uhi = transpose.untranspose((lo, hi), "u64", planes=True)
    uimg = np.asarray(transpose.untranspose(want, "u64"))
    np.testing.assert_array_equal(np.asarray(ulo), uimg[..., 0])
    np.testing.assert_array_equal(np.asarray(uhi), uimg[..., 1])
    # ffor twin
    fp = ffor.for_pack(img & np.uint64(0xFFFF), 7, 20, "u64")
    want_f = np.asarray(ffor.unfor_pack(fp, 7, 20, "u64"))
    flo, fhi = ffor.unfor_pack(fp, 7, 20, "u64", planes=True)
    np.testing.assert_array_equal(np.asarray(flo), want_f[..., 0])
    np.testing.assert_array_equal(np.asarray(fhi), want_f[..., 1])


def layout_lanes():
    from fastlanes_tpu.core import layout

    return layout.lanes("u64")


@pytest.mark.parametrize("codec", ["bitpack", "ffor", "delta", "rle"])
def test_u64_file_reads_return_planes(tmp_path, rng, codec):
    if codec == "delta":
        vals = np.sort(_u64(rng, 8 * 1024, hi_bits=34))
    elif codec == "rle":
        vals = np.repeat(_u64(rng, 64, hi_bits=34), 128)
    else:
        vals = _u64(rng, 8 * 1024, hi_bits=20)
    path = str(tmp_path / "c.flt")
    fio.write_file(path, vals, dtype="u64", codec=codec)
    out = fio_device.read_file_device(path)
    assert isinstance(out, LimbPlanes), f"{codec}: got {type(out)}"
    np.testing.assert_array_equal(out.to_u64(), vals)
    blocks = fio_device.read_blocks_device(path, 1, 5)
    assert isinstance(blocks, LimbPlanes) and blocks.shape == (4, 1024)
    np.testing.assert_array_equal(blocks.to_u64().reshape(-1),
                                  vals[1024:5 * 1024])


def test_u64_signed_zigzag_file_returns_planes(tmp_path, rng):
    vals = rng.integers(-(1 << 40), 1 << 40, 4096, np.int64)
    path = str(tmp_path / "s.flt")
    fio.write_file(path, vals)
    out = fio_device.read_file_device(path)
    assert isinstance(out, LimbPlanes)
    np.testing.assert_array_equal(out.to_u64().view(np.int64), vals)


def test_u64_sharded_read_planes(tmp_path, rng):
    vals = np.sort(_u64(rng, (32, 1024), hi_bits=30), axis=1)
    path = str(tmp_path / "m.flt")
    fio.write_file(path, vals.reshape(-1), dtype="u64", chunk_blocks=16)
    mesh = pmesh.make_mesh(8)
    out = fio_device.read_file_device(path, mesh=mesh)
    assert isinstance(out, LimbPlanes)
    np.testing.assert_array_equal(out.to_u64(), vals.reshape(-1))


def test_sharded_unpack_planes_matches(rng):
    vals = _u64(rng, (16, 1024), hi_bits=20)
    packed = np.asarray(bitpack.pack(LimbPlanes.from_u64(vals).interleaved(),
                                     21, "u64"))
    mesh = pmesh.make_mesh(8)
    lo, hi = psh.sharded_unpack(mesh, packed, 21, "u64", planes=True)
    img = np.asarray(psh.sharded_unpack(mesh, packed, 21, "u64"))
    np.testing.assert_array_equal(np.asarray(lo), img[..., 0])
    np.testing.assert_array_equal(np.asarray(hi), img[..., 1])


def test_kernel_interpret_planes(rng):
    """The public unpack and fused delta entries honor the (lo, hi) plane
    form."""
    from fastlanes_tpu import kernels

    vals = _u64(rng, (8, 1024), hi_bits=20)
    packed = np.asarray(bitpack.pack(LimbPlanes.from_u64(vals).interleaved(),
                                     21, "u64"))
    lo, hi = kernels.unpack(packed, 21, "u64", planes=True)
    img = LimbPlanes.from_u64(vals).interleaved()
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(img[..., 0]))
    np.testing.assert_array_equal(np.asarray(hi), np.asarray(img[..., 1]))
    # planes and the interleaved image of the fused delta decode agree
    base = np.zeros((16, 2), np.uint32)
    lo, hi = kernels.undelta_pack(packed, base, 21, "u64", planes=True)
    img = np.asarray(kernels.undelta_pack(packed, base, 21, "u64"))
    np.testing.assert_array_equal(np.asarray(lo), img[..., 0])
    np.testing.assert_array_equal(np.asarray(hi), img[..., 1])
