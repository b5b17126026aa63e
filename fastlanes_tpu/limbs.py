"""LimbPlanes: the device carrier for u64 column data.

u64 values live as two uint32 limb planes (lo, hi), so no path needs JAX's
process-global x64 mode. Two device layouts exist:

  * separate planes — two (..., ) uint32 arrays. The fast form: decode
    writes each plane with plain streaming stores;
  * interleaved image — one (..., 2) uint32 array, the exact byte image
    of a little-endian uint64 buffer. Interleaving costs a strided
    element shuffle.

This class makes the separate-plane form the DEFAULT device read result
 while keeping byte-image compatibility one call away:

    planes = fio_device.read_file_device("u64_col.flt")   # LimbPlanes
    planes.lo, planes.hi          # uint32 jax arrays, consume on device
    planes.interleaved()          # (..., 2) uint32 device image
    np.asarray(planes)            # (..., 2) uint32 HOST image (tests,
                                  # serialization — same bytes as before)
    planes.to_u64()               # host uint64 array

Reference parity note: the Rust crate's u64 impl is `impl_packing!(u64)`
(reference src/bitpacking.rs:234-237) — same semantics, scalar 64-bit
words; the limb split is this package's re-design (see ops/_engine.py).
"""

from __future__ import annotations

import numpy as np


class LimbPlanes:
    """A pair of equally-shaped uint32 arrays (lo, hi) representing u64
    values; supports slicing/reshape (applied to both planes) and
    conversion to the interleaved byte image."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo, hi):
        if tuple(lo.shape) != tuple(hi.shape):
            raise ValueError(
                f"limb planes must match in shape, got {lo.shape} vs {hi.shape}")
        self.lo = lo
        self.hi = hi

    # -- structure ---------------------------------------------------------

    @property
    def shape(self):
        return tuple(self.lo.shape)

    @property
    def ndim(self):
        return self.lo.ndim

    def __len__(self):
        return len(self.lo)

    def __getitem__(self, idx):
        return LimbPlanes(self.lo[idx], self.hi[idx])

    def reshape(self, *shape):
        return LimbPlanes(self.lo.reshape(*shape), self.hi.reshape(*shape))

    def __repr__(self):
        return f"LimbPlanes(shape={self.shape}, dtype=uint32x2)"

    # -- conversions -------------------------------------------------------

    def interleaved(self):
        """Device-side (..., 2) uint32 image — byte-compatible with a
        little-endian uint64 buffer. This is the op the plane form exists
        to avoid; call it only when the byte image is genuinely needed."""
        import jax.numpy as jnp

        return jnp.stack([self.lo, self.hi], axis=-1)

    def __array__(self, dtype=None, copy=None):
        """np.asarray(planes) -> the (..., 2) uint32 HOST image (the same
        bytes the interleaved device read used to return)."""
        out = np.stack([np.asarray(self.lo), np.asarray(self.hi)], axis=-1)
        if dtype is not None:
            out = out.astype(dtype, copy=False)
        return out

    def to_u64(self) -> np.ndarray:
        """Host uint64 array of the logical values."""
        return np.ascontiguousarray(self.__array__()).view(np.uint64)[..., 0]

    @classmethod
    def from_interleaved(cls, img):
        """(..., 2) uint32 image -> LimbPlanes (device or host array)."""
        return cls(img[..., 0], img[..., 1])

    @classmethod
    def from_u64(cls, arr):
        """Host uint64 array -> LimbPlanes of host uint32 views."""
        arr = np.ascontiguousarray(arr)
        img = arr.view(np.uint32).reshape(*arr.shape, 2)
        return cls(img[..., 0], img[..., 1])
