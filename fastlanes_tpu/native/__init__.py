"""ctypes loader for the C++ host codec (builds lazily with g++).

The native library is the host-runtime complement of the device compute
path: data loaders / IO pipelines encode-decode on CPU at SIMD speed while
the accelerator decodes. It is also used in tests as an implementation
independent of the NumPy oracle."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ..core import layout

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastlanes_native.cpp")
_LIB = os.path.join(_HERE, "libfastlanes_native.so")

_DTYPE_CODE = {"u8": 0, "u16": 1, "u32": 2, "u64": 3}

_lock = threading.Lock()
_lib = None


class NativeUnavailable(RuntimeError):
    pass


def build(force: bool = False) -> str:
    """Compile the shared library if missing or stale. Returns its path."""
    with _lock:
        if (not force and os.path.exists(_LIB)
                and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
            return _LIB
        cmd = [
            "g++", "-O3", "-march=native", "-funroll-loops", "-std=c++17",
            "-shared", "-fPIC", "-o", _LIB, _SRC,
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            detail = getattr(e, "stderr", str(e))
            raise NativeUnavailable(f"failed to build native codec: {detail}") from e
        return _LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    lib = ctypes.CDLL(path)
    c = ctypes.c_void_p
    lib.fl_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_unpack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_for_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, ctypes.c_ulonglong, c, ctypes.c_long]
    lib.fl_unfor_pack.argtypes = [ctypes.c_int, ctypes.c_int, c,
                                  ctypes.c_ulonglong, c, ctypes.c_long]
    lib.fl_delta.argtypes = [ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_undelta.argtypes = [ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_delta_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_undelta_pack.argtypes = [ctypes.c_int, ctypes.c_int, c, c, c, ctypes.c_long]
    lib.fl_transpose.argtypes = [ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_untranspose.argtypes = [ctypes.c_int, c, c, ctypes.c_long]
    lib.fl_unpack_single.argtypes = [ctypes.c_int, ctypes.c_int, c, c,
                                     ctypes.c_long, c, ctypes.c_long]
    for fn in ("fl_pack", "fl_unpack", "fl_for_pack", "fl_unfor_pack", "fl_delta",
               "fl_undelta", "fl_delta_pack", "fl_undelta_pack", "fl_transpose",
               "fl_untranspose", "fl_unpack_single"):
        getattr(lib, fn).restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    try:
        _load()
        return True
    except (NativeUnavailable, OSError):
        # OSError: corrupt / wrong-architecture .so from an interrupted or
        # foreign build — fall back to the NumPy oracle rather than crash.
        return False


def _prep(arr, dtype, last_dim):
    dt = layout.np_dtype(dtype)
    a = np.ascontiguousarray(arr, dtype=dt)
    if a.ndim == 1:
        a = a[None]
    if a.ndim != 2 or a.shape[1] != last_dim:
        raise ValueError(f"expected shape (B, {last_dim}), got {a.shape}")
    return a


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(rc):
    if rc != 0:
        raise ValueError(f"native codec error {rc} (bad width or dtype)")



def aligned_empty(shape, np_dt, align=64):
    """np.empty whose data pointer is `align`-byte aligned — required for
    the native library's non-temporal streaming-store decode path (full
    cache-line stores, no read-for-ownership)."""
    np_dt = np.dtype(np_dt)
    nbytes = int(np.prod(shape)) * np_dt.itemsize
    raw = np.empty(nbytes + align, np.uint8)
    off = (-raw.ctypes.data) % align
    return raw[off:off + nbytes].view(np_dt).reshape(shape)


def _out_buf(out, shape, dtype):
    """Use the caller's preallocated output when given (IO pipelines reuse
    buffers — a fresh np.empty per call page-faults its whole extent, which
    can cost more than the decode itself); else allocate (64B-aligned, so
    large decodes take the non-temporal store path)."""
    np_dt = layout.np_dtype(dtype)
    if out is None:
        return aligned_empty(shape, np_dt)
    if (not isinstance(out, np.ndarray) or out.dtype != np_dt
            or out.shape != shape or not out.flags.c_contiguous):
        raise ValueError(
            f"out must be a C-contiguous {np_dt} array of shape {shape}")
    return out


def pack(values, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    out = _out_buf(out, (v.shape[0], layout.packed_len(dtype, width)), dtype)
    _check(lib.fl_pack(_DTYPE_CODE[dtype], width, _ptr(v), _ptr(out), v.shape[0]))
    return out


def unpack(packed, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    out = _out_buf(out, (p.shape[0], layout.BLOCK), dtype)
    _check(lib.fl_unpack(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(out), p.shape[0]))
    return out


def for_pack(values, reference, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty((v.shape[0], layout.packed_len(dtype, width)), layout.np_dtype(dtype))
    _check(lib.fl_for_pack(_DTYPE_CODE[dtype], width, _ptr(v), int(reference),
                           _ptr(out), v.shape[0]))
    return out


def unfor_pack(packed, reference, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    out = aligned_empty((p.shape[0], layout.BLOCK), layout.np_dtype(dtype))
    _check(lib.fl_unfor_pack(_DTYPE_CODE[dtype], width, _ptr(p), int(reference),
                             _ptr(out), p.shape[0]))
    return out


def _prep_base(base, dtype, n_blocks):
    nl = layout.lanes(dtype)
    b = np.ascontiguousarray(base, dtype=layout.np_dtype(dtype))
    if b.ndim == 1:
        b = np.broadcast_to(b[None], (n_blocks, nl))
        b = np.ascontiguousarray(b)
    if b.shape != (n_blocks, nl):
        raise ValueError(f"base must be ({n_blocks}, {nl}), got {b.shape}")
    return b


def delta(values, base, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty_like(v)
    _check(lib.fl_delta(_DTYPE_CODE[dtype], _ptr(v), _ptr(bs), _ptr(out), v.shape[0]))
    return out


def undelta(values, base, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty_like(v)
    _check(lib.fl_undelta(_DTYPE_CODE[dtype], _ptr(v), _ptr(bs), _ptr(out), v.shape[0]))
    return out


def delta_pack(values, base, width, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    bs = _prep_base(base, dtype, v.shape[0])
    out = np.empty((v.shape[0], layout.packed_len(dtype, width)), layout.np_dtype(dtype))
    _check(lib.fl_delta_pack(_DTYPE_CODE[dtype], width, _ptr(v), _ptr(bs), _ptr(out), v.shape[0]))
    return out


def undelta_pack(packed, base, width, dtype, out=None):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    bs = _prep_base(base, dtype, p.shape[0])
    out = _out_buf(out, (p.shape[0], layout.BLOCK), dtype)
    _check(lib.fl_undelta_pack(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(bs), _ptr(out), p.shape[0]))
    return out


def transpose(values, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty_like(v)
    _check(lib.fl_transpose(_DTYPE_CODE[dtype], _ptr(v), _ptr(out), v.shape[0]))
    return out


def untranspose(values, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    v = _prep(values, dtype, layout.BLOCK)
    out = np.empty_like(v)
    _check(lib.fl_untranspose(_DTYPE_CODE[dtype], _ptr(v), _ptr(out), v.shape[0]))
    return out


def unpack_single(packed, width, index, dtype):
    dtype = layout.canon_dtype(dtype)
    lib = _load()
    p = _prep(packed, dtype, layout.packed_len(dtype, width))
    idx = np.ascontiguousarray(np.atleast_1d(index), dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= layout.BLOCK):
        # the C side indexes raw buffers — bad indices would read OOB
        raise IndexError(f"element index out of range [0, {layout.BLOCK})")
    out = np.empty((p.shape[0], idx.shape[0]), layout.np_dtype(dtype))
    _check(lib.fl_unpack_single(_DTYPE_CODE[dtype], width, _ptr(p), _ptr(idx),
                                idx.shape[0], _ptr(out), p.shape[0]))
    return out
