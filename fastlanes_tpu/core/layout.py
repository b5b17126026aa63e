"""FastLanes layout core: the 04261537 interleaved order, index maps, inverse tables.

This is the pure-Python/NumPy *specification* of the FastLanes transposed layout
(Afroozeh & Boncz, VLDB 2023). Every other module (NumPy oracle, jnp ops,
kernels, C++ host codec) is tested against the functions here.

Reference parity (spiraldb/fastlanes, Rust crate v0.1.8):
  - FL_ORDER                  <- reference src/lib.rs:22
  - T / LANES per dtype       <- reference src/lib.rs:24-32
  - index(row, lane)          <- reference src/macros.rs:20-24 (duplicated 46-50, 112-116)
  - transpose_index(idx)      <- reference src/transpose.rs:29-36
  - lanes_by_index/rows_by_index inverse tables
                              <- reference src/bitpacking.rs:207-232
  - packed length 1024*W/T    <- reference src/bitpacking.rs:19, 77

Structural facts derived from the layout (and verified by tests):

  * A 1024-value block reshaped to (8, 128):
    ``index(row, lane) = (row % 8) * 128 + (FL_ORDER[row // 8] * 16 + lane)``,
    so the transposed-order row (row, 0..LANES) is a *contiguous* slice
    ``flat[(row % 8) * 128 + off : ... + LANES]`` with
    ``off = FL_ORDER[row // 8] * 16``. No gathers are ever needed:
    pack/unpack/delta become static lane slices + shifts/masks.

  * The per-dtype row offsets ``FL_ORDER[o] * 16`` for o in [0, T/8) are
    exactly the multiples of LANES covering [0, 128): the (row, lane) -> flat
    map is a bijection tile-by-tile.
"""

from __future__ import annotations

import functools

import numpy as np

# The FastLanes 04261537 tile order. Self-inverse permutation of 8
# (reference src/lib.rs:22, test lib.rs:53-59).
FL_ORDER = (0, 4, 2, 6, 1, 5, 3, 7)

#: Block size in values — the "virtual 1024-bit SIMD register".
BLOCK = 1024

#: Supported element dtypes (unsigned only, like the reference lib.rs:29-32).
DTYPES = ("u8", "u16", "u32", "u64")

_NP_DTYPE = {
    "u8": np.uint8,
    "u16": np.uint16,
    "u32": np.uint32,
    "u64": np.uint64,
}

_CANON = {
    "u8": "u8", "uint8": "u8",
    "u16": "u16", "uint16": "u16",
    "u32": "u32", "uint32": "u32",
    "u64": "u64", "uint64": "u64",
}


def canon_dtype(dtype) -> str:
    """Canonicalize a dtype spec ('u32', 'uint32', np.uint32, jnp.uint32) -> 'u32'."""
    if isinstance(dtype, str):
        key = dtype
    else:
        key = np.dtype(dtype).name
    try:
        return _CANON[key]
    except KeyError:
        raise ValueError(f"unsupported FastLanes dtype: {dtype!r} (want one of {DTYPES})") from None


def np_dtype(dtype) -> np.dtype:
    return np.dtype(_NP_DTYPE[canon_dtype(dtype)])


def bit_width(dtype) -> int:
    """T: the element bit width (reference lib.rs:25)."""
    return np_dtype(dtype).itemsize * 8


def lanes(dtype) -> int:
    """LANES = 1024 / T (reference lib.rs:26)."""
    return BLOCK // bit_width(dtype)


def check_width(dtype, width: int) -> int:
    """Runtime equivalent of the reference's const-generic width proof
    (``Pred<{W <= T}>: Satisfied``, reference src/lib.rs:34-38 /
    src/bitpacking.rs:8-13). Raises ValueError outside [0, T]."""
    t = bit_width(dtype)
    if not 0 <= width <= t:
        raise ValueError(
            f"width {width} not supported for {canon_dtype(dtype)} (need 0 <= W <= {t})")
    return width


def packed_len(dtype, width: int) -> int:
    """Number of packed *elements* (of the same dtype) per 1024-value block:
    1024 * W / T (reference src/bitpacking.rs:19)."""
    check_width(dtype, width)
    return BLOCK * width // bit_width(dtype)


def index(row: int, lane: int, dtype=None) -> int:
    """Transposed-order index map (reference src/macros.rs:20-24).

    Maps (row, lane) of the virtual (T, LANES) matrix to the position in the
    flat transposed 1024-vector. Bijective on [0, 1024) for each dtype's
    (T, LANES) split.
    """
    o = row // 8
    s = row % 8
    return FL_ORDER[o] * 16 + s * 128 + lane


def row_offset(row: int) -> int:
    """Start of transposed row `row` inside the (8,128) view: the row occupies
    flat[(row%8)*128 + off : +LANES] with off = FL_ORDER[row//8]*16."""
    return (row % 8) * 128 + FL_ORDER[row // 8] * 16


def transpose_index(idx: int) -> int:
    """The Transpose codec's index map (reference src/transpose.rs:29-36):
    ``transpose(idx) = (idx % 16) * 64 + FL_ORDER[(idx / 16) % 8] * 8 + idx / 128``.
    Bijective but NOT self-inverse."""
    lane = idx % 16
    order = (idx // 16) % 8
    row = idx // 128
    return lane * 64 + FL_ORDER[order] * 8 + row


@functools.lru_cache(maxsize=None)
def transpose_perm() -> np.ndarray:
    """perm with out[i] = in[perm[i]] for Transpose::transpose (transpose.rs:11-15)."""
    return np.array([transpose_index(i) for i in range(BLOCK)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def untranspose_perm() -> np.ndarray:
    """perm with out[i] = in[perm[i]] for Transpose::untranspose (transpose.rs:18-22),
    i.e. the inverse permutation of transpose_perm."""
    p = transpose_perm()
    inv = np.empty_like(p)
    inv[p] = np.arange(BLOCK, dtype=np.int32)
    return inv


@functools.lru_cache(maxsize=None)
def lanes_by_index(dtype) -> np.ndarray:
    """LANES table: lane of each flat transposed index (reference bitpacking.rs:207-213)."""
    nl = lanes(dtype)
    return (np.arange(BLOCK) % nl).astype(np.int32)


@functools.lru_cache(maxsize=None)
def rows_by_index(dtype) -> np.ndarray:
    """ROWS table: row of each flat transposed index (reference bitpacking.rs:216-232).
    Uses FL_ORDER being its own inverse."""
    dtype = canon_dtype(dtype)
    nl = lanes(dtype)
    i = np.arange(BLOCK)
    lane = i % nl
    s = i // 128
    fl_order = (i - s * 128 - lane) // 16
    o = np.array(FL_ORDER)[fl_order]
    return (o * 8 + s).astype(np.int32)


@functools.lru_cache(maxsize=None)
def index_table(dtype) -> np.ndarray:
    """(T, LANES) table of index(row, lane) — forward map as an array."""
    t, nl = bit_width(dtype), lanes(dtype)
    return np.array([[index(r, l) for l in range(nl)] for r in range(t)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def row_order_by_offset(dtype) -> tuple:
    """The o-block permutation used to assemble/disassemble the (8, 128) tile.

    Returns a tuple ``order`` of length T/8 such that the o-group whose lanes
    live at columns [k*LANES, (k+1)*LANES) of the (8,128) tile is
    ``order[k]``; i.e. sorted by FL_ORDER[o]*16.
    """
    t = bit_width(dtype)
    n_o = t // 8
    return tuple(sorted(range(n_o), key=lambda o: FL_ORDER[o]))


def validate_layout() -> None:
    """Self-checks mirroring the reference's invariants; raises on failure."""
    # FL_ORDER is self-inverse (lib.rs:53-59).
    for i in range(8):
        assert FL_ORDER[FL_ORDER[i]] == i
    for dt in DTYPES:
        t, nl = bit_width(dt), lanes(dt)
        seen = sorted(index(r, l) for r in range(t) for l in range(nl))
        assert seen == list(range(BLOCK)), f"index not a bijection for {dt}"
        # Inverse tables really invert index().
        lt, rt = lanes_by_index(dt), rows_by_index(dt)
        for r in range(t):
            for l in range(0, nl, max(1, nl // 8)):
                idx = index(r, l)
                assert lt[idx] == l and rt[idx] == r
    # transpose is a bijection and untranspose inverts it.
    p, q = transpose_perm(), untranspose_perm()
    assert sorted(p.tolist()) == list(range(BLOCK))
    assert np.array_equal(p[q], np.arange(BLOCK))
