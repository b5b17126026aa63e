"""fastlanes_tpu — a JAX FastLanes lightweight-compression framework.

A from-scratch JAX/XLA implementation of the FastLanes compression
layout (Afroozeh & Boncz, VLDB 2023) with the full capability surface of the
Rust reference crate (spiraldb/fastlanes v0.1.8): fixed-width bit-packing,
Delta, frame-of-reference (FFoR) and the 04261537 interleaved transpose over
1024-value blocks of u8/u16/u32/u64 — bit-compatible with the Rust crate's
(transposed-order) wire format — plus new surface: batched jit ops,
runtime-width dispatch, sharded multi-device / multi-host execution over a
jax.sharding.Mesh, compressed files and queries over them, and a C++
host-side codec.

Layer map (mirrors SURVEY.md §1/§7):
  core/      layout spec: FL_ORDER, index maps, inverse tables   (L0)
  ref/       NumPy oracle, slow-but-exact                        (conformance)
  ops/       pure-jnp XLA ops, batched + jittable                (L1-L2)
  kernels/   public codec entries, routed per device kind        (L2 API)
  models/    composed codecs (BitPacked/Delta/FFoR/auto)         (L3 API)
  parallel/  mesh + shard_map distribution, multi-host           (new surface)
  native/    C++ host codec (ctypes), independent oracle + IO    (host runtime)
"""

__version__ = "0.1.0"

from .core import layout
from .core.layout import BLOCK, DTYPES, FL_ORDER, bit_width, lanes, packed_len

__all__ = [
    "layout", "BLOCK", "DTYPES", "FL_ORDER", "bit_width", "lanes", "packed_len",
    "pack", "pack_map", "unpack", "unpack_single", "delta", "undelta", "undelta_pack",
    "delta_pack", "for_pack", "unfor_pack", "transpose", "untranspose",
    "unchecked_pack", "unchecked_unpack", "unchecked_unpack_single",
    "auto_encode", "get_codec", "write_file", "read_file", "read_blocks",
    "read_single", "scan_column", "count_where", "scan_table", "scan_where",
    "scan_where_multi", "group_stats", "distinct", "value_counts", "top_k",
    "select", "join", "quantile", "median", "write_table", "read_table",
    "read_column", "TableWriter", "StringColumn", "LimbPlanes", "__version__",
]


# name -> owning submodule for the lazy re-exports (the reference's
# `pub use ...::*`, lib.rs:17-20); only the owner is imported, so host-only
# IO names never pull in jax.
_API_HOME = {
    **{n: "ops.bitpack" for n in ("pack", "pack_map", "unpack")},
    "unpack_single": "ops.single",
    **{n: "ops.delta" for n in ("delta", "undelta", "undelta_pack", "delta_pack")},
    **{n: "ops.ffor" for n in ("for_pack", "unfor_pack")},
    **{n: "ops.transpose" for n in ("transpose", "untranspose")},
    **{n: "ops.dispatch" for n in ("unchecked_pack", "unchecked_unpack",
                                   "unchecked_unpack_single")},
    **{n: "models.codecs" for n in ("auto_encode", "get_codec")},
    **{n: "fio" for n in ("write_file", "read_file", "read_blocks", "read_single")},
    **{n: "fio_table" for n in ("write_table", "read_table", "read_column",
                                "TableWriter", "StringColumn")},
    **{n: "analytics" for n in (
        "scan_column", "count_where", "scan_table", "scan_where",
        "scan_where_multi", "group_stats", "distinct", "value_counts",
        "top_k", "select", "join", "quantile", "median")},
    "LimbPlanes": "limbs",
}


def __getattr__(name):
    home = _API_HOME.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f".{home}", __name__), name)
