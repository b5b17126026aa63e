"""Measured per-(op, dtype, width) path choice, keyed by device kind.

Several entries have more than one correct formulation (the output-domain
or composed original-order decodes and their encode duals; the W=T,
transpose and random-access relayouts), and which is fastest is a property
of the device. tools/tune_routing.py
races them on the device it runs on and writes one table per
`device_kind` into kernels/tables/. A table is used only on the device
kind it was measured on; with none for the running device every entry
takes the documented default below.
"""

from __future__ import annotations

import functools
import json
import os
import re

_TABLE_DIR = os.path.join(os.path.dirname(__file__), "tables")

_override = None  # test/tuning hook; see set_table()


def table_path(device_kind: str) -> str:
    """Where the table measured on `device_kind` lives."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", device_kind).strip("_")
    return os.path.join(_TABLE_DIR, f"{slug}.json")


def set_table(entries) -> None:
    """Override the routing table in-process (None restores the device's
    table). `entries` maps "op:dtype:width" -> {strategy: ips, ...}."""
    import sys

    global _override
    _override = entries
    _lookup.cache_clear()
    # strategy lookups and traced programs cached in consumer modules must
    # follow the table
    for mod_name, attr in (
            ("fastlanes_tpu.ops.bitpack", "_wt_strategy"),
            ("fastlanes_tpu.ops.bitpack", "_pack_wt_strategy"),
            ("fastlanes_tpu.ops.single", "_single_strategy"),
            ("fastlanes_tpu.ops.transpose", "_st_strategy"),
            ("fastlanes_tpu.fio_device", "_jitted_chunk_decode"),
            ("fastlanes_tpu.parallel.shard", "_build_sharded")):
        mod = sys.modules.get(mod_name)
        if mod is not None:
            getattr(mod, attr).cache_clear()


def _device_kind() -> str:
    import jax

    return jax.devices()[0].device_kind


def _entries():
    if _override is not None:
        return _override
    return load_table(_device_kind())


@functools.lru_cache(maxsize=None)
def load_table(device_kind: str) -> dict:
    """Entries of the table measured on `device_kind` ({} when none was);
    a file whose recorded kind differs is not used."""
    try:
        with open(table_path(device_kind)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}
    if doc.get("device_kind") != device_kind:
        return {}
    return doc.get("entries", {})


# Defaults for entries no table covers: the plain XLA paths. Original-order
# decodes take the flat one-pass 'gat' formulation (ops/orig.py), which
# needs no transposed image and no standalone untranspose.
_UNMEASURED_DEFAULT = {
    "unpack_orig": "gat",
    "undelta_pack_orig": "gat",
    "unzdelta_pack_orig": "gat",
    "unpack_wt": "assemble",  # the W=T relayout slots (ops/bitpack.py)
    "pack_wt": "assemble",
    "delta_pack_orig_enc": "od",  # encode duals (ops/orig.py)
    "zdelta_pack_orig_enc": "od",
    "transpose_st": "permute",    # standalone relayouts (ops/transpose.py)
    "untranspose_st": "permute",
    "unpack_single": "gather",    # dense-K random access (ops/single.py)
}

#: every execution strategy a table entry may name
_STRATEGIES = frozenset(("od", "gat", "rep", "compose", "assemble", "gather",
                         "grouptake", "permute", "decode", "bitrev", "axes"))


@functools.lru_cache(maxsize=None)
def _lookup(op: str, dtype: str, width: int):
    """Winner strategy for (op, dtype, width). The nearest measured width of
    the same (op, dtype) stands in for an unmeasured width (ties toward
    the lower width); ops with no entry take _UNMEASURED_DEFAULT."""
    if op not in _UNMEASURED_DEFAULT:
        raise ValueError(f"{op!r} has no routing slot; have "
                         f"{sorted(_UNMEASURED_DEFAULT)}")
    default = _UNMEASURED_DEFAULT[op]
    entries = _entries()
    exact = entries.get(f"{op}:{dtype}:{width}")
    if exact is None:
        prefix = f"{op}:{dtype}:"
        candidates = [int(key[len(prefix):]) for key in entries
                      if key.startswith(prefix)]
        if not candidates:
            return default
        nearest = min(candidates, key=lambda w: (abs(w - width), w))
        exact = entries[f"{op}:{dtype}:{nearest}"]
    best, best_v = default, -1.0
    for strat, ips in exact.items():
        # entries may carry metadata fields (blocks, K, ...) — only known
        # strategy names participate in the argmax
        if strat not in _STRATEGIES or not isinstance(ips, (int, float)):
            continue
        if ips > best_v:
            best, best_v = strat, float(ips)
    return best


def best_path(op: str, dtype: str, width: int) -> str:
    from ..core import layout

    return _lookup(op, layout.canon_dtype(dtype), int(width))
