"""Distribution layer: mesh builders + shard_map codec execution.

New surface (the reference crate is single-core SIMD only; see
SURVEY.md §2 parallelism disclosure): independent 1024-value blocks are
embarrassingly data-parallel, so the block axis shards over a 1-D device
mesh; per-batch scalars (FoR references, widths, delta bases) replicate;
packed outputs optionally all-gather in vector order."""

from .mesh import make_mesh, local_device_count, setup_distributed
from .shard import (
    all_gather_packed,
    global_max_bits,
    sharded_pack,
    sharded_unpack,
    sharded_undelta_pack,
    sharded_unzdelta_pack,
    sharded_unfor_pack,
    sharded_for_pack,
    sharded_roundtrip_check,
)

__all__ = [
    "make_mesh", "local_device_count", "setup_distributed",
    "sharded_pack", "sharded_unpack", "sharded_undelta_pack", "sharded_unzdelta_pack",
    "sharded_unfor_pack", "sharded_for_pack", "global_max_bits",
    "all_gather_packed", "sharded_roundtrip_check",
]
