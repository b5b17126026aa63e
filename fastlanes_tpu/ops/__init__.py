"""Pure-jnp XLA ops: batched, jit-traceable codec kernels (CPU and GPU).

The mid-tier of the framework: exact FastLanes semantics expressed as static
shift/mask DAGs XLA fuses into memory-bound passes. `fastlanes_tpu.kernels`
holds the routed public entries with the same signatures."""

from . import _engine, bitpack, delta, dispatch, ffor, single, transpose
from .bitpack import pack, unpack, unpack_planes
from .delta import delta as delta_encode
from .delta import delta_pack, undelta, undelta_pack
from .ffor import for_pack, unfor_pack
from .single import unpack_single
from .transpose import transpose as transpose_blocks
from .transpose import untranspose as untranspose_blocks
from .dispatch import unchecked_pack, unchecked_unpack, unchecked_unpack_single

__all__ = [
    "_engine", "bitpack", "delta", "dispatch", "ffor", "single", "transpose",
    "pack", "unpack", "unpack_planes", "delta_encode", "delta_pack", "undelta", "undelta_pack",
    "for_pack", "unfor_pack", "unpack_single", "transpose_blocks",
    "untranspose_blocks", "unchecked_pack", "unchecked_unpack",
    "unchecked_unpack_single",
]
