"""Public codec entry points: the XLA ops codecs, and the original-order
decodes routed to the formulation measured fastest on the running device
(see codecs.py and routing.py)."""

from . import codecs
from ..ops.bitpack import pack, pack_map, unpack
from ..ops.delta import delta_pack, undelta_pack, unzdelta_pack
from ..ops.ffor import for_pack, unfor_pack
from .codecs import (
    delta_pack_orig,
    undelta_pack_orig,
    unpack_orig,
    unzdelta_pack_orig,
    warmup,
)

__all__ = [
    "codecs", "pack", "pack_map", "unpack", "undelta_pack", "unzdelta_pack", "delta_pack",
    "for_pack", "unfor_pack", "warmup",
    "unpack_orig", "undelta_pack_orig", "unzdelta_pack_orig", "delta_pack_orig",
]
