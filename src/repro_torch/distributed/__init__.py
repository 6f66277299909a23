"""The port's ``repro.distributed``: gradient compression so far (the
sharding rules, SP and PP come with the distributed slice)."""

from .compression import (EFCompressor, EFState, compress_tree_int8,
                          ef_compress, ef_init)

__all__ = ["EFCompressor", "EFState", "compress_tree_int8", "ef_compress",
           "ef_init"]
