"""The port's ``repro.distributed`` on ``torch.distributed``: the
collectives (``compat``), the sharding rules, the placement of tensors
by them and each parameter's compute split over the "model" axis
(``sharding``), the tensor-parallel operators of that split (``tp``),
sequence-parallel decode attention (``sp``), GPipe pipelining (``pp``)
and int8 gradient compression (``compression``).  The sharded train
step is ``train.step.make_train_step(..., mesh=)``."""

from .compat import (all_gather, axis_index, init_distributed, pmax,
                     ppermute, psum)
from .compression import (EFCompressor, EFState, compress_tree_int8,
                          ef_compress, ef_init)
from .pp import pipeline_apply
from .sharding import (Sharded, attention_split, axis_size, batch_shardings,
                       cache_shardings, compute_split, dp_axes, local_slice,
                       param_shardings, param_spec, unshard)
from .sp import make_sp_decode, sp_decode_attention

__all__ = ["EFCompressor", "EFState", "compress_tree_int8", "ef_compress",
           "ef_init", "init_distributed", "psum", "pmax", "all_gather",
           "ppermute", "axis_index", "param_spec", "param_shardings",
           "batch_shardings", "cache_shardings", "axis_size", "dp_axes",
           "local_slice", "unshard", "Sharded", "compute_split",
           "attention_split", "sp_decode_attention",
           "make_sp_decode", "pipeline_apply"]
