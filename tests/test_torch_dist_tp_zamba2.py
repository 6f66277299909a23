"""The sharded train step's model-axis split for reduced zamba2-2.7b
(Mamba2 hybrid) on 8 gloo ranks (CPU), against the reference's jitted
sharded step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py), on (2, 4), (4, 2) and (1, 8)
(tests/_torch_dist_train.py::tp_suite). The shared attention block, its
MLP and each super-block's LoRA (``lora_a`` column-, ``lora_b`` row-
parallel) split, and so do the Mamba2 mixers, by head (8 heads: on every
mesh): ``A_log``, ``D``, ``dt_bias``, the gated norm's gain and
``out_proj`` are each rank's model shards, ``in_proj`` and ``conv`` are
gathered whole and each rank selects its heads' columns; each rank's
SSD scan runs on ``8 / tp`` heads (``hold_split``)."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("zamba2-2.7b")
