"""The sharded train step's model-axis split for reduced zamba2-2.7b
(Mamba2 hybrid) on 8 gloo ranks (CPU), against the reference's jitted
sharded step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py), on (2, 4), (4, 2) and (1, 8)
(tests/_torch_dist_train.py::tp_suite). The shared attention block, its
MLP and each super-block's LoRA (``lora_a`` column-, ``lora_b`` row-
parallel) split; the Mamba2 mixers compute whole on every model rank
(their packed projections do not split by head)."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("zamba2-2.7b")
