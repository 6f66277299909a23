"""The sharded train step's model-axis split for reduced qwen2-72b
(``qkv_bias``) on 8 gloo ranks (CPU), against the reference's jitted
sharded step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py), on (2, 4), (4, 2) and (1, 8)
(tests/_torch_dist_train.py::tp_suite). The biases of ``wq``, ``wk``,
``wv`` split with their kernels' columns at tp = 2 and 4; at tp = 8 they
are gathered whole with them."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("qwen2-72b")
