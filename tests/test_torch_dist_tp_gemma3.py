"""The sharded train step's model-axis split for reduced gemma3-1b (one KV
head, the local window) on 8 gloo ranks (CPU), against the reference's
jitted sharded step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py), on (2, 4), (4, 2) and (1, 8)
(tests/_torch_dist_train.py::tp_suite). At tp = 2 and 4 the 4 heads
split (``wq`` column-, ``wo`` row-parallel) and the one KV head's ``wk``
/ ``wv`` are gathered whole, their gradients summed over the model
ranks; at tp = 8 the query sequence splits (32 tokens, 4 a rank) and K/V
are gathered."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("gemma3-1b")
