"""The sharded train step's model-axis split for reduced qwen2-vl-7b
(M-RoPE, ``embeddings=`` in place of tokens) on 8 gloo ranks (CPU),
against the reference's jitted sharded step on 8 fake devices, at the
train-step tests' bounds (tests/_torch_train.py), on (2, 4), (4, 2) and
(1, 8) (tests/_torch_dist_train.py::tp_suite). The inputs are
embeddings, so the vocab-parallel table is used only by the logits; the
three M-RoPE position streams are cut with the query sequence at tp = 8."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("qwen2-vl-7b")
