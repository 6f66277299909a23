"""The sharded train step's model-axis split for reduced whisper-medium
(encoder-decoder) on 8 gloo ranks (CPU), against the reference's jitted
sharded step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py), on (2, 4), (4, 2) and (1, 8)
(tests/_torch_dist_train.py::tp_suite). The encoder's self- attention,
the decoder's self- and cross-attention and both MLPs split; the logits
are the rank's block of the vocabulary."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite("whisper-medium")
