"""The sharded train step's model-axis split for reduced xlstm-1.3b (mLSTM
/ sLSTM) on 8 gloo ranks (CPU), against the reference's jitted sharded
step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py) (gradients and grad_norm at ``XLSTM_GRAD_TOL``),
on (2, 4), (4, 2) and (1, 8) (tests/_torch_dist_train.py::tp_suite).
Only the embedding and the logits split; the mLSTM and sLSTM cells
compute whole on every model rank."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite(
    "xlstm-1.3b", grad_tol=T.XLSTM_GRAD_TOL, norm_tol=T.XLSTM_GRAD_TOL)
