"""The sharded train step's model-axis split for reduced xlstm-1.3b (mLSTM
/ sLSTM) on 8 gloo ranks (CPU), against the reference's jitted sharded
step on 8 fake devices, at the train-step tests' bounds
(tests/_torch_train.py) (gradients and grad_norm at ``XLSTM_GRAD_TOL``),
on (2, 4), (4, 2) and (1, 8) (tests/_torch_dist_train.py::tp_suite).
The embedding and the logits split, and the mLSTM and sLSTM cells by
head where tp divides their 4 heads (2 and 4): ``wq`` / ``wk`` / ``wv``
/ ``wz`` / ``w_gates`` column-, ``wo`` row-parallel, the norms over the
ranks' parts, sLSTM's ``wx`` and ``r`` gathered whole and each rank's
heads selected; each rank's mLSTM scan and sLSTM step run on ``4 / tp``
heads.  On (1, 8) each head runs on a group of two model ranks: each
computes its head's ``q`` / ``k`` / gates from the gathered ``wq`` /
``wk`` / ``w_gates`` and its sLSTM recurrence whole, and its half of
the head's ``v`` / ``z`` channels, norm and ``wo`` rows from its own
shards: one head a rank, the mLSTM scan on 8 of the head's 16 v
channels (``hold_split``)."""

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

(runs, test_metrics, test_gradients, test_moments, test_update,
 test_replicas_hold_the_same_bits,
 test_each_rank_computes_its_share) = T.tp_suite(
    "xlstm-1.3b", grad_tol=T.XLSTM_GRAD_TOL, norm_tol=T.XLSTM_GRAD_TOL)
