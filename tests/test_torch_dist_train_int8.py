"""The sharded train step with the int8 gradient compression, reduced
minitron-4b on 8 gloo ranks (CPU), against the reference's jitted
compressed step under its shardings on 8 fake devices, as
tests/test_torch_dist_train.py holds the uncompressed one
(tests/_torch_dist_train.py).  The compression applies to the reduced
gradient, where the reference applies it: one scale a reference leaf of
the whole gradient, the same on every rank."""

import pytest

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("dist_train_int8"), "minitron-4b",
                 compress=True)


def test_metrics(runs):
    T.hold_metrics_all(*runs[:2])


def test_moments(runs):
    T.hold_moments(*runs[:2])


def test_update(runs):
    T.hold_update(*runs[:2])


def test_replicas_hold_the_same_bits(runs):
    T.hold_replicas(*runs[:2])


def test_one_rank_mesh_equals_the_plain_step(runs):
    T.hold_one_rank(runs[2])
