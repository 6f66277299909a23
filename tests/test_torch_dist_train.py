"""The sharded train step for reduced minitron-4b on 8 gloo ranks (CPU)
against the reference's jitted sharded step on 8 fake devices, at PR
22's bounds, with replicas bit-equal and a (1, 1) mesh equal to the
plain step bit for bit (tests/_torch_dist_train.py)."""

import pytest

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("dist_train"), "minitron-4b")


def test_metrics(runs):
    T.hold_metrics_all(*runs[:2])


def test_gradients(runs):
    T.hold_gradients(*runs[:2])


def test_moments(runs):
    T.hold_moments(*runs[:2])


def test_update(runs):
    T.hold_update(*runs[:2])


def test_replicas_hold_the_same_bits(runs):
    T.hold_replicas(*runs[:2])


def test_one_rank_mesh_equals_the_plain_step(runs):
    T.hold_one_rank(runs[2])
