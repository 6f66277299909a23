"""The sharded train step for reduced olmoe-1b-7b on 8 gloo ranks (CPU)
against the reference's jitted sharded step on 8 fake devices, as
tests/test_torch_dist_train.py holds minitron-4b
(tests/_torch_dist_train.py).  On this batch the reference's routing
drops assignments in both MoE layers (capacity over all 256 tokens); a
step that routed each data rank's 128 tokens on its own would drop
others, and fails these tests."""

import pytest

import _torch_dist_train as T
from _torch_train import torch_one_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return T.run(tmp_path_factory.mktemp("dist_train_moe"), "olmoe-1b-7b")


def test_reference_drops_on_this_batch(runs):
    drops = runs[0]["drops"]
    assert len(drops) == 2 and (drops > 0).all()


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
