"""The port's collectives, sequence-parallel decode and GPipe on 4 gloo
ranks (CPU), against the reference on 4 of 8 fake devices.

``compat``'s collectives on a live (2, 2) mesh against their numpy
definitions.  ``make_sp_decode`` at the reference test's sizes (``B, T,
H, KV, D = 2, 64, 8, 4, 16``, 50 valid slots, its seed): within 2e-5 of
the reference's ``make_sp_decode`` (the reference test's own tolerance)
and of dense attention over the whole cache.  ``pipeline_apply`` with the
reference test's 4 stages x 8 microbatches of ``tanh(x @ w)``: within
2e-4 of the reference's and of the stages applied in sequence.  Every
rank must return the same result.
"""

import numpy as np
import pytest

from _torch_dist import run_ranks, start_reference
from _torch_train import torch_one_thread  # noqa: F401  (autouse)

AXES = ("data", "model", ("data", "model"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp_pp")
    refs = {job: start_reference(job, tmp / f"{job}.npz")
            for job in ("sp", "pp")}
    out = {"collectives": run_ranks("collectives", 4, tmp)}
    for job, wait in refs.items():
        ref = wait()
        out[job] = (ref, run_ranks(job, 4, tmp, str(tmp / f"{job}.npz")))
    return out


def members(axes):
    """The ranks of each group of ``axes`` on the (2, 2) mesh, by rank."""
    if axes == "data":
        return {0: [0, 2], 1: [1, 3], 2: [0, 2], 3: [1, 3]}
    if axes == "model":
        return {0: [0, 1], 1: [0, 1], 2: [2, 3], 3: [2, 3]}
    return {r: [0, 1, 2, 3] for r in range(4)}


def test_mesh_coords_are_row_major(runs):
    ranks = runs["collectives"]
    assert [(r["coords"]["data"], r["coords"]["model"]) for r in ranks] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for i, r in enumerate(ranks):
        for axes, (index, group_rank) in r["index"].items():
            assert index == group_rank == members(axes)[i].index(i)


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_psum_and_pmax(runs, axes):
    ranks = runs["collectives"]
    for i, r in enumerate(ranks):
        xs = [ranks[j]["input"] for j in members(axes)[i]]
        np.testing.assert_array_equal(r[f"psum {axes}"], np.sum(xs, 0))
        np.testing.assert_array_equal(r[f"pmax {axes}"], np.max(xs, 0))


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_all_gather_concatenates_in_group_order(runs, axes):
    ranks = runs["collectives"]
    for i, r in enumerate(ranks):
        xs = [ranks[j]["input"] for j in members(axes)[i]]
        np.testing.assert_array_equal(r[f"gather0 {axes}"],
                                      np.concatenate(xs, 0))
        np.testing.assert_array_equal(r[f"gather1 {axes}"],
                                      np.concatenate(xs, 1))


@pytest.mark.parametrize("axes", AXES, ids=str)
def test_ppermute(runs, axes):
    """A ring ``i -> i+1 mod n`` and a single pair ``0 -> n-1`` (every
    other rank receives zeros), as ``jax.lax.ppermute``."""
    ranks = runs["collectives"]
    for i, r in enumerate(ranks):
        group = members(axes)[i]
        n, me = len(group), group.index(i)
        np.testing.assert_array_equal(
            r[f"ring {axes}"], ranks[group[(me - 1) % n]]["input"])
        want = ranks[group[0]]["input"] if me == n - 1 else \
            np.zeros_like(r["input"])
        np.testing.assert_array_equal(r[f"half {axes}"], want)


def test_collectives_are_counted(runs):
    stats = runs["collectives"][0]["stats"]
    assert stats["all_reduce"]["calls"] == 6
    assert stats["all_gather"]["calls"] == 6
    assert stats["ppermute"]["calls"] == 6
    assert stats["all_reduce"]["bytes"] == 6 * 6 * 4


def dense_attention(q, k, v, valid):
    """tests/test_distributed.py's dense reference, in numpy f64."""
    B, _, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, KV, H // KV, D).astype(np.float64)
    s = np.einsum("bkgd,btkd->bkgt", qg, k) / np.sqrt(D)
    s = np.where(valid[:, None, None, :], s, np.finfo(np.float32).min)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bkgt,btkd->bkgd", p, v).reshape(B, 1, H, D)


def test_sp_decode_matches_the_reference(runs):
    ref, ranks = runs["sp"]
    for out in ranks:
        np.testing.assert_allclose(out, ref["out"], rtol=2e-5, atol=2e-5)


def test_sp_decode_matches_dense(runs):
    ref, ranks = runs["sp"]
    want = dense_attention(ref["q"], ref["k"], ref["v"], ref["valid"])
    assert not ref["valid"].all()
    for out in ranks:
        np.testing.assert_allclose(out, want, rtol=2e-5, atol=2e-5)


def test_sp_decode_same_on_every_rank(runs):
    _, ranks = runs["sp"]
    for out in ranks[1:]:
        assert out.tobytes() == ranks[0].tobytes()


def test_pipeline_matches_the_reference(runs):
    ref, ranks = runs["pp"]
    for out in ranks:
        np.testing.assert_allclose(out, ref["out"], rtol=2e-4, atol=2e-4)


def test_pipeline_matches_sequential(runs):
    ref, ranks = runs["pp"]
    want = ref["x"].astype(np.float64)
    for w in ref["ws"]:
        want = np.tanh(want @ w)
    for out in ranks:
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)
        assert out.tobytes() == ranks[0].tobytes()


def test_sp_decode_refuses_a_cache_that_does_not_split():
    """A cache whose slots do not divide over the axis is refused, as the
    reference's ``shard_map`` refuses it (no slot is left out)."""
    from types import SimpleNamespace

    import torch
    from repro_torch.distributed import make_sp_decode

    mesh = SimpleNamespace(group=lambda axis: None,
                           axis_size=lambda axis: 4, index=lambda axis: 0)
    q = torch.zeros((2, 1, 8, 16))
    k = torch.zeros((2, 63, 4, 16))
    with pytest.raises(ValueError, match="does not split"):
        make_sp_decode(mesh)(q, k, k, torch.ones((2, 63), dtype=torch.bool))
