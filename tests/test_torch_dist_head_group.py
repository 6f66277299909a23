"""Reduced xlstm's mixers on eight gloo ranks (CPU) with a model axis of
8, twice its 4 heads (``models.xlstm``, ``distributed.tp.HeadGroup``,
``sharding.compute_split``): each head runs on a group of two model
ranks; each rank selects its head's columns of the whole ``wq`` / ``wk``
/ ``w_gates`` (and bias), ``wx`` (and bias) and its head's block of
``r``, and computes with its own model shards of the mLSTM's ``wv`` /
``wz`` / norm / ``wo`` and the sLSTM's norm / ``wo``, its half of its
head's channels (``tests/_torch_dist.py::head_group``):

* the mLSTM's and the sLSTM's forward within 1e-6 of the one-process
  forward's scale, and the sLSTM's gradients (the input's and each
  leaf's, the split leaves' gathered whole over "model") within 1e-6 of
  each one's max;
* the mLSTM, the sLSTM and their whole super-block against the same
  one-process computation in f64: the forward's and the worst
  gradient's gap no more than twice the one-process f32's own (the
  xlstm train-step tests' rule; the mLSTM's gate bias gradient sums
  64 positions' terms that cancel, and there the one-process f32 sits
  1.7e-6 of the max from f64 and the split 2.8e-6, 1.5e-6 from each
  other);
* every run above takes the one-process f64 run's side of each mLSTM
  readout's normaliser kink;
* the leaves a rank computes with: the head-group leaves whole, the
  channel leaves at 1/8 of their whole;
* each rank's forward matmul FLOPs equal to the count from the shapes,
  one head's ``q`` / ``k`` / gates and recurrence, ``hd / 2`` of its v
  channels (with the normaliser's ones channel) in the scan, and
  ``1/8`` of ``wv`` / ``wz`` / ``wo``; and the one process's equal to
  its own count.

One spawn of eight ranks.
"""

import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.distributed.sharding import SELECT, SPLIT

SHAPE, B, L = (1, 8), 2, 32
TOL = 1e-6
UNITS = ("mlstm", "slstm", "block")
GROUP_LEAVES = {"wq.kernel", "wk.kernel", "w_gates.kernel", "w_gates.bias",
                "wx.kernel", "wx.bias", "r"}
CHANNEL_LEAVES = {"wv.kernel", "wz.kernel", "norm.scale", "wo.kernel"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("head_group", 8, tmp_path_factory.mktemp("head_group"),
                     SHAPE, B, L)


def _gap(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("unit", ["mlstm", "slstm"])
def test_forward_holds_against_one_process(ranks, unit):
    for r in ranks:
        assert _gap(r[unit]["got"][0], r[unit]["want"][0]) <= TOL


def test_slstm_gradients_hold_against_one_process(ranks):
    for r in ranks:
        (_, gx, grads), (_, gx1, grads1) = r["slstm"]["got"], \
            r["slstm"]["want"]
        assert _gap(gx, gx1) <= TOL
        assert set(grads) == set(grads1)
        for n, g in grads.items():
            assert _gap(g, grads1[n]) <= TOL, n


def _gaps_from_f64(run, f64):
    """The forward's, the input gradient's and the worst leaf gradient's
    gaps of ``run`` from the f64 ``f64``."""
    (y, gx, grads), (y64, gx64, grads64) = run, f64
    assert set(grads) == set(grads64)
    return (_gap(y, y64), _gap(gx, gx64),
            max(_gap(g, grads64[n]) for n, g in grads.items()))


@pytest.mark.parametrize("unit", UNITS)
def test_as_close_to_f64_as_the_one_process_step(ranks, unit):
    for r in ranks:
        split = _gaps_from_f64(r[unit]["got"], r[unit]["f64"])
        one = _gaps_from_f64(r[unit]["want"], r[unit]["f64"])
        for got, bound in zip(split, one):
            assert got <= 2 * bound, (split, one)


@pytest.mark.parametrize("unit", UNITS)
def test_each_rank_computes_with_its_head_group_leaves(ranks, unit):
    tp = SHAPE[1]
    for r in ranks:
        res = r[unit]
        mixer = [n for n in res["split"] if ".ln." not in n
                 and not n.startswith("ln.")]
        assert mixer
        for n in mixer:
            leaf = n.split("core.", 1)[-1]
            whole, local = res["whole"][n], res["local"][n]
            if leaf in CHANNEL_LEAVES:
                assert res["split"][n] == SPLIT, n
                assert np.prod(local) * tp == np.prod(whole), n
            else:
                assert leaf in GROUP_LEAVES, n
                assert res["split"][n] == SELECT, n
                assert local == whole, n


def _scan_flops(b, L, p, n, chunk=256):
    """``models.ssm.ssd_chunked``'s matmul FLOPs on ``b`` sequences of
    one head, ``p`` channels and ``n`` key dimensions."""
    q = min(chunk, L)
    c = L // q
    return 2 * b * (c * q * q * n + c * q * q * p + c * q * p * n
                    + (c + 1) * (c + 1) * p * n + c * q * n * p)


def _count(unit, heads, g):
    """The forward matmul FLOPs of ``unit`` on ``heads`` heads of which a
    rank owns ``1/g`` of the channels (``heads`` 4 and ``g`` 1: one
    process)."""
    cfg = reduced(get_config("xlstm-1.3b"))
    d, hd, T = cfg.d_model, cfg.head_dim_, B * L
    hb = d // cfg.n_heads
    mlstm = (2 * T * d * heads * hd * 2 + 2 * T * d * 2 * heads
             + 2 * T * d * heads * hd // g * 2 + 2 * T * heads * hd // g * d
             + _scan_flops(B * heads, L, hd // g + 1, hd))
    slstm = (2 * T * d * 4 * heads * hb + 2 * T * heads * hb * 4 * hb
             + 2 * T * heads * hb // g * d)
    if unit == "mlstm":
        return mlstm
    if unit == "slstm":
        return slstm
    return cfg.mlstm_slstm_pattern * mlstm + slstm


@pytest.mark.parametrize("unit", UNITS)
def test_each_rank_does_the_flops_counted_from_the_shapes(ranks, unit):
    cfg = reduced(get_config("xlstm-1.3b"))
    g = SHAPE[1] // cfg.n_heads
    for r in ranks:
        assert r[unit]["flops_one"] == _count(unit, cfg.n_heads, 1)
        assert r[unit]["flops_rank"] == _count(unit, 1, g)
    share = ranks[0][unit]["flops_rank"] / ranks[0][unit]["flops_one"]
    assert 1 / SHAPE[1] < share < 1 / cfg.n_heads
