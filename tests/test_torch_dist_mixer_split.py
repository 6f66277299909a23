"""The Mamba2, mLSTM and sLSTM mixers split by head over the model axis
(``models.ssm``, ``models.xlstm``, ``distributed.tp.select`` /
``tp.rms_norm``, ``sharding.compute_split``), on the CPU:

* the columns a rank selects of the packed leaves (Mamba2's ``in_proj``
  and ``conv``, sLSTM's ``wx`` and its bias, and ``r``) equal index sets
  written here in numpy from the reference's layouts
  (``src/repro/models/ssm.py:48``: ``[z | x | B | C | dt]``;
  ``src/repro/models/xlstm.py:150-169``: ``z|i|f|o`` blocks of ``d``,
  ``r`` ``(H, hb, 4 hb)``), at full width and reduced, for every tp that
  divides the heads;
* ``compute_split`` marks the head-aligned leaves ``SPLIT`` and the
  packed ones ``SELECT`` at full width (zamba2-2.7b on (2, 4) and 16 x
  16, xlstm-1.3b on (2, 4)), keeps every mixer whole where tp does not
  divide the heads (xlstm-1.3b's 4 on 16 x 16, reduced xlstm's 4 on
  (1, 8)) and in the decode, and raises for a leaf stored otherwise than
  it computes; a mixer handed whole weights under a model axis raises;
* on gloo ranks (two on (1, 2), four on (2, 2) and (1, 4)): the split
  RMS norm equals the whole norm within 1e-6, forward and gradients;
  each mixer's forward (within 1e-5 of its scale) and gradients (within
  the train-step tests' 1e-4 of each leaf's max) equal the one-process
  mixer's; a reduced sharded train step makes as many model-axis
  collective calls at 64 tokens as at 32 (the sLSTM loop runs none);
* reduced xlstm's super-block under a model axis of 8 computes whole,
  bit for bit the one-process block, on all 4 heads.

One spawn of two ranks and one of four: near 40 s alone.
"""

import numpy as np
import pytest
import torch

from _torch_dist import mesh_name, recording_heads, run_ranks
from _torch_train import GRAD_TOL, torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import param_shardings, tp
from repro_torch.distributed.sharding import (GATHER, REPLICATED, SELECT,
                                              SPLIT, compute_split)
from repro_torch.launch.mesh import Mesh
from repro_torch.models import ssm, xlstm
from repro_torch.models.transformer import (Decoder, _apply_super,
                                            init_decoder)

RANKS = {2: ((1, 2),), 4: ((2, 2), (1, 4))}
SEQ_LENS = (32, 64)
FWD_TOL, NORM_TOL = 1e-5, 1e-6


def _cfg(arch, full):
    return get_config(arch) if full else reduced(get_config(arch))


def _cases():
    for arch in ("zamba2-2.7b", "xlstm-1.3b"):
        for full in (True, False):
            cfg = _cfg(arch, full)
            H = cfg.n_ssm_heads if arch == "zamba2-2.7b" else cfg.n_heads
            for t in (2, 4, 8, 16):
                if H % t == 0:
                    yield arch, full, t


# ---------------------------------------------------------------------------
# the selected columns against the reference's layouts
# ---------------------------------------------------------------------------

def _ref_in_proj(cfg, rank, size):
    """``in_proj``'s columns that rank ``rank`` of ``size`` needs, from the
    reference's ``[z (d_in) | x (d_in) | B (N) | C (N) | dt (H)]``: each
    column's head (-1 for B and C, which every head reads)."""
    d_in, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    head = np.concatenate([np.arange(d_in) // P, np.arange(d_in) // P,
                           np.full(2 * N, -1), np.arange(H)])
    return np.flatnonzero((head == -1) | (head // (H // size) == rank))


def _ref_conv(cfg, rank, size):
    """``conv``'s channels ``[x (d_in) | B (N) | C (N)]`` of the rank."""
    d_in, N, H, P = (cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads,
                     cfg.ssm_head_dim)
    head = np.concatenate([np.arange(d_in) // P, np.full(2 * N, -1)])
    return np.flatnonzero((head == -1) | (head // (H // size) == rank))


def _ref_wx(cfg, rank, size):
    """``wx``'s columns, four ``z|i|f|o`` blocks of ``d`` channels, channel
    ``c`` of a block in head ``c // hb``."""
    d, H = cfg.d_model, cfg.n_heads
    head = (np.arange(4 * d) % d) // (d // H)
    return np.flatnonzero(head // (H // size) == rank)


def _ref_r(cfg, rank, size):
    H = cfg.n_heads
    return np.flatnonzero(np.arange(H) // (H // size) == rank)


def _selected(n, spans, size, rank):
    """The indices the port's ``tp.select`` picks of ``n`` items."""
    t = torch.arange(n, dtype=torch.float64)
    axis = tp.ModelAxis(size, rank, None)
    return tp.select(t, spans, 0, n, axis, "t").long().numpy()


@pytest.mark.parametrize("arch,full,size", list(_cases()))
def test_selected_columns_follow_the_reference_layout(arch, full, size):
    cfg = _cfg(arch, full)
    for rank in range(size):
        if arch == "zamba2-2.7b":
            d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            pairs = ((2 * d_in + 2 * N + H, ssm.in_proj_spans, _ref_in_proj),
                     (d_in + 2 * N, ssm.conv_spans, _ref_conv))
        else:
            pairs = ((4 * cfg.d_model, xlstm.slstm_wx_spans, _ref_wx),
                     (cfg.n_heads, xlstm.slstm_r_spans, _ref_r))
        for n, spans, ref in pairs:
            got = _selected(n, spans(cfg, rank, size), size, rank)
            want = ref(cfg, rank, size)
            np.testing.assert_array_equal(got, want, err_msg=spans.__name__)


# ---------------------------------------------------------------------------
# compute_split on shapes
# ---------------------------------------------------------------------------

_HEAD_ALIGNED = {"A_log", "D", "dt_bias", "norm.scale", "out_proj.kernel",
                 "wq.kernel", "wk.kernel", "wv.kernel", "wz.kernel",
                 "w_gates.kernel", "w_gates.bias", "wo.kernel"}
_PACKED = {"in_proj.kernel", "conv.kernel", "wx.kernel", "wx.bias", "r"}


def _mixer_leaves(split):
    """``{name: (leaf inside the mixer, split)}`` of the mixers' leaves."""
    out = {}
    for name, how in split.items():
        for mark in (".mixer.", ".core."):
            if mark in name:
                out[name] = (name.split(mark, 1)[1], how)
    return out


def _split_of(arch, full, shape, mixers=True):
    cfg = _cfg(arch, full)
    module = Decoder(cfg, device="meta")
    mesh = Mesh(dict(zip(("data", "model"), shape)))
    specs = param_shardings(module, mesh, cfg.n_experts)
    return specs, cfg, mesh, compute_split(specs, cfg, mesh, mixers)


@pytest.mark.parametrize("arch,shape", [("zamba2-2.7b", (2, 4)),
                                        ("zamba2-2.7b", (16, 16)),
                                        ("xlstm-1.3b", (2, 4))])
def test_full_width_mixers_split_by_head(arch, shape):
    _, _, _, split = _split_of(arch, True, shape)
    leaves = _mixer_leaves(split)
    assert leaves
    for name, (leaf, how) in leaves.items():
        if leaf in _PACKED:
            assert how == SELECT, name
        else:
            assert leaf in _HEAD_ALIGNED and how == SPLIT, (name, how)
    assert {leaf for leaf, _ in leaves.values()} >= (
        {"in_proj.kernel", "A_log", "out_proj.kernel"}
        if arch == "zamba2-2.7b" else {"wq.kernel", "wx.kernel", "r"})


@pytest.mark.parametrize("arch,full,shape", [("xlstm-1.3b", True, (16, 16)),
                                             ("xlstm-1.3b", False, (1, 8))])
def test_mixers_stay_whole_where_tp_does_not_divide_the_heads(arch, full,
                                                              shape):
    _, _, _, split = _split_of(arch, full, shape)
    for name, (_, how) in _mixer_leaves(split).items():
        assert how in (GATHER, REPLICATED), name


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_the_decode_keeps_its_mixers_whole(arch):
    _, _, _, split = _split_of(arch, True, (2, 4), mixers=False)
    for name, (_, how) in _mixer_leaves(split).items():
        assert how in (GATHER, REPLICATED), name
    # the rest splits as in training
    _, _, _, train = _split_of(arch, True, (2, 4))
    assert {n: h for n, h in split.items() if n not in _mixer_leaves(split)} \
        == {n: h for n, h in train.items() if n not in _mixer_leaves(train)}


@pytest.mark.parametrize("leaf", ["mambas.0.mixer.A_log",
                                  "mambas.0.mixer.out_proj.kernel"])
def test_a_leaf_stored_otherwise_raises(leaf):
    specs, cfg, mesh, _ = _split_of("zamba2-2.7b", False, (2, 4))
    name = f"segments.0.0.{leaf}"
    specs = dict(specs, **{name: (None,) * len(specs[name])})
    with pytest.raises(ValueError, match="computes split"):
        compute_split(specs, cfg, mesh)


def test_whole_weights_under_a_model_axis_raise():
    cfg = reduced(get_config("zamba2-2.7b"))
    m = ssm.Mamba(cfg, device="cpu")
    x = torch.zeros((1, 8, cfg.d_model))
    with pytest.raises(ValueError, match="model shard"):
        ssm.mamba_apply(m, x, cfg, tp.ModelAxis(2, 0, None))
    with pytest.raises(ValueError, match="not whole"):
        tp.select(m.in_proj.kernel[:, :10], ((0, 5),), 1,
                  m.in_proj.kernel.shape[1], tp.ModelAxis(2, 0, None),
                  "in_proj")


def test_reduced_xlstm_at_tp8_computes_whole():
    cfg = reduced(get_config("xlstm-1.3b"))
    block = init_decoder(0, cfg, "cpu").segments[0][0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    positions = torch.arange(16)[None].expand(2, 16)
    with torch.no_grad():
        want, _ = _apply_super("xlstm_super", block, x, positions, cfg)
        heads = {}
        with tp.split_model(tp.ModelAxis(8, 3, None)), \
                recording_heads(heads):
            got, _ = _apply_super("xlstm_super", block, x, positions, cfg)
    assert torch.equal(got, want)
    assert heads == {"mlstm": {cfg.n_heads}, "slstm": {cfg.n_heads}}


# ---------------------------------------------------------------------------
# on gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mixer_split")
    out = {}
    for world, shapes in RANKS.items():
        for i, r in enumerate(run_ranks("mixer_split", world, tmp, shapes,
                                        SEQ_LENS)):
            for name, res in r.items():
                out.setdefault(name, []).append(res)
    return out


MESHES = [mesh_name(s) for shapes in RANKS.values() for s in shapes]


def _gap(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("mesh", MESHES)
def test_split_norm_equals_the_whole_norm(live, mesh):
    tp_size = int(mesh.split("x")[1])
    for r in live[mesh]:
        whole, split = r["norm"]["whole"], r["norm"]["split"]
        i = r["coords"]["model"]
        n = whole[0].shape[-1] // tp_size
        mine = slice(i * n, (i + 1) * n)
        for got, want in ((split[0], whole[0][..., mine]),
                          (split[1], whole[1][..., mine])):
            np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL *
                                       max(1.0, float(np.abs(want).max())))
        # the gain's gradient: this rank's part, summed over its own
        # positions (every rank holds the same batch)
        np.testing.assert_allclose(split[2], whole[2][mine], rtol=0,
                                   atol=NORM_TOL * max(1.0, float(
                                       np.abs(whole[2]).max())))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_mixer_holds_against_one_process(live, mesh, mixer):
    tp_size = int(mesh.split("x")[1])
    for r in live[mesh]:
        res = r[mixer]
        (y, gx, grads), (y1, gx1, grads1) = res["got"], res["want"]
        assert _gap(y, y1) <= FWD_TOL
        assert _gap(gx, gx1) <= GRAD_TOL
        assert set(grads) == set(grads1)
        for n, g in grads.items():
            assert _gap(g, grads1[n]) <= GRAD_TOL, n
        # what the rank computed with: head-aligned leaves at 1/tp, the
        # packed ones whole
        hows = set(res["split"].values())
        assert hows == ({SPLIT, SELECT} if mixer != "mlstm" else {SPLIT})
        for n, how in res["split"].items():
            whole = grads1[n].shape
            local = res["local"][n]
            if how == SPLIT:
                assert np.prod(local) * tp_size == np.prod(whole), n
            else:
                assert local == whole, n


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_model_axis_calls_do_not_grow_with_the_sequence(live, mesh, arch):
    for r in live[mesh]:
        short, long = (r["calls"][f"{arch}/{S}"] for S in SEQ_LENS)
        assert short == long and sum(short.values()) > 0, (short, long)
