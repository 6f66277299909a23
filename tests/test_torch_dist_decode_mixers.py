"""The mesh decode of the Mamba2, mLSTM and sLSTM mixers on their stored
layout (``models.ssm.mamba_decode``, ``models.xlstm.mlstm_decode`` /
``slstm_decode`` with a model axis and the state's spec), on 8 gloo ranks
(CPU), reduced zamba2 and xlstm on (2, 4) and (1, 8), where xlstm's 4
heads do not divide the 8 model ranks:

* each mixer's decode over 4 steps on this rank's slices of a seeded
  state (``cache_shardings``: the Mamba2 state on ``N``, its window on
  channels, the mLSTM ``C`` on ``K``, ``m`` on the heads where they divide
  the axis, the sLSTM states on ``d``) against the one-process decode of
  the whole state: the output and each new state slice within 1e-6 of
  the scale;
* the model axis's collectives a step, call by call, equal to the counts
  written here from the shapes: Mamba2 the conv output gathered and the
  readout ``(B, H, P)`` reduced; mLSTM ``m`` gathered where it is split
  and the readout ``(B, H, hd + 1)`` reduced; sLSTM the new ``h``
  gathered, and the old one first where the heads do not divide the
  axis;
* no collective is as large as this rank's slice of the Mamba2 state or
  the mLSTM ``C``, and the sLSTM moves only ``h``;
* a sharded serve step of each reduced config counts its mixers'
  collectives in ``compat.APART["recurrent"]``: the counts above, once a
  layer, and none of the step's collectives is as large as a rank's
  Mamba2 state or mLSTM ``C`` slice;
* in one process: a spec without "model" is the one-process step bit
  for bit, and a state split along another dimension, or split with no
  model axis, raises.

One spawn of 8 ranks: near 15 s alone.
"""

import numpy as np
import pytest
import torch

from _torch_dist import mesh_name, run_ranks, shard_slices
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import tp
from repro_torch.models import build, ssm, xlstm

MESHES = ((2, 4), (1, 8))
NAMES = [mesh_name(s) for s in MESHES]
STEPS, B, TOL, F32 = 4, 8, 1e-6, 4
ARCH = {"mamba": "zamba2-2.7b", "mlstm": "xlstm-1.3b",
        "slstm": "xlstm-1.3b"}


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    return run_ranks("decode_mixers", 8,
                     tmp_path_factory.mktemp("decode_mixers"), MESHES,
                     STEPS, B)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(
        1.0, float(np.abs(want).max())))


def expected_calls(mixer, mesh):
    """``[(op, bytes)]`` of one decode step of ``mixer`` on ``mesh``, from
    the reduced config's shapes (f32 states and activations)."""
    cfg = reduced(get_config(ARCH[mixer]))
    dp, tp = mesh
    b = B // dp
    if mixer == "mamba":
        ch = cfg.d_inner + 2 * cfg.ssm_state
        return [("model:all_gather", b * ch // tp * F32),
                ("model:all_reduce",
                 b * cfg.n_ssm_heads * cfg.ssm_head_dim * F32)]
    H, hd, d = cfg.n_heads, cfg.head_dim_, cfg.d_model
    if mixer == "mlstm":
        return ([("model:all_gather", b * H // tp * F32)] if H % tp == 0
                else []) + [("model:all_reduce", b * H * (hd + 1) * F32)]
    h = ("model:all_gather", b * d // tp * F32)
    return [h] if H % tp == 0 else [h, h]


def _mesh(name):
    return dict(zip(("data", "model"), map(int, name.split("x"))))


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_decode_holds_against_one_process(live, mesh, mixer):
    shape = _mesh(mesh)
    b = B // shape["data"]
    for r in live:
        res, coords = r[mesh][mixer], r[mesh]["coords"]
        mine = slice(coords["data"] * b, (coords["data"] + 1) * b)
        assert len(res["got"]) == STEPS
        for (y, state), (y1, state1) in zip(res["got"], res["want"]):
            _close(y, y1[mine])
            for leaf, whole in state1.items():
                at = shard_slices(res["spec"][leaf], coords, shape,
                                  whole.shape)
                assert state[leaf].shape == whole[at].shape, leaf
                _close(state[leaf], whole[at])


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_model_axis_calls_and_bytes_a_step(live, mesh, mixer):
    want = expected_calls(mixer, tuple(_mesh(mesh).values()))
    for r in live:
        for calls in r[mesh][mixer]["calls"]:
            assert [tuple(c) for c in calls] == want


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_no_collective_scales_with_the_state(live, mesh, mixer):
    """The states stay where they are stored: every call is smaller than
    the Mamba2 state's or mLSTM ``C``'s slice, and the sLSTM gathers only
    its ``h`` ``(B_l, d / tp)``."""
    for r in live:
        res = r[mesh][mixer]
        _, state = res["got"][0]
        for calls in res["calls"]:
            assert calls
            for op, nbytes in calls:
                if mixer == "slstm":
                    assert (op, nbytes) == ("model:all_gather",
                                            state["h"].nbytes)
                else:
                    big = state["state" if mixer == "mamba" else "C"]
                    assert nbytes < big.nbytes, (op, nbytes, big.shape)


def _layers(arch):
    cfg = reduced(get_config(arch))
    if arch == "zamba2-2.7b":
        return {"mamba": cfg.n_layers}
    per = cfg.mlstm_slstm_pattern + 1
    return {"mlstm": cfg.n_layers // per * (per - 1),
            "slstm": cfg.n_layers // per}


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_serve_step_counts_its_mixers_apart(live, mesh, arch):
    want, shape = {}, tuple(_mesh(mesh).values())
    for mixer, n in _layers(arch).items():
        for op, nbytes in expected_calls(mixer, shape):
            c = want.setdefault(op, {"calls": 0, "bytes": 0})
            c["calls"] += n
            c["bytes"] += n * nbytes
    for r in live:
        step = r[mesh]["steps"][arch]
        got = {op: {k: v[k] for k in ("calls", "bytes")}
               for op, v in step["recurrent"].items()}
        assert got == want
        smallest = min(int(np.prod(s)) * F32 for leaves in
                       step["leaves"].values() for s in leaves)
        assert step["calls"]
        for op, nbytes in step["calls"]:
            assert nbytes < smallest, (op, nbytes, smallest)


# ---------------------------------------------------------------------------
# the stored layouts the decode takes, on one process
# ---------------------------------------------------------------------------

def _one_mixer(mixer):
    arch = ARCH[mixer]
    cfg = reduced(get_config(arch))
    prefix = {"mamba": "mambas.0.mixer", "mlstm": "mlstms.0.core",
              "slstm": "slstm.core"}[mixer]
    module = build(cfg, device="cpu").init(0).get_submodule(
        f"segments.0.0.{prefix}")
    decode, init = {"mamba": (ssm.mamba_decode, ssm.init_mamba_cache),
                    "mlstm": (xlstm.mlstm_decode, xlstm.init_mlstm_cache),
                    "slstm": (xlstm.slstm_decode, xlstm.init_slstm_cache)
                    }[mixer]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    return cfg, module, decode, init(2, cfg, device="cpu"), x


@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_a_spec_without_the_model_axis_is_the_one_process_step(mixer):
    cfg, module, decode, state, x = _one_mixer(mixer)
    spec = type(state)(*((("data",),) + (None,) * (t.dim() - 1)
                         for t in state))
    with torch.no_grad():
        want = decode(module, x, state, cfg)
        got = decode(module, x, state, cfg, tp.ModelAxis(2, 0, None), spec)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mixer,leaf,dim", [("mamba", "state", 2),
                                            ("mamba", "conv", 1),
                                            ("mlstm", "C", 2),
                                            ("slstm", "h", 0)])
def test_a_state_on_another_layout_raises(mixer, leaf, dim):
    cfg, module, decode, state, x = _one_mixer(mixer)
    spec = type(state)(*((None,) * t.dim() for t in state))
    bad = [None] * getattr(state, leaf).dim()
    bad[dim] = "model"
    spec = spec._replace(**{leaf: tuple(bad)})
    with pytest.raises(ValueError, match=f"{mixer} {leaf}: a state stored"):
        decode(module, x, state, cfg, tp.ModelAxis(2, 0, None), spec)
    # a split state needs a model axis
    with pytest.raises(ValueError, match="no model axis"):
        decode(module, x, state, cfg, None, spec)
