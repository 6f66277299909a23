"""The mesh decode of the Mamba2, mLSTM and sLSTM mixers on their stored
layout (``models.ssm.mamba_decode``, ``models.xlstm.mlstm_decode`` /
``slstm_decode`` with a model axis, the state's spec and the weights at
their stored model shards), on 8 gloo ranks (CPU), reduced zamba2 and
xlstm on (2, 4), (1, 8), where xlstm's 4 heads do not divide the 8 model
ranks, and (8, 1), where nothing splits over "model":

* each mixer's decode over 4 steps on this rank's slices of a seeded
  state (``cache_shardings``: the Mamba2 state on ``N``, its window on
  channels, the mLSTM ``C`` on ``K``, ``m`` on the heads where they divide
  the axis, the sLSTM states on ``d``) against the one-process decode of
  the whole state: the output and each new state slice within 1e-6 of
  the scale, with every weight at its stored model shard
  (``compute_split(..., mixers=False)``) and with every weight whole;
* with the stored shards, the model axis's collectives a step, call by
  call, equal to the counts written here from the shapes
  (:func:`expected_calls`), none at tp = 1;
* no collective is as large as this rank's slice of the Mamba2 state or
  the mLSTM ``C``; the sLSTM gathers only ``h`` and reduces nothing
  larger than its pre-activations ``(B_l, 4d)``;
* a sharded serve step of each reduced config counts its mixers'
  collectives in ``compat.APART["recurrent"]``: the counts above, once a
  layer, and none of the step's collectives is as large as a rank's
  Mamba2 state or mLSTM ``C`` slice but the sLSTM's pre-activations;
* the serve step's working module holds every mixer leaf at the local
  shape its stored spec gives it (no leaf whole on "model" where its spec
  splits it), its parameter bytes a rank equal to the count from the
  shapes (:func:`mixer_held_bytes` and the other leaves'
  ``compute_split``), and its fill gathers no mixer leaf over "model";
* in one process: a spec without "model" is the one-process step bit
  for bit, a state split along another dimension, or split with no
  model axis, raises, and so does a weight that is neither whole nor a
  model shard.

One spawn of 8 ranks: near 40 s alone.
"""

import math

import numpy as np
import pytest
import torch

from _torch_dist import mesh_name, run_ranks, shard_slices
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.distributed import param_shardings, tp
from repro_torch.distributed.sharding import SPLIT, compute_split
from repro_torch.launch.mesh import Mesh
from repro_torch.models import build, ssm, xlstm
from repro_torch.models.transformer import Decoder, segments_for

MESHES = ((2, 4), (1, 8), (8, 1))
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
    the reduced config's shapes (f32 states and activations), each weight
    at its stored model shard: the rules split a dimension over "model"
    where tp divides it, and each split projection's output is gathered
    (several in one call) or its partial sums reduced.  None at tp = 1."""
    cfg = reduced(get_config(ARCH[mixer]))
    dp, tp = mesh
    if tp == 1:
        return []
    b = B // dp
    G, R = "model:all_gather", "model:all_reduce"

    def part(n):                        # a rank's share where tp divides n
        return n // tp if n % tp == 0 else 0

    d = cfg.d_model
    if mixer == "mamba":
        d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
        out = [(G, b * part(2 * d_in + 2 * N + H) * F32),   # in_proj
               # the conv on this rank's channels, its heads' dt and decay
               (G, b * (part(d_in + 2 * N) + 2 * part(H)) * F32)]
        out += [(R, b * H * cfg.ssm_head_dim * F32)] * (N % tp == 0)
        out += [(R, b * d * F32)] * (d_in % tp == 0)      # out_proj's rows
    elif mixer == "mlstm":
        H, hd = cfg.n_heads, cfg.head_dim_
        # q, k, v, z, the gates and the stabiliser m, in one call
        out = [(G, b * (4 * part(H * hd) + part(2 * H) + part(H)) * F32)]
        out += [(R, b * H * (hd + 1) * F32)] * (hd % tp == 0)   # readout
        out += [(R, b * d * F32)] * (H * hd % tp == 0)          # wo's rows
    else:
        hb = d // cfg.n_heads
        out = [(G, b * part(d) * F32)]                  # the old h
        # r's rows' partial sums with wx's columns: z|i|f|o, (B, 4d)
        out += [(R, b * 4 * d * F32)] * (hb % tp == 0 or 4 * d % tp == 0)
        out += [(R, b * F32), (R, b * d * F32)] * (d % tp == 0)
    return [c for c in out if c[1]]


def mixer_held_bytes(cfg, tp):
    """The Mamba2, mLSTM and sLSTM leaves' f32 bytes a rank holds in the
    decode's working module, from the shapes: each dimension the rules
    split over "model" (where tp divides it) at 1 / tp, the others
    whole."""
    def part(n):
        return n // tp if n % tp == 0 else n

    d, total = cfg.d_model, 0
    for kind, n_iter, per in segments_for(cfg):
        if kind == "mamba_hybrid":
            d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
            total += n_iter * per * (
                d * part(2 * d_in + 2 * N + H) + 4 * part(d_in + 2 * N)
                + 3 * part(H) + part(d_in) + part(d_in) * d)
        elif kind == "xlstm_super":
            H, n = cfg.n_heads, cfg.n_heads * cfg.head_dim_
            hb = d // H
            total += n_iter * (per - 1) * (
                4 * d * part(n) + d * part(2 * H) + part(2 * H) + part(n)
                + part(n) * d)
            total += n_iter * (d * part(4 * d) + part(4 * d)
                               + H * part(hb) * 4 * hb + part(d)
                               + part(d) * d)
    return total * F32


def _mesh(name):
    return dict(zip(("data", "model"), map(int, name.split("x"))))


def _mixer(name):
    """The mixer a parameter belongs to, None for every other leaf."""
    if ".mixer." in name:
        return "mamba"
    if ".core." in name:
        return "mlstm" if ".mlstms." in name else "slstm"
    return None


@pytest.mark.parametrize("weights", ["stored", "whole"])
@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_decode_holds_against_one_process(live, mesh, mixer, weights):
    shape = _mesh(mesh)
    b = B // shape["data"]
    for r in live:
        res, coords = r[mesh][mixer], r[mesh]["coords"]
        mine = slice(coords["data"] * b, (coords["data"] + 1) * b)
        assert len(res["got"][weights]) == STEPS
        for (y, state), (y1, state1) in zip(res["got"][weights],
                                             res["want"]):
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
    assert bool(want) == (_mesh(mesh)["model"] > 1)
    for r in live:
        for calls in r[mesh][mixer]["calls"]["stored"]:
            assert [tuple(c) for c in calls] == want


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_no_collective_scales_with_the_state(live, mesh, mixer):
    """The states stay where they are stored: every call is smaller than
    the Mamba2 state's or mLSTM ``C``'s slice; the sLSTM gathers only its
    ``h`` ``(B_l, d / tp)`` and reduces nothing larger than its
    pre-activations ``(B_l, 4d)``."""
    tp_size = _mesh(mesh)["model"]
    for r in live:
        res = r[mesh][mixer]
        _, state = res["got"]["stored"][0]
        for calls in res["calls"]["stored"]:
            assert bool(calls) == (tp_size > 1)
            for op, nbytes in calls:
                if mixer == "slstm":
                    b, c = state["h"].shape
                    assert nbytes <= 4 * b * c * tp_size * F32, (op, nbytes)
                    assert op == "model:all_reduce" or nbytes == \
                        state["h"].nbytes
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
        # the sLSTM's pre-activations (B_l, 4d), reduced whole
        pre = B // shape[0] * 4 * reduced(get_config(arch)).d_model * F32
        model = [c for c in step["calls"] if c[0].startswith("model:")]
        assert bool(model) == (shape[1] > 1)
        for op, nbytes in step["calls"]:
            assert nbytes < smallest or (
                arch == "xlstm-1.3b" and (op, nbytes) == (
                    "model:all_reduce", pre)), (op, nbytes, smallest)


def _whole_shapes(arch, mesh):
    cfg = reduced(get_config(arch))
    module = Decoder(cfg, device="meta")
    mesh = Mesh(_mesh(mesh))
    specs = param_shardings(module, mesh, cfg.n_experts)
    return cfg, mesh, specs, {n: tuple(p.shape)
                              for n, p in module.named_parameters()}


def _on_model(spec):
    return [d for d, axes in enumerate(spec) if axes and "model" in (
        (axes,) if isinstance(axes, str) else axes)]


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_working_module_holds_each_mixer_leaf_at_its_stored_shard(
        live, mesh, arch):
    cfg, m, specs, whole = _whole_shapes(arch, mesh)
    tp_size = _mesh(mesh)["model"]
    mixers = 0
    for r in live:
        step = r[mesh]["steps"][arch]
        assert step["specs"] == specs
        for name, shape in step["held"].items():
            if _mixer(name) is None:
                continue
            mixers += 1
            want = list(whole[name])
            for dim in _on_model(specs[name]):
                want[dim] //= tp_size
            assert shape == tuple(want), (name, shape, specs[name])
            assert (shape != whole[name]) == bool(_on_model(specs[name]))
        # the fill gathers no mixer leaf over the model axis
        for name in step["gathered_whole"]:
            assert _mixer(name) is None or not _on_model(specs[name]), name
    assert mixers


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_held_bytes_equal_the_count_from_the_shapes(live, mesh, arch):
    cfg, m, specs, whole = _whole_shapes(arch, mesh)
    tp_size = _mesh(mesh)["model"]
    split = compute_split(specs, cfg, m, mixers=False)
    rest = sum(math.prod(s) // (tp_size if split[n] == SPLIT else 1)
               for n, s in whole.items() if _mixer(n) is None) * F32
    mixers = mixer_held_bytes(cfg, tp_size)
    if tp_size > 1:
        assert mixers < mixer_held_bytes(cfg, 1) / (tp_size / 2)
    for r in live:
        held = r[mesh]["steps"][arch]["held"]
        got = {k: sum(math.prod(s) for n, s in held.items()
                      if (_mixer(n) is None) == (k == "rest")) * F32
               for k in ("rest", "mixers")}
        assert got == {"rest": rest, "mixers": mixers}


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


@pytest.mark.parametrize("mixer,leaf,dim", [("mamba", "in_proj.kernel", 1),
                                            ("mamba", "A_log", 0),
                                            ("mlstm", "wk.kernel", 1),
                                            ("mlstm", "w_gates.bias", 0),
                                            ("slstm", "r", 1),
                                            ("slstm", "wo.kernel", 0)])
def test_a_weight_neither_whole_nor_a_shard_raises(mixer, leaf, dim):
    """A leaf cut to 3/4 on a model axis of 2 is no layout of the rules:
    the decode names it, whatever the rest; the same cut to 1/2 with no
    model axis names it too."""
    cfg, module, decode, state, x = _one_mixer(mixer)
    *path, name = leaf.split(".")
    owner = module.get_submodule(".".join(path)) if path else module
    t = getattr(owner, name)
    for keep, axis, match in ((3, tp.ModelAxis(2, 0, None), "model shard"),
                              (2, None, "no model axis")):
        setattr(owner, name, torch.nn.Parameter(
            t.detach().narrow(dim, 0, t.shape[dim] * keep // 4).clone()))
        with pytest.raises(ValueError, match=match), torch.no_grad():
            decode(module, x, state, cfg, axis)
        setattr(owner, name, t)
