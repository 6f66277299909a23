"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU.

* For reduced gemma3 and reduced olmoe, train and decode cells (4 x 32),
  and reduced zamba2's train cell (its Mamba2 mixers split by head over
  the model axis), on a fake world of 4 on a (2, 2) mesh count, for rank
  0, the same
  collective calls and bytes (by op, by mesh axes, the gathers of
  weights and the recomputed calls apart) and the same ``FlopCounterMode``
  FLOPs as four real gloo ranks running the same step on real weights
  (``tests/_torch_dist.py::dryrun_twin``): equal, not within a bound,
  since both sides count shapes.  The record's peak is the step's
  device's alone, ``MemTracker``'s kinds at it summing to it.
* ``model_flops_global`` equals ``repro.models.model_flops`` for every
  applicable (arch, shape) cell (exactly: both are integer arithmetic in
  floats).
* One full-width cell on the 16 x 16 mesh runs through the module's
  ``main``: gemma3-1b ``decode_32k``, its record written to the test's
  directory and read back.
* No process group is left initialised after a cell, also after a cell
  that fails.
"""

import json

import pytest
import torch.distributed as dist

from _torch_dist import run_ranks
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.models import model_flops as ref_model_flops
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, reduced,
                                 shape_applicable)
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.models import model_flops

B, S = 4, 32
CELLS = [(a, k, B, S) for a in ("gemma3-1b", "olmoe-1b-7b")
         for k in ("train", "decode")] + [("zamba2-2.7b", "train", B, S)]


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    return run_ranks("dryrun_twin", 4, tmp_path_factory.mktemp("dryrun"),
                     CELLS)


def _dry(arch, kind):
    rec = dryrun.lower_cell(arch, "t", False, device="cpu",
                            cfg=reduced(get_config(arch)),
                            shape=ShapeSpec("t", S, B, kind),
                            mesh_shape=(2, 2))
    assert not dist.is_initialized()
    return rec


@pytest.mark.parametrize("arch,kind", [c[:2] for c in CELLS])
def test_fake_world_counts_what_live_ranks_count(live, arch, kind):
    rec = _dry(arch, kind)
    real = live[0][f"{arch}/{kind}"]
    coll = rec["collectives"]
    for key in ("ops", "by_axes", "bytes", "counts", "total_bytes"):
        assert coll[key] == real["counts"][key], key
    for part in ("working_gather", "recompute"):
        assert coll[part] == real["counts"][part], part
    assert rec["cost"]["flops"] == real["flops"]
    assert coll["counts"]["all-reduce"] > 0
    assert coll["working_gather"]["in_step"] == (kind == "train")
    if kind == "train":        # "full": the model axis's psums issued again
        assert coll["recompute"]["ops"]["model:all_reduce"]["calls"] > 0
    else:
        assert coll["recompute"]["ops"] == {}
    mem = rec["memory"]
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    assert mem["temp_bytes"] == mem["peak_bytes"] - mem["argument_bytes"]
    # the peak of the step's device alone (not the meta module the working
    # module is built from): MemTracker's kinds at it sum to it, the
    # arguments among them
    assert sum(mem["peak_by_kind"].values()) == mem["peak_bytes"]
    assert mem["peak_by_kind"]["Other"] >= mem["argument_bytes"]
    # every live rank counts alike (the ranks are symmetric)
    for rank in live[1:]:
        assert rank[f"{arch}/{kind}"]["counts"]["ops"] == real["counts"]["ops"]


_APPLICABLE = [(a, s) for a in ARCH_IDS for s in SHAPES
               if shape_applicable(a, s)]


@pytest.mark.parametrize("arch,shape", _APPLICABLE)
def test_model_flops_global_equals_the_reference(arch, shape):
    got = model_flops(get_config(arch), SHAPES[shape])
    want = ref_model_flops(ref_config(arch), REF_SHAPES[shape])
    assert got == want


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_full")
    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                 "--single-pod-only", "--device", "cpu", "--out-dir",
                 str(out)])
    path = dryrun.cell_path("gemma3-1b", "decode_32k", False, out)
    return json.loads(path.read_text())


def test_full_width_cell_on_the_production_mesh(full_width):
    rec = full_width
    assert rec["status"] == "ok", rec
    assert (rec["arch"], rec["shape"], rec["kind"], rec["mesh"],
            rec["n_devices"]) == ("gemma3-1b", "decode_32k", "decode",
                                  "16x16", 256)
    assert rec["model_flops_global"] == model_flops(
        get_config("gemma3-1b"), SHAPES["decode_32k"])
    assert rec["cost"]["flops"] > 0
    mem = rec["memory"]
    assert mem["code_bytes"] is None and mem["alias_bytes"] is None
    assert 0 < mem["argument_bytes"] <= mem["peak_bytes"]
    coll = rec["collectives"]
    assert set(coll["bytes"]) == {"all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"}
    assert coll["total_bytes"] == sum(coll["bytes"].values()) > 0
    assert coll["working_gather"]["total_bytes"] > 0
    assert not coll["working_gather"]["in_step"]
    assert any(k.startswith("model:") for k in coll["by_axes"])
    assert rec["differs_from_reference"]
    assert not dist.is_initialized()


def test_no_group_is_left_after_a_failing_cell():
    with pytest.raises(ValueError):
        dryrun.lower_cell("gemma3-1b", "t", False, "no-such-step",
                          device="cpu", cfg=reduced(get_config("gemma3-1b")),
                          shape=ShapeSpec("t", S, B, "train"),
                          mesh_shape=(2, 2))
    assert not dist.is_initialized()
