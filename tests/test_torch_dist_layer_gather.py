"""The sharded train step with its weights gathered layer by layer
(``repro_torch.distributed.fsdp``) on four gloo ranks (CPU), on (2, 2)
and (4, 1):

* reduced gemma3-1b (local / global super-blocks), olmoe-1b-7b
  (experts), zamba2-2.7b (the shared block outside the super-blocks,
  each super-block's LoRA inside) and whisper-medium (encoder and
  decoder blocks) against the reference's jitted sharded step on the
  same mesh, at the train-step tests' bounds (tests/_torch_dist_train.py,
  tests/_torch_train.py: loss and ce within 1e-5 relative, each
  gradient within 1e-4 of its leaf's max, the moments and the update;
  replicas bit-equal), MoE routing as the whole batch's;
* each gradient ``sharded_loss_and_grads`` returns has its parameter's
  stored local shape;
* the leaves gathered a step: each block leaf that an axis gathers twice
  (its block's forward and its recomputation under "full"), each such
  leaf outside the blocks once; the dry-run's fake world of four counts
  as many for rank 0 as the live rank 0, and its train record no longer
  names a whole-step gather;
* reduced qwen2-72b cut to 8 blocks, under "full" and "dots": the most
  gathered bytes alive at once is at most the leaves outside the blocks
  plus two blocks (less than all the blocks), and none is alive after
  the step.

Reference subprocesses (one a config, in parallel) and one spawn of four
ranks: near 100 s alone.
"""

import pytest
import torch.distributed as dist

import _torch_dist_train as T
from _torch_dist import mesh_name, run_ranks, start_reference
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh

ARCHS = ("gemma3-1b", "olmoe-1b-7b", "zamba2-2.7b", "whisper-medium")
MESHES = ((2, 2), (4, 1))
NAMES = [mesh_name(s) for s in MESHES]
BOUND_LAYERS = 8
CASES = [(a, m) for a in ARCHS for m in NAMES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("layer_gather")
    waits = {a: start_reference("train", tmp / f"{a}.npz", a, tmp / a, 0,
                                ",".join(NAMES)) for a in ARCHS}
    refs = {a: wait() for a, wait in waits.items()}
    ranks = run_ranks("layer_gather", 4, tmp, ARCHS, str(tmp), MESHES,
                      BOUND_LAYERS)
    return refs, ranks


def _case(runs, arch, mesh):
    refs, ranks = runs
    return T.mesh_view(refs[arch], mesh), [r[arch][mesh] for r in ranks]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_step_matches_the_reference(runs, arch, mesh):
    ref, ranks = _case(runs, arch, mesh)
    T.hold_metrics_all(ref, ranks)
    T.hold_gradients(ref, ranks)
    T.hold_moments(ref, ranks)
    T.hold_update(ref, ranks)
    T.hold_replicas(ref, ranks)
    if mesh != "4x1":           # what each rank computes with, at 1/tp
        T.hold_split(ref, ranks, arch, mesh)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_gradients_come_back_as_local_shards(runs, arch, mesh):
    _, ranks = _case(runs, arch, mesh)
    for r in ranks:
        assert set(r["grad_shapes"]) == set(r["params"])
        for name, shape in r["grad_shapes"].items():
            assert shape == r["params"][name].shape, (name, shape)
    # the data axes shard something, so some gradient is a data shard
    assert any(r["grad_shapes"][n] != r["work"][n]
               for r in ranks for n in r["grad_shapes"])


def _is_block(name):
    return name.startswith(("segments.", "enc_blocks.", "dec_blocks."))


def _expected_gathers(rank):
    """Twice each block leaf an axis gathers, once each other one: a leaf
    is gathered where it computes at another shape than it is stored."""
    gathered = [n for n, s in rank["work"].items()
                if s != rank["params"][n].shape]
    return sum(2 if _is_block(n) else 1 for n in gathered)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_gathers_a_step(runs, arch, mesh):
    _, ranks = _case(runs, arch, mesh)
    for r in ranks:
        assert r["gathered"]["calls"] == _expected_gathers(r) > 0, arch
        assert r["gathered"]["alive"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_fake_world_counts_the_live_gathers(runs, arch):
    _, ranks = _case(runs, arch, "2x2")
    rec = dryrun.lower_cell(arch, "t", False, device="cpu",
                            cfg=reduced(get_config(arch)),
                            shape=ShapeSpec("t", 32, 8, "train"),
                            mesh_shape=(2, 2))
    assert not dist.is_initialized()
    got = rec["collectives"]["gathered"]
    assert got["calls"] == ranks[0]["gathered"]["calls"]
    assert got["bytes"] == ranks[0]["gathered"]["bytes"]
    assert rec["collectives"]["working_gather"]["in_step"]
    assert not any("working module" in d
                   for d in rec["differs_from_reference"])


@pytest.mark.parametrize("mesh", NAMES)
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gathered_bytes_stay_within_two_blocks(runs, mesh, policy):
    for r in runs[1]:
        got = r["bound"][f"{mesh}/{policy}"]
        sizes = got["sizes"]
        outside = sum(b for n, b in sizes.items() if not _is_block(n))
        blocks = {}
        for n, b in sizes.items():
            if _is_block(n):
                key = ".".join(n.split(".")[:3])    # segments.<s>.<i>
                blocks[key] = blocks.get(key, 0) + b
        assert len(blocks) == BOUND_LAYERS
        biggest = max(blocks.values())
        peak = got["gathered"]["peak"]
        assert biggest <= peak <= outside + 2 * biggest, (peak, outside,
                                                          biggest)
        assert peak < outside + sum(blocks.values())
        assert got["after"]["alive"] == 0
        assert got["gathered"]["calls"] == sum(
            2 if _is_block(n) else 1 for n in sizes)


def test_only_the_serving_steps_hold_a_working_module():
    cfg = reduced(get_config("gemma3-1b"))
    mesh = Mesh({"data": 2, "model": 2})
    for kind, named in (("train", False), ("decode", True),
                        ("prefill", True)):
        got = dryrun.differs_from_reference(cfg, ShapeSpec("t", 32, 8, kind),
                                            kind, mesh)
        assert any("working module" in d for d in got) == named, kind
