"""The port's hill-climb (``repro_torch.launch.hillclimb``) on the CPU: its
three comparisons on reduced configs at 4 x 64 on a fake (2, 2) world,
with ``attention._BLOCK_THRESHOLD`` lowered to 32 so that the "current
code" side takes the blocked path (one block of 64) and the dense
baseline, with the threshold raised to ``1 << 30``, does not.

* The output keys are the reference's (``src/repro/launch/hillclimb.py``).
* ``_BLOCK_THRESHOLD`` is restored after the run, and after a probe that
  fails.
* "dots" costs fewer FLOPs than "full" (it recomputes no product without
  batch dimensions), peaks higher (it keeps their outputs) and moves the
  same collectives: recomputation issues the same model-axis calls under
  either policy, since only products are kept.
* Each side is one dry-run cell of rank 0: its numbers equal
  ``probe_total`` of that cell.
"""

import json

import pytest
import torch.distributed as dist

from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import hillclimb
from repro_torch.models import attention as A

ARGS = ["--device", "cpu", "--reduced", "--seq-len", "64", "--batch", "4",
        "--mesh", "2x2"]


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    out = tmp_path_factory.mktemp("hillclimb") / "torch_hillclimb.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(A, "_BLOCK_THRESHOLD", 32)
    try:
        got = hillclimb.main(ARGS + ["--out", str(out)])
        assert A._BLOCK_THRESHOLD == 32
    finally:
        mp.undo()
    assert not dist.is_initialized()
    return got, json.loads(out.read_text())


def test_the_reference_keys(table):
    got, written = table
    assert got == written
    assert set(got) == {"minitron-4b__prefill_32k",
                        "llama4-scout-17b-a16e__prefill_32k",
                        "qwen2-72b__train_4k"}
    side = {"flops", "bytes", "coll"}
    for arch in ("minitron-4b", "llama4-scout-17b-a16e"):
        cell = got[f"{arch}__prefill_32k"]
        assert set(cell) == {"dense_baseline", "blocked+constraint",
                             "collective_reduction"}
        assert set(cell["dense_baseline"]) == set(
            cell["blocked+constraint"]) == side
        assert cell["collective_reduction"] == (
            cell["dense_baseline"]["coll"]
            / max(1.0, cell["blocked+constraint"]["coll"]))
    cell = got["qwen2-72b__train_4k"]
    assert set(cell) == {"remat_full", "remat_dots", "flops_reduction"}
    assert set(cell["remat_full"]) == set(cell["remat_dots"]) == side


def test_dots_saves_flops_and_moves_the_same_collectives(table):
    cell = table[0]["qwen2-72b__train_4k"]
    full, dots = cell["remat_full"], cell["remat_dots"]
    assert dots["flops"] < full["flops"]
    assert cell["flops_reduction"] == full["flops"] / dots["flops"] > 1
    assert dots["coll"] == full["coll"]
    assert dots["bytes"] > full["bytes"]    # the kept product outputs


def test_each_side_is_one_dry_run_cell(table):
    cell = table[0]["minitron-4b__prefill_32k"]["blocked+constraint"]
    mp = pytest.MonkeyPatch()
    mp.setattr(A, "_BLOCK_THRESHOLD", 32)
    try:
        got = hillclimb.probe_total(
            reduced(get_config("minitron-4b")), "prefill_32k", device="cpu",
            shape=ShapeSpec("prefill_32k", 64, 4, "prefill"),
            mesh_shape=(2, 2))
    finally:
        mp.undo()
    assert got == [cell["flops"], cell["bytes"], cell["coll"]]


def test_threshold_restored_after_a_failing_probe(tmp_path, monkeypatch):
    before = A._BLOCK_THRESHOLD

    def probe(cfg, name, **kw):
        if A._BLOCK_THRESHOLD == 1 << 30:
            raise RuntimeError("probe failed")
        return [1.0, 1.0, 1.0]

    monkeypatch.setattr(hillclimb, "probe_total", probe)
    with pytest.raises(RuntimeError, match="probe failed"):
        hillclimb.main(ARGS + ["--out", str(tmp_path / "t.json")])
    assert A._BLOCK_THRESHOLD == before
