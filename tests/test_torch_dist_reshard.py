"""``checkpoint.reshard`` and the sharded save on 8 gloo ranks (CPU).

The reference's ``test_elastic_reshard_across_meshes`` case: reduced
gemma3-1b (``init_decoder`` on ``PRNGKey(0)``), saved by either package,
restored by the port and resharded onto (2, 4) and then (4, 2)
``("data", "model")`` meshes.  Each rank's local shard must be the slice
its spec names of the saved array, bit for bit, and the state gathered
whole must be what was saved.  The state of the last placement, with
moments made from the weights, is saved sharded (every rank gathers,
rank 0 writes): its ``arrays.npz`` members (each ``.npy``, header and
data; the zip's own timestamps are the clock's) and ``manifest.json``
must be the bytes of the unsharded save of the same state.
"""

import zipfile

import jax
import numpy as np
import pytest

from _torch_dist import moments, restored, run_ranks, shard_slices
from _torch_train import torch_one_thread  # noqa: F401  (autouse)
from repro.checkpoint.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config, reduced
from repro.models import transformer as RT
from repro_torch.checkpoint import save_checkpoint
from repro_torch.models import params_from_jax
from repro_torch.models.convert import tree_of

SHAPES = ((2, 4), (4, 2))
SOURCES = ("reference", "port")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("reshard")
    cfg = reduced(get_config("gemma3-1b"))
    params = RT.init_decoder(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    ref_save(tmp / "reference", 1, params)
    save_checkpoint(tmp / "port", 1, params_from_jax(cfg, tree,
                                                     device="cpu"))
    out = {}
    for src in SOURCES:
        ranks = run_ranks("reshard_onto", 8, tmp, str(tmp / src), SHAPES,
                          str(tmp / f"{src}_sharded"))
        _, module = restored("gemma3-1b", tmp / src)
        save_checkpoint(tmp / f"{src}_plain", 3, (module, moments(dict(
            module.named_parameters()))), extra={"mesh": list(SHAPES[-1])})
        saved = {n: t.detach().numpy() for n, t in module.named_parameters()}
        out[src] = dict(ranks=ranks, saved=saved, tree=tree,
                        sharded=tmp / f"{src}_sharded" / "step_00000003",
                        plain=tmp / f"{src}_plain" / "step_00000003")
    return out


@pytest.mark.parametrize("src", SOURCES)
def test_restored_state_is_the_saved_tree(runs, src):
    got = tree_of(runs[src]["saved"])
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(runs[src]["tree"]),
                    strict=True):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("at", range(len(SHAPES)))
@pytest.mark.parametrize("src", SOURCES)
def test_local_shards_are_their_slices(runs, src, at):
    saved = runs[src]["saved"]
    sharded = 0
    for r in runs[src]["ranks"]:
        placed = r[at]
        assert placed["shape"] == SHAPES[at]
        mesh_shape = dict(zip(("data", "model"), SHAPES[at]))
        for name, whole in saved.items():
            spec = placed["specs"][name]
            want = whole[shard_slices(spec, placed["coords"], mesh_shape,
                                      whole.shape)]
            assert placed["local"][name].tobytes() == \
                np.ascontiguousarray(want).tobytes(), name
            sharded += any(spec)
    assert sharded > 0


@pytest.mark.parametrize("at", range(len(SHAPES)))
@pytest.mark.parametrize("src", SOURCES)
def test_gathered_state_is_the_saved_state(runs, src, at):
    saved = runs[src]["saved"]
    for r in runs[src]["ranks"]:
        got = r[at]["whole"]
        assert set(got) == set(saved)
        for name, t in saved.items():
            assert got[name].tobytes() == t.tobytes(), name


@pytest.mark.parametrize("src", SOURCES)
def test_sharded_save_writes_the_unsharded_bytes(runs, src):
    sharded, plain = runs[src]["sharded"], runs[src]["plain"]
    assert (sharded / "manifest.json").read_bytes() == \
        (plain / "manifest.json").read_bytes()
    with zipfile.ZipFile(sharded / "arrays.npz") as a, \
            zipfile.ZipFile(plain / "arrays.npz") as b:
        assert a.namelist() == b.namelist()
        names = a.namelist()
        assert "1/.step.npy" in names
        assert any(n.startswith("1/.nu/") for n in names)
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    assert (sharded.parent / "LATEST").read_text() == "3"
