"""One sharded train step on 8 gloo ranks against the reference's jitted
step under its shardings on 8 fake devices, and the checks
tests/test_torch_dist_train{,_moe,_int8}.py make of it (one case a
file, each near 60 s under ``-n 6``), and the same on the meshes
TP_MESHES for tests/test_torch_dist_tp_*.py (one config a file), which
also hold what each rank computed with (:func:`hold_split`).

A reduced config from the reference's weights (``init_decoder`` on
``PRNGKey(0)``, written by the reference's ``save_checkpoint`` and
restored by the port's) and one batch of 8 x 32 tokens from its
``TokenPipeline``, on a (2, 4) ``("data", "model")`` mesh: the port's
``make_train_step(..., mesh=)`` (the parameters placed by
``checkpoint.reshard``) against the reference's ``train_step`` jitted
under ``param_shardings`` / ``batch_shardings``
(tests/_torch_dist_ref.py), at the train-step tests' bounds
(tests/_torch_train.py):
loss and ce within 1e-5 relative, each gradient within 1e-4 of its
leaf's max, ``mu`` / ``nu`` within the gradient bound / twice it of their
max, each updated weight within ``lr * (UPDATE_TOL + du)``.  Ranks that
hold the same shard hold the same bits, and every rank the same
gradients.  On a (1, 1) mesh (a world of one) the sharded step equals
the plain step bit for bit over two steps.
"""

import numpy as np
import pytest

from _torch_dist import assemble, mesh_name, run_ranks, start_reference
from _torch_train import (GRAD_TOL, OPT, UPDATE_TOL, XLSTM_GRAD_TOL,
                          adam_direction, hold_metrics)
from repro_torch.models.convert import tree_path
from repro_torch.train import optim as PO


def run_meshes(tmp, arch, shapes, compress=False):
    """``{mesh name: (reference, [each rank's result])}`` of ``arch`` on
    each (data, model) mesh of ``shapes``, with the int8 gradient
    compression where ``compress``: one reference process and one spawn
    of 8 ranks for all of them."""
    names = [mesh_name(s) for s in shapes]
    ref = start_reference("train", tmp / f"{arch}.npz", arch, tmp / arch,
                          int(compress), ",".join(names))()
    ranks = run_ranks("train", 8, tmp, arch, str(tmp / arch),
                      str(tmp / f"{arch}.npz"), tuple(shapes), compress)
    return {name: (mesh_view(ref, name), [r[name] for r in ranks])
            for name in names}


def mesh_view(ref, name):
    """The reference's arrays of mesh ``name`` under their plain keys
    (``grads/<path>``), with the batch and the drops."""
    view = {k[len(name) + 1:]: v for k, v in ref.items()
            if k.startswith(name + "/")}
    view.update({k: v for k, v in ref.items() if "/" not in k
                 or k.startswith("batch/")})
    return view


def run(tmp, arch, compress=False):
    """``(reference, [each rank's result], the (1, 1) run)`` of ``arch``
    on (2, 4), with the int8 gradient compression where ``compress``."""
    ref, ranks = run_meshes(tmp, arch, [(2, 4)], compress)["2x4"]
    one = run_ranks("one_rank_mesh", 1, tmp, arch, str(tmp / arch), 2,
                    compress)[0]
    return ref, ranks, one


def ref_leaf(ref, key, name):
    keys, at = tree_path(name)
    return ref[f"{key}/{'/'.join(map(str, keys))}"], at


def whole(ref, ranks, key):
    """The ranks' shards of ``key`` assembled whole."""
    shapes = {}
    for name in ranks[0][key]:
        leaf, at = ref_leaf(ref, "params", name)
        shapes[name] = leaf[at].shape
    return assemble(ranks, key, shapes)


def hold_metrics_all(ref, ranks, norm_tol=1e-5):
    want = {k: float(ref[f"metrics/{k}"]) for k in ("loss", "ce",
                                                     "grad_norm", "lr")}
    for r in ranks:
        hold_metrics(r["metrics"], want, norm_tol=norm_tol)
        assert r["step"] == 1
        assert abs(r["grad_loss"] - want["loss"]) <= 1e-5 * want["loss"]


def hold_gradients(ref, ranks, tol=GRAD_TOL):
    worst = 0.0
    for name, g in ranks[0]["grads"].items():
        leaf, at = ref_leaf(ref, "grads", name)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        gap = float(np.abs(g - leaf[at]).max()) / scale
        assert gap <= tol, (name, gap)
        worst = max(worst, gap)
    assert worst > 0     # the two sides are separate computations
    for r in ranks[1:]:
        for name, g in r["grads"].items():
            assert g.tobytes() == ranks[0]["grads"][name].tobytes(), name


def hold_moments(ref, ranks, grad_tol=GRAD_TOL):
    for key, tol in (("mu", grad_tol), ("nu", 2 * grad_tol)):
        for name, got in whole(ref, ranks, key).items():
            leaf, at = ref_leaf(ref, key, name)
            atol = tol * float(np.abs(leaf).max())
            np.testing.assert_allclose(got, leaf[at], rtol=0, atol=atol,
                                       err_msg=f"{key} {name}")


def hold_update(ref, ranks):
    opt = PO.AdamWConfig(**OPT)
    lr = float(ref["metrics/lr"])
    mu = whole(ref, ranks, "mu")
    for name, got in whole(ref, ranks, "params").items():
        want, at = ref_leaf(ref, "params", name)
        mw = ref_leaf(ref, "mu", name)[0][at]
        du = np.abs(adam_direction(mu[name], opt) - adam_direction(mw, opt))
        bad = np.abs(got - want[at]) > lr * (UPDATE_TOL + du)
        assert not bad.any(), name


def hold_replicas(ref, ranks):
    """``assemble`` raises where ranks holding one slice differ; on (2, 4)
    a tensor whose spec leaves an axis out is held by several ranks."""
    for key in ("params", "mu", "nu"):
        whole(ref, ranks, key)
    used = [{a for axes in spec if axes for a in
             ((axes,) if isinstance(axes, str) else axes)}
            for spec in ranks[0]["specs"].values()]
    assert any(used) and any(u != {"data", "model"} for u in used)


def hold_one_rank(one):
    plain, mesh = one["plain"], one["mesh"]
    assert mesh["metrics"] == plain["metrics"]
    assert mesh["step"] == plain["step"] == 2
    for key in ("params", "mu", "nu"):
        assert set(mesh[key]) == set(plain[key])
        for name, t in plain[key].items():
            assert mesh[key][name].tobytes() == t.tobytes(), (key, name)


# ---------------------------------------------------------------------------
# the model axis's split (tests/test_torch_dist_tp_*.py)
# ---------------------------------------------------------------------------

TP_MESHES = ((2, 4), (4, 2), (1, 8))


def hold_split(ref, ranks, arch, name):
    """What each rank computed with on mesh ``name`` (the shapes the
    per-layer gather gave each leaf): a leaf that
    ``compute_split`` marks ``split`` has its whole's shape with its
    model-split dimension cut tp times (``1/tp`` of the elements), every
    other leaf its whole shape; the logits' last dimension is the padded
    vocabulary over tp; in a MoE config each ``torch.bmm`` of the loss
    (the experts') sees ``E / tp`` experts; each Mamba2 SSD scan, mLSTM
    scan and sLSTM step runs on ``H / tp`` heads where tp divides the
    mixers' ``H``, else on all ``H``."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.distributed.sharding import mixer_heads

    cfg = reduced(get_config(arch))
    tp = int(name.split("x")[1])
    H = mixer_heads(cfg)
    mixers = {"hybrid": ["mamba"], "ssm": ["mlstm", "slstm"]}.get(
        cfg.family, [])
    split_leaves = 0
    for r in ranks:
        for leaf, shape in r["work"].items():
            whole_leaf, at = ref_leaf(ref, "params", leaf)
            want = whole_leaf[at].shape
            if r["split"][leaf] == "split":
                split_leaves += 1
                cut = [d for d, (a, b) in enumerate(zip(shape, want))
                       if a != b]
                assert len(cut) == 1 and shape[cut[0]] * tp == want[cut[0]], \
                    (leaf, shape, want)
                assert np.prod(shape) * tp == np.prod(want), leaf
            else:
                assert shape == want, (leaf, shape, want)
        assert r["logits"][-1] * tp == cfg.padded_vocab, r["logits"]
        if cfg.n_experts:
            assert r["experts"] and set(r["experts"]) == {
                cfg.n_experts // tp}, r["experts"]
        assert sorted(r["heads"]) == mixers, r["heads"]
        for mixer in mixers:
            assert r["heads"][mixer] == [H // tp if H % tp == 0 else H], \
                (mixer, r["heads"])
    assert split_leaves > 0


def tp_suite(arch, grad_tol=GRAD_TOL, norm_tol=1e-5):
    """The module-scoped ``runs`` fixture and the tests of ``arch`` on each
    mesh of TP_MESHES (a test module assigns them to its names): the
    step at the train-step tests' bounds (``grad_tol`` for the gradients
    and moments, ``norm_tol`` for grad_norm), replicas bit-equal, and
    each rank's share (:func:`hold_split`)."""
    meshes = pytest.mark.parametrize("mesh",
                                     [mesh_name(s) for s in TP_MESHES])

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        return run_meshes(tmp_path_factory.mktemp("dist_tp"), arch,
                          TP_MESHES)

    @meshes
    def test_metrics(runs, mesh):
        hold_metrics_all(*runs[mesh], norm_tol=norm_tol)

    @meshes
    def test_gradients(runs, mesh):
        hold_gradients(*runs[mesh], tol=grad_tol)

    @meshes
    def test_moments(runs, mesh):
        hold_moments(*runs[mesh], grad_tol=grad_tol)

    @meshes
    def test_update(runs, mesh):
        hold_update(*runs[mesh])

    @meshes
    def test_replicas_hold_the_same_bits(runs, mesh):
        hold_replicas(*runs[mesh])

    @meshes
    def test_each_rank_computes_its_share(runs, mesh):
        hold_split(*runs[mesh], arch, mesh)

    return (runs, test_metrics, test_gradients, test_moments, test_update,
            test_replicas_hold_the_same_bits,
            test_each_rank_computes_its_share)
