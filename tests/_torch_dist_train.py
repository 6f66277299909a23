"""One sharded train step on 8 gloo ranks against the reference's jitted
step under its shardings on 8 fake devices, and the checks
tests/test_torch_dist_train{,_moe,_int8}.py make of it (one case a
file, each near 60 s under ``-n 6``).

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

from _torch_dist import assemble, run_ranks, start_reference
from _torch_train import (GRAD_TOL, OPT, UPDATE_TOL, adam_direction,
                          hold_metrics)
from repro_torch.models.convert import tree_path
from repro_torch.train import optim as PO


def run(tmp, arch, compress=False):
    """``(reference, [each rank's result], the (1, 1) run)`` of ``arch``,
    with the int8 gradient compression where ``compress``."""
    ref = start_reference("train", tmp / f"{arch}.npz", arch, tmp / arch,
                          int(compress))()
    ranks = run_ranks("train", 8, tmp, arch, str(tmp / arch),
                      str(tmp / f"{arch}.npz"), (2, 4), compress)
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


def hold_metrics_all(ref, ranks):
    want = {k: float(ref[f"metrics/{k}"]) for k in ("loss", "ce",
                                                     "grad_norm", "lr")}
    for r in ranks:
        hold_metrics(r["metrics"], want)
        assert r["step"] == 1
        assert abs(r["grad_loss"] - want["loss"]) <= 1e-5 * want["loss"]


def hold_gradients(ref, ranks):
    worst = 0.0
    for name, g in ranks[0]["grads"].items():
        leaf, at = ref_leaf(ref, "grads", name)
        scale = max(float(np.abs(leaf).max()), 1e-30)
        gap = float(np.abs(g - leaf[at]).max()) / scale
        assert gap <= GRAD_TOL, (name, gap)
        worst = max(worst, gap)
    assert worst > 0     # the two sides are separate computations
    for r in ranks[1:]:
        for name, g in r["grads"].items():
            assert g.tobytes() == ranks[0]["grads"][name].tobytes(), name


def hold_moments(ref, ranks):
    for key, tol in (("mu", GRAD_TOL), ("nu", 2 * GRAD_TOL)):
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
