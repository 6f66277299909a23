"""The serving steps on a mesh on 8 gloo ranks against the reference's
jitted serving steps under its shardings on 8 fake devices, and the
checks tests/test_torch_dist_serve_{dense,moe,recurrent}.py make of them
(:func:`serve_suite`, one file a family).

Each reduced config from the reference's weights (``init_decoder`` /
``init_encdec`` on ``PRNGKey(0)``, written by the reference's
``save_checkpoint``, restored by the port's), on (2, 4) and (1, 8)
``("data", "model")`` meshes (tests/_torch_dist_ref.py::serve, the
port's side tests/_torch_dist.py::serve): the port's
``make_prefill_step(..., mesh=)`` on the reference's 8 x 32 prompt
batch, then ``make_serve_step(..., mesh=)`` for 8 steps on seeded
inputs, from the reference's first cache (every tensor seeded, every
length at ``start``) placed by ``ShardedCache.place`` (whisper's memory
filled by ``sharded_prefill_memory``), against the reference's
``prefill_step`` and ``serve_step`` jitted under ``param_shardings`` /
``batch_shardings`` / ``cache_shardings``.  The bound is the LM serving
tests' f32 bound (tests/_torch_lm.py::close: ``atol = TOL * max(1,
max|want|)``, ``rtol = TOL``): the prefill logits, each step's logits and
each rank's final cache slices (against the reference's gathered cache,
sliced by the rank's spec).  Tokens equal the reference's wherever its
top-2 gap exceeds the bound, and every rank holds the same tokens and
logits.  A fresh ``init_cache(..., mesh=)`` has this rank's local shapes
only, and no tensor of a sharded leaf's whole shape is made.  On a
(1, 1) mesh (a world of one) the mesh steps equal the one-process steps
bit for bit.
"""

import numpy as np
import pytest

from _torch_dist import (mesh_name, mesh_shape_of, run_ranks, shard_slices,
                         start_reference)

TOL = 1e-4
MESHES = ((2, 4), (1, 8))


def run(tmp, archs, extras=False):
    """``(reference, [each rank's result], the (1, 1) run)`` for ``archs``:
    one reference process, one spawn of 8 ranks for both meshes and one
    world of one."""
    npz, ckpt = tmp / "serve.npz", tmp / "ckpt"
    ref = start_reference("serve", npz, ",".join(archs), ckpt,
                          ",".join(mesh_name(s) for s in MESHES))()
    ranks = run_ranks("serve", 8, tmp, tuple(archs), str(ckpt), str(npz),
                      MESHES, extras)
    one = run_ranks("serve_one_rank", 1, tmp, tuple(archs), str(ckpt),
                    str(npz))[0]
    return ref, ranks, one


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        assert r[key].tobytes() == ranks[0][key].tobytes(), key


def hold_prefill(ref, ranks):
    same_on_every_rank(ranks, "prefill")
    close(ranks[0]["prefill"], ref["prefill"])


def hold_decode(ref, ranks):
    same_on_every_rank(ranks, "logits")
    same_on_every_rank(ranks, "tokens")
    want = ref["logits"]
    assert ranks[0]["logits"].shape == want.shape
    for got, w in zip(ranks[0]["logits"], want):
        close(got, w)
    # the reference's own tokens are its logits' first maxima
    np.testing.assert_array_equal(ref["tokens"], want.argmax(-1))
    top2 = np.sort(want, axis=-1)[..., -2:]
    bound = TOL * np.maximum(1.0, np.abs(want).max(axis=(1, 2)))[:, None]
    clear = top2[..., 1] - top2[..., 0] > bound
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(ranks[0]["tokens"][clear],
                                  ref["tokens"][clear])


def ref_leaf(ref, prefix, key, at):
    return np.asarray(ref[f"{prefix}/{key}"])[at]


def hold_cache(ref, ranks, start, steps):
    """Each rank's final slices against the reference's gathered cache
    sliced by the rank's spec; every length at ``start + steps``."""
    mesh_shape = mesh_shape_of(ranks)
    n = 0
    for r in ranks:
        for key, at, got, spec in r["cache"]:
            want = ref_leaf(ref, "cache", key, at)
            if key.endswith("length"):
                assert got == start + steps == int(want), key
                continue
            close(got, want[shard_slices(spec, r["coords"], mesh_shape,
                                         want.shape)])
            n += 1
    assert n


def whole_shape(spec, local, mesh_shape):
    out = []
    for d, axes in zip(local, spec):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            d *= mesh_shape[a]
        out.append(d)
    return tuple(out)


def hold_local_shapes(ref, ranks):
    """``init_cache(..., mesh=)``: each leaf at this rank's local shape of
    the whole leaf under the spec the placed cache has, filled as the
    reference's empty cache (zeros; an mLSTM / sLSTM ``m`` at -1e9), and
    no tensor of a sharded leaf's whole shape made."""
    mesh_shape = mesh_shape_of(ranks)
    sharded = 0
    for r in ranks:
        placed = {(k, a): spec for k, a, _, spec in r["cache"]}
        made = set(r["made"])
        for key, at, t, spec in r["fresh"]:
            assert spec == placed[(key, at)], key
            if key.endswith("length"):
                assert t == 0
                continue
            whole = ref_leaf(ref, "cache0", key, at).shape
            assert whole_shape(spec, t.shape, mesh_shape) == whole, key
            fill = -1e9 if key.endswith("/m") else 0.0
            assert (t == np.float32(fill)).all(), key
            if t.shape != whole:
                sharded += 1
                assert whole not in made, (key, whole)
    assert sharded


def sp_expected(rank, steps):
    """The ``sp_decode_attention`` calls of a decode whose caches are laid
    out as this rank's: one a step for each KV cache (and each layer of
    the whisper memory) whose slots the spec shards."""
    n = 0
    for key, at, t, spec in rank["cache"]:
        if key.split("/")[-1] not in ("k", "mem_k") or not spec[-3]:
            continue
        n += t.shape[0] if key == "mem_k" else 1
    return n * steps


def hold_one_rank(one):
    plain, mesh = one["plain"], one["mesh"]
    for key in ("prefill", "logits", "tokens"):
        assert mesh[key].tobytes() == plain[key].tobytes(), key
    assert [(k, a) for k, a, _ in mesh["cache"]] == [
        (k, a) for k, a, _ in plain["cache"]]
    for (k, a, got), (_, _, want) in zip(mesh["cache"], plain["cache"]):
        if isinstance(want, int):
            assert got == want, k
        else:
            assert got.tobytes() == want.tobytes(), (k, a)


def serve_suite(archs, extras=False):
    """The module-scoped ``runs`` fixture and the tests of ``archs`` on each
    mesh of MESHES (a test module assigns them to its names)."""
    cases = pytest.mark.parametrize(
        "arch,mesh", [(a, mesh_name(s)) for a in archs for s in MESHES])

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        return run(tmp_path_factory.mktemp("dist_serve"), archs, extras)

    def view(runs, arch, mesh):
        ref, ranks, _ = runs
        pre = f"{arch}/{mesh}/"
        mine = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
        mine.update({k[len(arch) + 1:]: v for k, v in ref.items()
                     if k.startswith(f"{arch}/cache0/")
                     or k in (f"{arch}/start", f"{arch}/steps")})
        return mine, [r[f"{arch}/{mesh}"] for r in ranks]

    @cases
    def test_prefill_logits(runs, arch, mesh):
        hold_prefill(*view(runs, arch, mesh))

    @cases
    def test_decode_logits_and_tokens(runs, arch, mesh):
        hold_decode(*view(runs, arch, mesh))

    @cases
    def test_cache_slices(runs, arch, mesh):
        ref, ranks = view(runs, arch, mesh)
        hold_cache(ref, ranks, int(ref["start"]), int(ref["steps"]))

    @cases
    def test_sequence_sharded_decode_calls_sp(runs, arch, mesh):
        ref, ranks = view(runs, arch, mesh)
        for r in ranks:
            assert r["sp_calls"] == sp_expected(r, int(ref["steps"]))

    @cases
    def test_fresh_cache_has_local_shapes_only(runs, arch, mesh):
        hold_local_shapes(*view(runs, arch, mesh))

    @pytest.mark.parametrize("arch", archs)
    def test_one_rank_mesh_is_the_one_process_step(runs, arch):
        hold_one_rank(runs[2][arch])

    @pytest.mark.parametrize("arch", archs)
    def test_mesh_step_regathers_weights_changed_in_place(runs, arch):
        plain, mesh = runs[2][arch]["plain"], runs[2][arch]["mesh"]
        assert (plain["prefill_regathered"].tobytes()
                != plain["prefill"].tobytes())
        assert (mesh["prefill_regathered"].tobytes()
                == plain["prefill_regathered"].tobytes())

    return (runs, view, test_prefill_logits, test_decode_logits_and_tokens,
            test_cache_slices, test_sequence_sharded_decode_calls_sp,
            test_fresh_cache_has_local_shapes_only,
            test_one_rank_mesh_is_the_one_process_step,
            test_mesh_step_regathers_weights_changed_in_place)


def spec_of(rank, name):
    """The spec of the cache leaf ``name`` (its key) at its first place."""
    return next(spec for key, _, _, spec in rank["cache"] if key == name)

