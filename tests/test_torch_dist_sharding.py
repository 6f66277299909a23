"""The port's sharding rules against the reference's, on shapes alone (no
processes, no devices).

Every parameter of all ten configs at full width (the port's modules on
the ``meta`` device, the reference's ``init`` through ``eval_shape``),
the inputs of ``train_4k``, ``prefill_32k``, ``decode_32k`` and
``long_500k`` and the caches of the two decode shapes (the port's built
under ``FakeTensorMode``: shapes without storage) where
``shape_applicable`` allows them, on the meshes (16,16), (2,16,16),
(2,4), (4,2) and (1,1).  The reference's rules run on an ``AbstractMesh``
(they read only ``mesh.shape``), the port's on a ``launch.mesh.Mesh``
with no process groups.  JAX spells a one-axis tuple as the axis name; a
spec is compared with every entry as a tuple of names.

A port parameter is one layer's tensor of a leaf the reference stacks,
and a port cache is one layer's: the port's spec must be the reference's
with the stacked leading dimensions dropped, and the reference must leave
those dimensions unsharded.  One difference is the reference's
(ROADMAP.md §3): ``cache_shardings`` takes the first dimension equal to
the batch for the batch, and on its stacked caches that can be the
layer axis (``test_reference_takes_a_layer_axis_for_the_batch``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as ref_config
from repro.distributed import sharding as RSH
from repro.models import build as ref_build
from repro.models import model as RMOD
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, reduced, \
    shape_applicable
from repro_torch.distributed import sharding as PSH
from repro_torch.launch.mesh import (MULTIPOD_SHAPE, POD_SHAPE, Mesh,
                                     make_production_mesh)
from repro_torch.models import build
from repro_torch.models import model as PMOD
from repro_torch.models.convert import tree_path
from repro_torch.models.encdec import EncDec
from repro_torch.models.transformer import Decoder

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}
DECODE = ("decode_32k", "long_500k")


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), Mesh(dict(zip(axes, shape)))


def norm(spec, ndim=None):
    """Each entry as a tuple of axis names (None unsharded), padded with
    None to ``ndim``."""
    out = tuple(None if e is None else ((e,) if isinstance(e, str)
                                        else tuple(e)) for e in spec)
    return out if ndim is None else out + (None,) * (ndim - len(out))


@functools.lru_cache(maxsize=None)
def ref_param_shapes(arch):
    tree = jax.eval_shape(ref_build(ref_config(arch)).init,
                          jax.random.PRNGKey(0))
    return {RSH._path_str(p): tuple(leaf.shape)
            for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def port_module(arch):
    cfg = get_config(arch)
    return (EncDec if cfg.encoder_decoder else Decoder)(cfg, device="meta")


def cache_shape(arch, shape_name):
    sh = SHAPES[shape_name]
    cfg = get_config(arch)
    kw = {"mem_len": sh.seq_len} if cfg.encoder_decoder else {}
    ref = jax.eval_shape(lambda: ref_build(ref_config(arch)).init_cache(
        sh.global_batch, sh.seq_len, dtype=jnp.bfloat16, **kw))
    with FakeTensorMode():
        port = build(cfg, device="cpu").init_cache(
            sh.global_batch, sh.seq_len, torch.bfloat16, **kw)
    return sh, ref, port


def cache_pairs(port, ref, ref_spec, port_spec, at=()):
    """``(port tensor, ref leaf, ref spec, port spec, at)`` for every tensor
    of a port cache: ``at`` is its index on the stacked axes of the
    reference's leaf (a port list where the reference stacks)."""
    if isinstance(port, torch.Tensor):
        yield port, ref, ref_spec, port_spec, at
    elif isinstance(port, tuple) and hasattr(port, "_fields"):
        for f in port._fields:
            yield from cache_pairs(getattr(port, f), getattr(ref, f),
                                   getattr(ref_spec, f),
                                   getattr(port_spec, f), at)
    elif isinstance(port, list) and isinstance(ref, list):
        for p, r, rs, ps in zip(port, ref, ref_spec, port_spec, strict=True):
            yield from cache_pairs(p, r, rs, ps, at)
    elif isinstance(port, list):
        for i, (p, ps) in enumerate(zip(port, port_spec, strict=True)):
            yield from cache_pairs(p, ref, ref_spec, ps, at + (i,))
    elif isinstance(port, dict):
        assert set(port) == set(ref)
        for k in port:
            yield from cache_pairs(port[k], ref[k], ref_spec[k],
                                   port_spec[k], at)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    cfg = get_config(arch)
    module = port_module(arch)
    leaves = ref_param_shapes(arch)
    got = PSH.param_shardings(module, port_mesh, cfg.n_experts)
    seen = set()
    for name, p in module.named_parameters():
        keys, at = tree_path(name)
        path = "/".join(map(str, keys))
        seen.add(path)
        stacked = leaves[path]
        assert stacked[len(at):] == tuple(p.shape), (name, stacked)
        want = norm(RSH.param_spec(path, stacked, ref_mesh, cfg.n_experts),
                    len(stacked))
        assert want[:len(at)] == (None,) * len(at), (path, want)
        assert norm(got[name], p.dim()) == want[len(at):], (name, want)
    assert seen == set(leaves)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_the_reference(arch):
    cfg = get_config(arch)
    for name, sh in SHAPES.items():
        if not shape_applicable(arch, name):
            continue
        decode = sh.kind == "decode"
        ref = (RMOD.decode_input_specs if decode else RMOD.input_specs)(
            ref_config(arch), sh)
        got = (PMOD.decode_input_specs if decode else PMOD.input_specs)(
            cfg, sh)
        assert {k: (tuple(v.shape), np.dtype(v.dtype).name)
                for k, v in ref.items()} == {
            k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()}, name
        assert all(v.device.type == "meta" for v in got.values())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_shardings_equal_the_reference(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    cfg = get_config(arch)
    for name, sh in SHAPES.items():
        if not shape_applicable(arch, name):
            continue
        decode = sh.kind == "decode"
        ref_in = (RMOD.decode_input_specs if decode else RMOD.input_specs)(
            ref_config(arch), sh)
        port_in = (PMOD.decode_input_specs if decode else PMOD.input_specs)(
            cfg, sh)
        want = RSH.batch_shardings(ref_in, ref_mesh)
        got = PSH.batch_shardings(port_in, port_mesh)
        assert set(got) == set(want)
        for k, v in ref_in.items():
            w = norm(want[k].spec)
            assert norm(got[k]) == (norm(w, len(v.shape)) if w else w), \
                (name, k)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_equal_the_reference(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    cfg = get_config(arch)
    n = 0
    for name in DECODE:
        if not shape_applicable(arch, name):
            continue
        sh, ref, port = cache_shape(arch, name)
        want = RSH.cache_shardings(ref, ref_mesh, sh.global_batch,
                                   cfg.n_kv_heads)
        got = PSH.cache_shardings(port, port_mesh, sh.global_batch,
                                  cfg.n_kv_heads)
        for t, leaf, ws, gs, at in cache_pairs(port, ref, want, got):
            assert tuple(leaf.shape) == tuple(leaf.shape[:len(at)]) + tuple(
                t.shape)
            w = norm(ws.spec, len(leaf.shape))
            assert w[:len(at)] == (None,) * len(at), (name, leaf.shape, w)
            assert norm(gs, t.dim()) == w[len(at):], (name, leaf.shape, w)
            n += 1
    assert n > 0


def test_granite_kv1_shards_the_sequence():
    """The reference's test_cache_shardings_decode: granite-20b has one KV
    head, so its KV caches take the model axis on the sequence."""
    cfg = get_config("granite-20b")
    with FakeTensorMode():
        cache = build(cfg, device="cpu").init_cache(128, 1024,
                                                    torch.bfloat16)
    specs = PSH.cache_shardings(cache, meshes("2x4")[1], 128,
                                cfg.n_kv_heads)
    kv = [(c.k, s.k) for seg, segs in zip(cache, specs)
          for c, s in zip(seg, segs)]
    assert kv
    for t, spec in kv:
        assert t.shape[-2] == cfg.n_kv_heads
        assert spec == (("data",), "model", None, None)


def test_reference_takes_a_layer_axis_for_the_batch():
    """A fault of the reference (ROADMAP.md §3): minitron-4b's 32 layers
    decoding 32 sequences on (2, 4).  The reference's stacked KV cache is
    (32 layers, 32, T, 8, 128), and the first dimension equal to the
    batch is the layer axis: it shards the layers over ``data`` and
    leaves the batch whole.  The port's per-layer cache shards the
    batch."""
    cfg = get_config("minitron-4b")
    B, T = 32, 1024
    ref = jax.eval_shape(lambda: ref_build(ref_config(
        "minitron-4b")).init_cache(B, T, dtype=jnp.bfloat16))
    ref_mesh, port_mesh = meshes("2x4")
    want = RSH.cache_shardings(ref, ref_mesh, B, cfg.n_kv_heads)
    assert ref[0].k.shape == (32, B, T, 8, 128)
    assert norm(want[0].k.spec, 5) == (("data",), None, None, ("model",),
                                       None)
    with FakeTensorMode():
        port = build(cfg, device="cpu").init_cache(B, T, torch.bfloat16)
    got = PSH.cache_shardings(port, port_mesh, B, cfg.n_kv_heads)
    assert got[0][0].k == (("data",), None, "model", None)


def test_production_meshes_are_shapes_without_groups():
    pod, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert tuple(pod.shape.values()) == POD_SHAPE
    assert pod.axis_names == ("data", "model")
    assert tuple(multi.shape.values()) == MULTIPOD_SHAPE
    assert multi.axis_names == ("pod", "data", "model")
    assert PSH.dp_axes(multi) == ("pod", "data")
    assert PSH.dp_axes(pod) == ("data",)
    assert PSH.axis_size(pod, "pod") == 1 and multi.size == 512
    with pytest.raises(RuntimeError, match="no process groups"):
        pod.group("data")


def test_param_shardings_cover_and_divide():
    """The reference's test_param_shardings_cover_tree on the port: reduced
    olmoe on (2, 4), every sharded dimension divisible and the rules
    firing on more than ten dimensions."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    module = Decoder(cfg, device="meta")
    mesh = meshes("2x4")[1]
    specs = PSH.param_shardings(module, mesh, cfg.n_experts)
    n_sharded = 0
    for name, p in module.named_parameters():
        assert len(specs[name]) == p.dim()
        for dim, axes in zip(p.shape, specs[name]):
            if axes:
                assert dim % mesh.axis_size(axes) == 0, (name, specs[name])
                n_sharded += 1
    assert n_sharded > 10
