#!/usr/bin/env python3
"""The collectives of the reference's compiled mesh decode step, by op and
shape: what the JAX package's partitioner makes of the recurrent mixers'
states under its own ``cache_shardings``.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/ref_decode_collectives.py
    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/ref_decode_collectives.py \\
        --archs xlstm-1.3b --meshes 1x8

For each reduced config of ``--archs`` on each ``("data", "model")`` mesh
of ``--meshes``, on 8 fake CPU devices, as ``tests/_torch_dist_ref.py``'s
``serve`` sets it up (``init_decoder`` on ``PRNGKey(0)``, an f32 decode
cache of 32 slots for a batch of 8, ``param_shardings`` /
``cache_shardings`` / ``batch_shardings``): ``make_serve_step`` jitted and
compiled, and every collective of the optimised HLO counted by op and
result shape (``all-gather``, ``all-reduce``, ``all-to-all``,
``reduce-scatter``, ``collective-permute``), beside each cache leaf's
shape and sharding.  Prints one JSON object.  A reading of the reference
on the CPU: no time, no device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.distributed.sharding import (batch_shardings,  # noqa: E402
                                        cache_shardings, param_shardings)
from repro.launch.mesh import make_mesh_compat, use_mesh  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.train import step as RS  # noqa: E402

BATCH, MAX_LEN = 8, 32
OPS = ("all-gather", "all-reduce", "all-to-all", "reduce-scatter",
       "collective-permute")
# ``%name = f32[8,4,17,16]{...} all-gather(...)`` (also the -start forms)
LINE = re.compile(r"=\s*(\(?[a-z0-9]+\[[^=]*?\]\S*)\s+("
                  + "|".join(OPS) + r")(?:-start)?\(")


def collectives(hlo: str) -> dict:
    """``{op: {result shape: count}}`` over the HLO text."""
    out = collections.defaultdict(collections.Counter)
    for shape, op in LINE.findall(hlo):
        out[op][re.sub(r"\{[^}]*\}", "", shape)] += 1
    return {op: dict(c) for op, c in sorted(out.items())}


def leaves(tree, shard):
    """``{path: [shape, spec]}`` of a cache tree and its shardings."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    specs = jax.tree_util.tree_leaves(shard)
    return {jax.tree_util.keystr(p): [list(a.shape), str(s.spec)]
            for (p, a), s in zip(flat, specs)}


def one(arch: str, mesh_name: str) -> dict:
    cfg = reduced(get_config(arch))
    params0 = RT.init_decoder(jax.random.PRNGKey(0), cfg)
    cache0 = RT.init_decoder_cache(BATCH, MAX_LEN, cfg, jnp.float32)
    feed = {"token": jnp.zeros((BATCH, 1), jnp.int32)}
    _, serve_step = RS.make_serve_step(cfg)
    shape = tuple(int(n) for n in mesh_name.split("x"))
    mesh = make_mesh_compat(shape, ("data", "model"))
    with use_mesh(mesh):
        p_shard = param_shardings(jax.eval_shape(lambda: params0), mesh,
                                  cfg.n_experts)
        c_shard = cache_shardings(jax.eval_shape(lambda: cache0), mesh,
                                  BATCH, cfg.n_kv_heads)
        i_shard = batch_shardings(jax.eval_shape(lambda: feed), mesh)
        step = jax.jit(serve_step, in_shardings=(p_shard, c_shard, i_shard),
                       out_shardings=(None, c_shard))
        hlo = step.lower(params0, cache0, feed).compile().as_text()
    return dict(collectives=collectives(hlo),
                cache=leaves(cache0, c_shard))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--archs", default="zamba2-2.7b,xlstm-1.3b")
    ap.add_argument("--meshes", default="2x4,1x8")
    args = ap.parse_args(argv)
    if jax.device_count() < 8:
        raise SystemExit(f"needs 8 fake devices, has {jax.device_count()}")
    print(json.dumps({f"{arch} {m}": one(arch, m)
                      for arch in args.archs.split(",")
                      for m in args.meshes.split(",")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
