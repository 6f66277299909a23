#!/usr/bin/env python3
"""The selected xLSTM leaves' gathers on head groups, two ways, over gloo.

    PYTHONPATH=src python3 tools/head_group_gather.py [--reps 5] [--device cuda|cpu]

Where the model axis is ``g`` times xlstm's 4 heads, each model rank
computes with one head's parts of ``wq``, ``wk``, ``w_gates`` (and its
bias), ``wx`` (and its bias) and ``r`` (``sharding.compute_split``'s
``SELECT``).  Eight gloo ranks on a (1, 8) mesh (all on cuda:0 by
default, which raises without a card; ``--device cpu`` on the host)
move xlstm-1.3b's super-block's selected leaves (5 mLSTM, 1 sLSTM, at
full width, f32) as a train step does, each way, and count the calls
and bytes (``compat.STATS``, this rank's input) and the host ms of a
step:

* ``whole`` (what the port does): each leaf's model shard gathered
  whole over "model" (``distributed.fsdp``, once in the forward and once
  where the block is recomputed), its gradient ``psum``-ed whole over
  "model" (``tp.select``'s ``copy``) and this rank's shard sliced;
* ``groups``: ``wq`` / ``wk`` / ``w_gates`` and its bias gathered over
  the head's ``g`` ranks only (the rules store a head's columns on
  them), their gradients reduce-scattered over the same ranks; ``wx``,
  its bias and ``r`` as in ``whole``: the rules store ``wx``'s columns
  block by block and ``r`` on its ``4 hb`` columns, so the ranks that
  hold a head's parts are not that head's ranks (on tp = 8 head ``h``'s
  ``wx`` columns lie on ranks ``h // 2``, ``2 + h // 2``, ... and every
  rank holds a slice of every head's ``r``), and bringing a head's parts
  to its group takes an all-to-all.

Each rank prints one JSON line; rank 0 then prints the two ways' calls,
bytes and ms a step side by side, and the card's name and power limit
where there is one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import torch.multiprocessing as mp

MESH, WORLD = (1, 8), 8


def _leaves(cfg):
    """``(name, whole shape, dim the rules split on "model")`` of the
    super-block's selected leaves (one mLSTM's, five times; the sLSTM's)."""
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim_
    hb = d // H
    mlstm = [("wq", (d, H * hd), 1), ("wk", (d, H * hd), 1),
             ("w_gates", (d, 2 * H), 1), ("w_gates bias", (2 * H,), 0)]
    slstm = [("wx", (d, 4 * d), 1), ("wx bias", (4 * d,), 0),
             ("r", (H, hb, 4 * hb), 2)]
    return [(f"mlstm{i} {n}", s, dim) for i in range(5) for n, s, dim in
            mlstm] + [(f"slstm {n}", s, dim) for n, s, dim in slstm]


def _holders(cfg, name, shape, dim, tp, head):
    """The model ranks whose shards of the mLSTM leaf ``name`` hold head
    ``head``'s columns (its ``g`` ranks), None for the sLSTM's leaves."""
    if name.startswith("slstm"):
        return None
    per = shape[dim] // cfg.n_heads     # a head's columns, contiguous
    w = shape[dim] // tp
    return sorted({c // w for c in (head * per, head * per + per - 1)})


def _rank(rank, init, device, reps, out):
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.distributed import compat
    from repro_torch.distributed.tp import HeadGroup
    from repro_torch.launch.mesh import make_mesh_compat

    compat.init_distributed(device=device, backend="gloo",
                            init_method=f"file://{init}", world_size=WORLD,
                            rank=rank)
    dev = torch.device(device if device == "cpu" else "cuda:0")
    cfg = get_config("xlstm-1.3b")
    mesh = make_mesh_compat(MESH, ("data", "model"), device=dev)
    tp, idx = mesh.axis_size("model"), mesh.index("model")
    head = HeadGroup.of(idx, tp, cfg.n_heads).head
    model = mesh.group("model")
    leaves = _leaves(cfg)
    # every head's group of holders of each leaf, made on every rank alike
    groups = {}
    for name, shape, dim in leaves:
        key = name.split(" ", 1)[1]
        if key in groups:
            continue
        sets = [_holders(cfg, name, shape, dim, tp, h)
                for h in range(cfg.n_heads)]
        if sets[0] is None:
            groups[key] = None
            continue
        members = sorted({tuple(s) for s in sets})
        made = {m: dist.new_group(list(m)) for m in members}
        groups[key] = (made[tuple(sets[head])], sets[head])
    gen = torch.Generator().manual_seed(rank)
    shards = {}
    for name, shape, dim in leaves:
        local = list(shape)
        local[dim] //= tp
        shards[name] = torch.randn(local, generator=gen).to(dev)
    result = {}
    for way in ("whole", "groups"):
        ms = []
        for rep in range(reps + 1):
            compat.reset_stats()
            t = time.perf_counter()
            for name, shape, dim in leaves:
                key = name.split(" ", 1)[1]
                grp = groups[key] if way == "groups" else None
                for _ in range(2):      # forward and recomputation
                    if grp is None:
                        got = compat.all_gather(shards[name], model, dim=dim,
                                                axis="model")
                    else:
                        got = compat.all_gather(shards[name], grp[0],
                                                dim=dim)
                if grp is None:
                    compat.psum(torch.ones_like(got), model, axis="model")
                else:
                    compat.reduce_scatter(torch.ones_like(got), grp[0],
                                          dim=dim)
            if device != "cpu":
                torch.cuda.synchronize()
            if rep:                     # the first is a warm-up
                ms.append(1e3 * (time.perf_counter() - t))
        stats = compat.STATS.as_dict()
        result[way] = dict(
            calls=sum(v["calls"] for v in stats.values()),
            bytes=sum(v["bytes"] for v in stats.values()),
            ms=sum(ms) / len(ms))
    print(json.dumps(dict(rank=rank, head=head, **result)), flush=True)
    if rank == 0:
        torch.save(result, out)
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch

    from repro_torch.device import resolve_device

    resolve_device(args.device)     # raises for "cuda" without a card

    with tempfile.TemporaryDirectory() as tmp:
        out = f"{tmp}/rank0.pt"
        mp.spawn(_rank, args=(f"{tmp}/init", args.device, args.reps, out),
                 nprocs=WORLD)
        got = torch.load(out)
    print(json.dumps({"mesh": list(MESH), "a step (rank 0)": got}))
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())


if __name__ == "__main__":
    main()
