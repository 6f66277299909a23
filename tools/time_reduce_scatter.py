#!/usr/bin/env python3
"""Where gloo's reduce-scatter of a CUDA gradient spends its time, beside
a sum and a slice.

    python3 tools/time_reduce_scatter.py            # needs one CUDA card
    python3 tools/time_reduce_scatter.py --reps 5 --out build/rs.json

The sharded train step reduces each gathered gradient back to this
rank's shard with ``compat.reduce_scatter`` (``distributed.fsdp``).  On
gloo that goes through the host: the CUDA tensor is copied down, moved
so the scattered dimension leads and made contiguous, reduce-scattered
by ``reduce_scatter_tensor``, moved back and copied up.  Two ranks
spawned on cuda:0 over gloo (as ``chip_smoke.py`` phase 18 runs them)
time, for each leaf shape below (gemma3-1b's largest at full width, f32,
on a (2, 1) mesh: the embedding table, an MLP kernel, an attention
kernel) and each dimension it is scattered on:

* ``reduce_scatter``: ``compat.reduce_scatter``, whole;
* its parts: ``to_host`` (``.cpu()``), ``movedim`` (``movedim(dim,
  0).contiguous()``), ``gloo_reduce_scatter`` (``reduce_scatter_tensor``
  on that host tensor), ``back`` (``movedim(0, dim).contiguous()`` and
  the copy up);
* ``psum_slice``: ``compat.psum`` (gloo's ``all_reduce`` takes the CUDA
  tensor and stages it itself) and this rank's block sliced out;
* ``staged_psum_slice``: the same sum of a host copy, sliced, copied up;
* ``gloo_all_reduce``: ``all_reduce`` alone on the host tensor.

Each is the median of ``--reps`` calls after one untimed call, on rank
0's host clock, the two ranks entering each call together (a barrier).
Every result is checked against the sum of the two ranks' inputs.
Prints one JSON object a line per shape and dimension, then the card's
name and power limit (``nvidia-smi``), and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"embed.table": (262144, 1152), "mlp.wi_gate": (1152, 6912),
          "attn.wq": (1152, 1024)}


def _rank(rank, world, init, reps, out):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compat

    compat.init_distributed(device="cuda:0", backend="gloo",
                            init_method=f"file://{init}", world_size=world,
                            rank=rank)
    group = dist.group.WORLD
    rows = []
    try:
        for name, shape in SHAPES.items():
            gen = torch.Generator().manual_seed(rank)
            g = torch.randn(shape, generator=gen).cuda()
            total = sum(torch.randn(shape, generator=torch.Generator()
                                    .manual_seed(r)) for r in range(world))
            for dim in (0, 1):
                want = total.chunk(world, dim)[rank]

                def staged_rs():
                    h = g.cpu()
                    src = h.movedim(dim, 0).contiguous()
                    o = src.new_empty((src.shape[0] // world,
                                       *src.shape[1:]))
                    dist.reduce_scatter_tensor(o, src, group=group)
                    return o.movedim(0, dim).contiguous().cuda()

                def psum_slice():
                    return compat.psum(g, group).chunk(world, dim)[
                        rank].contiguous()

                def staged_psum_slice():
                    h = g.cpu()
                    dist.all_reduce(h, group=group)
                    return h.chunk(world, dim)[rank].contiguous().cuda()

                calls = {
                    "reduce_scatter": lambda: compat.reduce_scatter(
                        g, group, dim=dim),
                    "psum_slice": psum_slice,
                    "staged_psum_slice": staged_psum_slice,
                }
                row = dict(leaf=name, shape=list(shape), dim=dim,
                           mb=g.numel() * g.element_size() / 1e6)
                for key, fn in calls.items():
                    got = fn()
                    if not torch.allclose(got.cpu(), want, atol=1e-5):
                        raise AssertionError(f"{key} of {name} on dim {dim} "
                                             "is not the sum's block")
                    row[key + "_ms"] = _median(fn, reps, g.device)
                if not torch.allclose(staged_rs().cpu(), want, atol=1e-5):
                    raise AssertionError("the parts are not the sum's block")
                # the parts of the host-staged reduce-scatter
                h = g.cpu()
                src = h.movedim(dim, 0).contiguous()
                o = src.new_empty((src.shape[0] // world, *src.shape[1:]))
                row["to_host_ms"] = _median(g.cpu, reps, g.device)
                row["movedim_ms"] = _median(
                    lambda: h.movedim(dim, 0).contiguous(), reps, None)
                row["gloo_reduce_scatter_ms"] = _median(
                    lambda: dist.reduce_scatter_tensor(o, src, group=group),
                    reps, None)
                row["back_ms"] = _median(
                    lambda: o.movedim(0, dim).contiguous().cuda(), reps,
                    g.device)
                row["gloo_all_reduce_ms"] = _median(
                    lambda: dist.all_reduce(h.clone(), group=group), reps,
                    None)
                rows.append(row)
            del g
            torch.cuda.empty_cache()
        if rank == 0:
            Path(out).write_text(json.dumps(rows))
    finally:
        dist.destroy_process_group()


def _median(fn, reps, device):
    import torch
    import torch.distributed as dist

    fn()
    times = []
    for _ in range(reps):
        dist.barrier()
        if device is not None:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        fn()
        if device is not None:
            torch.cuda.synchronize(device)
        times.append(1e3 * (time.perf_counter() - t))
    return statistics.median(times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="write the rows here as one JSON list")
    args = ap.parse_args(argv)
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        rows_at = Path(tmp) / "rows.json"
        mp.spawn(_rank, args=(2, str(Path(tmp) / "init"), args.reps,
                              str(rows_at)), nprocs=2, join=True)
        rows = json.loads(rows_at.read_text())
    for row in rows:
        print(json.dumps(row))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(rows=rows,
                                                  card=card.strip())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
