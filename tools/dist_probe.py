#!/usr/bin/env python3
"""What torch.distributed does with two ranks on one CUDA card.

    python3 tools/dist_probe.py            # needs one CUDA card

Two questions behind ``repro_torch.distributed.compat``'s choices, each
call answered by two ranks spawned on cuda:0 in a world of their own (a
``file://`` rendezvous, a timeout that kills them):

1. gloo: which collectives take CUDA tensors.  Each collective is called
   directly (not through ``compat``) on a CUDA tensor; each rank prints
   ``ok`` and whether the result is right, the exception's text, or how
   its process died (a call may abort it).
2. NCCL: does it take two ranks on one device.  One ``all_reduce`` of a
   CUDA tensor, answered the same way.

Prints one JSON object a line per rank and call, then the card's name and
power limit (``nvidia-smi``).  An exception or a death is the answer
here, not a failure: the script exits 0 unless a call hung.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

TIMEOUT_S = 90
OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
       "reduce_scatter_tensor", "send_recv", "all_to_all_single",
       "batch_isend_irecv")


def _call(op, rank, x):
    import torch
    import torch.distributed as dist

    if op == "all_reduce":
        dist.all_reduce(x)
        return bool((x == 1).all())
    if op == "broadcast":
        dist.broadcast(x, src=0)
        return bool((x == 0).all())
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return bool((torch.cat(parts) == torch.tensor(
            [0.0] * 4 + [1.0] * 4, device=x.device)).all())
    if op == "all_gather_into_tensor":
        out = torch.empty(8, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return bool((out[4:] == 1).all() and (out[:4] == 0).all())
    if op == "reduce_scatter_tensor":
        out = torch.empty(2, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return bool((out == 1).all())
    if op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
            return True
        dist.recv(x, 0)
        return bool((x == 0).all())
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return bool((out == torch.tensor([0.0, 0, 1, 1],
                                         device=x.device)).all())
    if op == "batch_isend_irecv":
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1 - rank),
               dist.P2POp(dist.irecv, out, 1 - rank)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return bool((out == 1 - rank).all())
    raise ValueError(op)


def _rank(rank, backend, op, init, out):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            world_size=2, rank=rank)
    x = torch.full((4,), float(rank), device="cuda:0")
    try:
        res = dict(ok=True, right=_call(op, rank, x))
    except Exception as e:  # the answer to the question, recorded
        res = dict(ok=False, error=f"{type(e).__name__}: {e}"[:600])
    Path(out, f"{backend}.{op}.{rank}.json").write_text(json.dumps(res))
    if res["ok"]:
        dist.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("dist_probe: no CUDA device", file=sys.stderr)
        return 2
    rc = 0
    with tempfile.TemporaryDirectory() as tmp:
        for backend, op in [("gloo", op) for op in OPS] + [("nccl",
                                                           "all_reduce")]:
            init = Path(tmp, f"{backend}.{op}.init")
            ctx = mp.spawn(_rank, args=(backend, op, str(init), tmp),
                           nprocs=2, join=False)
            deadline, died = time.monotonic() + TIMEOUT_S, None
            try:
                while not ctx.join(timeout=5):
                    if time.monotonic() > deadline:
                        for p in ctx.processes:
                            p.kill()
                        died, rc = "hung: killed", 1
                        break
            except (mp.ProcessExitedException,
                    mp.ProcessRaisedException) as e:  # a death: an answer
                died = str(e)
            for r in range(2):
                f = Path(tmp, f"{backend}.{op}.{r}.json")
                got = json.loads(f.read_text()) if f.exists() else dict(
                    died=died)
                print(json.dumps(dict(backend=backend, op=op, rank=r,
                                      device="cuda:0", **got)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
