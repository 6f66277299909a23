#!/usr/bin/env python3
"""Up to what size the reference's graph builders give a navigable graph,
and what the ``kernel_min`` gate does there, on one CUDA card.

    PYTHONPATH=src python3 tools/graph_ladder.py --ns 20000 50000 1000000

For each n of ``--ns``, builds every spec of ``--specs`` on the card over
the first n vectors of ``chip_smoke.py``'s graph base (deep-like, seed 0,
``max(--ns)`` vectors, 1000 queries) and serves the queries through
``AnnService`` as ``chip_smoke.py`` does (4-query requests,
``max_batch=64``, ef = 32, top-10, cold then warm).  Prints, after the
card's name and power limit, one JSON line a build: the nodes a search
can reach from the entry, recall@10 against exact search, the warm pass;
and, for the first spec, one line a warm pass at each ``kernel_min`` of
``chip_smoke.GRAPH_GATES`` in turns, ``--rounds`` times
(``chip_smoke.gate_passes``: QPS, search seconds, steps and the
``l2_dist`` launches by tile, the smallest gate's counting every step),
then the median of each gate's passes.  ``chip_smoke.GRAPH_NAV_N``, its
floors and ``graph_scan.KERNEL_MIN_CUDA`` are read from this table.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import chip_smoke as cs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ns", type=int, nargs="+",
                    default=[20_000, 50_000, 100_000, 200_000, 1_000_000])
    ap.add_argument("--specs", nargs="+", default=list(cs.GRAPH_SPECS))
    ap.add_argument("--rounds", type=int, default=cs.GRAPH_GATE_ROUNDS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("graph_ladder: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.data import make_dataset

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    base, queries = make_dataset(cs.GRAPH_PRESET, max(args.ns), 1000, seed=0)
    base_dev = torch.from_numpy(base).to(dev)
    queries_dev = torch.from_numpy(queries).to(dev)
    for n in sorted(args.ns):
        gt = cs.exact_topk(base_dev[:n], queries_dev, cs.TOPK)
        for spec in args.specs:
            rep, _, _, idx, _ = cs.serve_graph(spec, base[:n], queries, gt,
                                               [], dev)
            print(json.dumps({k: rep[k] for k in (
                "spec", "n", "build_s", "edges", "bits_per_edge",
                "reachable_from_entry", "reachable_share",
                "recall_at_10")} | {"warm": {k: rep["warm"][k] for k in (
                    "qps", "p50_latency_ms", "p99_latency_ms", "search_s",
                    "steps")}}), flush=True)
            if spec == args.specs[0]:
                rows, summary = cs.gate_passes(spec, idx, queries,
                                               cs.GRAPH_GATES, dev,
                                               args.rounds)
                for r in rows:
                    print(json.dumps(dict(r, spec=spec, n=n, tiles={
                        f"{nq}x{m}": c for (nq, m), c in r["tiles"].items()
                    })), flush=True)
                print(json.dumps(dict(spec=spec, n=n, gates=summary)),
                      flush=True)
            del idx
    return 0


if __name__ == "__main__":
    sys.exit(main())
