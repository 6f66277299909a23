"""End to end on the PyTorch port: serve any factory-built ANN index
(batched).

The steps of ``examples/serve_ann.py`` through ``repro_torch``: the
paper's deployment (§4.1), a RAM-resident index whose vector ids are
losslessly compressed and resolved only for the final top-k.  The index
is built from one ``--spec`` factory string (IVF, NSG/HNSW or Flat) and
requests stream through :class:`repro_torch.serve.AnnService`, which
micro-batches them (max-batch/max-wait policy) into the index's search
engine.  Reports recall@10 against exact search, QPS, batching and decode
stats, and the RAM ledger against the uncompressed layout.

    PYTHONPATH=src python examples/torch_serve_ann.py [--n 200000] [--queries 2000]
    PYTHONPATH=src python examples/torch_serve_ann.py --spec "IVF512,ids=ef" --cache-mb 16

With ``--shards N`` the built index is split by the shard planner and
served through :class:`repro_torch.shard.ShardedAnnService` (scatter and
merge, bit-identical to the monolithic service when healthy);
``--fault-rate p`` injects seeded random per-shard failures:

    PYTHONPATH=src python examples/torch_serve_ann.py --shards 4 --fault-rate 0.05

The index runs on the card unless ``--device cpu``.  ``--engine`` must
suit the device: ``pallas`` runs the CUDA kernels and ``xla`` the plain
torch versions, so ``xla`` raises on the card and ``pallas`` on the CPU;
``auto`` picks the device's own.
"""

import argparse
import time

import numpy as np

from repro_torch.api import index_factory
from repro_torch.data.synthetic import make_dataset
from repro_torch.serve import AnnService, BatchPolicy


def exact_topk(base, queries, k):
    out = np.zeros((len(queries), k), np.int64)
    for i in range(0, len(queries), 256):
        q = queries[i:i + 256]
        d = (np.sum(q**2, 1, keepdims=True) - 2 * q @ base.T
             + np.sum(base**2, 1)[None])
        out[i:i + 256] = np.argsort(d, 1)[:, :k]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--queries", type=int, default=1_000)
    ap.add_argument("--spec", default=None,
                    help="factory spec (default: IVF<nlist>,PQ<pq-m>x8,"
                         "ids=roc,codes=polya); e.g. 'NSG16,ids=roc'")
    ap.add_argument("--nlist", type=int, default=1024)
    ap.add_argument("--nprobe", type=int, default=16)
    ap.add_argument("--ef", type=int, default=32,
                    help="beam width for graph specs")
    ap.add_argument("--pq-m", type=int, default=8)
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="decoded-list cache budget (MB); default 64")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--request-size", type=int, default=4,
                    help="queries per client request")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "xla"])
    ap.add_argument("--shards", type=int, default=0,
                    help="split the index and serve via ShardedAnnService")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="seeded random per-shard failure probability "
                         "(needs --shards)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.fault_rate and not args.shards:
        ap.error("--fault-rate needs --shards")
    dev = args.device

    print(f"dataset: {args.n} x 128 (sift-like)")
    base, queries = make_dataset("sift-like", args.n, args.queries, seed=0)
    gt = exact_topk(base, queries, 10)

    spec = args.spec or f"IVF{args.nlist},PQ{args.pq_m}x8,ids=roc,codes=polya"
    print(f"building index: {spec}")
    idx = index_factory(spec, device=dev).build(base, seed=1)
    is_graph = hasattr(idx, "graph")
    is_ivf = hasattr(idx, "ivf")

    if is_graph:
        search_opts = {"ef": args.ef, "engine": args.engine}
    elif is_ivf:
        search_opts = {"nprobe": args.nprobe, "engine": args.engine}
    else:  # Flat takes no per-search knobs
        search_opts = {}
    policy = BatchPolicy(max_batch=args.max_batch, max_wait_s=0.002)
    if args.shards:
        from repro_torch.shard import (RandomFaults, ShardedAnnService,
                                       plan_shards)
        plan = plan_shards(idx, args.shards)
        sizes = ", ".join(str(s.n_local) for s in plan.shards)
        print(f"sharding: {args.shards} shards by {plan.by} "
              f"({sizes} vectors)")
        faults = (RandomFaults(args.fault_rate, seed=0)
                  if args.fault_rate else None)
        svc = ShardedAnnService(plan, topk=10, cache_mb=args.cache_mb,
                                policy=policy, fault_policy=faults,
                                device=dev, **search_opts)
    else:
        svc = AnnService(idx, topk=10, cache_mb=args.cache_mb,
                         policy=policy, device=dev, **search_opts)
    # warm up off the clock (and keep it out of the stats)
    svc.search(queries[: args.max_batch])
    svc.reset_stats()

    if is_graph:
        per_id = f"{idx.graph.bits_per_edge():.2f}b/edge"
    elif is_ivf:
        per_id = (f"{idx.ivf.bits_per_id():.2f}b ids, "
                  f"{idx.ivf.code_bits_per_element():.2f}b/code-elem")
    else:
        per_id = "raw f32 vectors"

    print(f"serving {args.queries} queries as {args.request_size}-query "
          f"requests (max_batch={args.max_batch})...")
    t0 = time.perf_counter()
    tickets = [svc.submit(queries[i:i + args.request_size])
               for i in range(0, len(queries), args.request_size)]
    svc.flush()  # drain the tail
    wall = time.perf_counter() - t0
    ids = np.concatenate([t.ids for t in tickets], axis=0)
    recall = np.mean([len(set(ids[i]) & set(gt[i])) / 10
                      for i in range(len(queries))])

    st = svc.stats()
    led = svc.memory_ledger()
    print(f"\nrecall@10 (vs exact): {recall:.3f}")
    print(f"throughput:           {len(queries)/wall:,.0f} QPS "
          f"({wall/len(queries)*1e3:.2f} ms/query)")
    print(f"micro-batching:       {st['batches']:.0f} batches, "
          f"mean {st['mean_batch']:.1f} q/batch, "
          f"p99 wait {st['p99_wait_s']*1e3:.2f} ms")
    print(f"id resolve overhead:  {st['resolve_s']/len(queries)*1e6:.0f} us/query "
          f"(late resolution, O(topk)); {st['decodes']:.0f} list decodes "
          f"for {st['queries']:.0f} queries")
    if args.shards:
        print(f"sharded serving:      {st['shards']:.0f} shards, "
              f"merge {st['merge_s']/max(st['search_s'],1e-12):.1%} of "
              f"search wall, p95 latency {st['p95_latency_s']*1e3:.2f} ms")
        print(f"degraded mode:        {st['partial_batches']:.0f}/"
              f"{st['batches']:.0f} partial batches, "
              f"{st['shards_failed']:.0f} shard failures, "
              f"{st['retries']:.0f} retries")
    print(f"\nRAM ledger (ids + codes):")
    print(f"  uncompressed (64b ids):  "
          f"{(led['ids_bytes_unc64'] + led['payload_bytes_unc'])/1e6:8.1f} MB")
    print(f"  compact ids:             "
          f"{(led['ids_bytes_compact'] + led['payload_bytes_unc'])/1e6:8.1f} MB")
    print(f"  this server:             {led['total_bytes']/1e6:8.1f} MB "
          f"({per_id}, decode cache {led['decoded_cache_bytes']/1e6:.1f} MB)")


if __name__ == "__main__":
    main()
