"""Quickstart on the PyTorch port: one factory string per index, lossless
ids, save/load.

The steps of ``examples/quickstart.py`` through ``repro_torch``: builds
IVF indexes through ``repro_torch.api.index_factory`` (one spec string
selects the structure, the id codec and the payload coding), checks that
search results are bit-identical across codecs, round-trips one index
through the RIDX container (``save_index``/``load_index``) and serves a
graph index through the same API.  On the card (the default) the CUDA
kernels run: ``l2_top1`` in k-means and PQ encoding, ``l2_dist`` and
``seg_topk`` in the scan, ``pq_adc`` for PQ codes.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 100000] [--queries 100]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 8000 --graph-n 1500
"""

import argparse

import numpy as np

from repro_torch.api import index_factory, load_index, save_index
from repro_torch.data.synthetic import make_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--nlist", type=int, default=256)
    ap.add_argument("--graph-n", type=int, default=0,
                    help="also build an NSG index on this many points "
                         "(0 = skip; O(n^2) build)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    print(f"building dataset ({args.n} x 96)...")
    base, queries = make_dataset("deep-like", args.n, args.queries, seed=0)

    # -- one spec string per row of the paper's Table 1 ---------------------
    ref = None
    print(f"\n{'spec':>34} {'bits/id':>8} {'vs compact':>10} {'search ms':>10} "
          f"{'identical':>9}")
    for codec in ["unc64", "compact", "ef", "roc", "gap_ans", "wt", "wt1"]:
        spec = f"IVF{args.nlist},ids={codec}"
        idx = index_factory(spec, device=dev).build(base, seed=1)
        dists, ids, st = idx.search(queries, k=10, nprobe=8)
        if ref is None:
            ref = ids
        same = bool(np.array_equal(ids, ref))
        compact = np.ceil(np.log2(len(base)))
        bpe = idx.ivf.bits_per_id()
        print(f"{spec:>34} {bpe:8.2f} {bpe/compact:9.1%} "
              f"{st.wall_s/len(queries)*1e3:10.3f} {str(same):>9}")
    print("\nAll codecs return identical results — compression is lossless.")

    # -- save/load: the RIDX container round-trips losslessly ---------------
    spec = f"IVF{args.nlist},PQ8x8,ids=roc,codes=polya"
    idx = index_factory(spec, device=dev).build(base, seed=1)
    d0, i0, _ = idx.search(queries, k=10)
    blob = save_index(idx)
    idx2 = load_index(blob, device=dev)
    d1, i1, _ = idx2.search(queries, k=10)
    if not (np.array_equal(i0, i1) and np.array_equal(d0, d1)):
        raise RuntimeError(f"{spec}: search differs after save/load")
    led = idx.memory_ledger()
    print(f"\nsave/load ({spec}):")
    print(f"  container: {len(blob)/1e6:.2f} MB on disk "
          f"(ids+codes in RAM: {(led['ids_bytes']+led['payload_bytes'])/1e6:.2f} MB, "
          f"uncompressed: {(led['ids_bytes_unc64']+led['payload_bytes_unc'])/1e6:.2f} MB)")
    print("  reloaded index returns bit-identical results.")

    # -- the same front door serves graph indexes ---------------------------
    if args.graph_n:
        gbase = base[: args.graph_n]
        gidx = index_factory("NSG16,ids=roc", device=dev).build(gbase, seed=1)
        gd, gi, gst = gidx.search(queries, k=10, ef=32)
        blob = save_index(gidx)          # friend lists via webgraph-lite
        gidx2 = load_index(blob, device=dev)
        gd2, gi2, _ = gidx2.search(queries, k=10, ef=32)
        if not (np.array_equal(gi, gi2) and np.array_equal(gd, gd2)):
            raise RuntimeError("NSG16,ids=roc: search differs after reload")
        print(f"\nNSG16,ids=roc on {args.graph_n} pts: "
              f"{gidx.graph.bits_per_edge():.2f} bits/edge, "
              f"{gst.visited} nodes visited, container {len(blob)/1e3:.0f} KB "
              "— same search API, bit-identical after reload.")


if __name__ == "__main__":
    main()
