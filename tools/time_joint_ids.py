#!/usr/bin/env python3
"""Host time of the RIDX joint id stream: by halving and one op at a time.

    PYTHONPATH=src python3 tools/time_joint_ids.py --n 100000 --nlist 316

Seeds a partition of ``[n)`` into ``nlist`` clusters of uneven size (each
id assigned to a cluster drawn from a Zipf-like weight, as an IVF
partition is uneven), then packs and unpacks it with
``repro_torch.core.container.pack_joint_ids`` / ``unpack_joint_ids`` twice:
at the shipped ``LEAF_IDS`` (the halving) and with ``LEAF_IDS`` above n,
which makes the whole stream one leaf, so the coder is the sequential one.
Checks the two give the same bytes and the same lists, and prints one JSON
line a size with the seconds of each.  Pure numpy and Python integers: it
runs on the host alone.
"""

from __future__ import annotations

import argparse
import json
import platform
import time

import numpy as np

import repro_torch.core.container as cont


def partition(n: int, nlist: int, seed: int):
    rng = np.random.default_rng(seed)
    w = 1.0 / np.arange(1, nlist + 1) ** 0.5
    assign = rng.choice(nlist, size=n, p=w / w.sum())
    order = np.argsort(assign, kind="stable")
    cuts = np.searchsorted(assign[order], np.arange(1, nlist))
    return [np.sort(x) for x in np.split(order, cuts)]


def timed(leaf_ids: int, lists, n: int):
    saved = cont.LEAF_IDS
    cont.LEAF_IDS = leaf_ids
    try:
        t0 = time.perf_counter()
        raw = cont.pack_joint_ids(lists, n)
        t1 = time.perf_counter()
        back = cont.unpack_joint_ids(raw, [len(x) for x in lists], n)
        t2 = time.perf_counter()
    finally:
        cont.LEAF_IDS = saved
    return raw, back, t1 - t0, t2 - t1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[10000, 100000])
    ap.add_argument("--nlist", type=int, default=316)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for n in args.n:
        lists = partition(n, args.nlist, args.seed)
        raw_h, back_h, pack_h, unpack_h = timed(cont.LEAF_IDS, lists, n)
        raw_s, back_s, pack_s, unpack_s = timed(n + 1, lists, n)
        assert raw_h == raw_s, "halving and sequential bytes differ"
        for a, b, c in zip(back_h, back_s, lists):
            assert np.array_equal(a, b) and np.array_equal(a, c)
        print(json.dumps({
            "n": n, "nlist": args.nlist, "bytes": len(raw_h),
            "leaf_ids": cont.LEAF_IDS,
            "halving_pack_s": pack_h, "halving_unpack_s": unpack_h,
            "sequential_pack_s": pack_s, "sequential_unpack_s": unpack_s,
            "host": platform.processor() or platform.machine(),
            "python": platform.python_version()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
