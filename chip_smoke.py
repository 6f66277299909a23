#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full size: 1M vectors a path
    python3 chip_smoke.py --n 200000      # a quicker, smaller run

Phases, each printed with its seconds; any failure raises and the script
exits non-zero without the final ``ok`` line:

1. environment: card name, power limit and top SM clock (``nvidia-smi``),
   torch/CUDA;
2. build: every kernel of ``src/repro_torch/csrc`` compiled by ``nvcc``
   (all sources in parallel) into the git-ignored ``build/``, with each
   kernel's registers and spills and its count of tensor-core MMA
   instructions in the SASS (``cuobjdump -sass``); ``l2_dist`` and
   ``l2_top1`` must have some;
3. kernels vs plain: each CUDA kernel against its plain torch version on
   the card — ``seg_topk`` bit-equal to the plain version run on a CPU copy
   (rows with ties, +inf, signed zeros and NaN of both signs) at n = 16384
   and 32768 and every k the scan's retry reaches, plus k = n; ``pq_adc``
   bitwise equal to the j-ordered f32 sum, with its lookup count, and at
   m = 256 (PQ256x8: two j-ordered launches, the second adding onto the
   first's partial sums) bitwise equal to the plain version;
   ``l2_dist``, ``pq_adc`` and ``l2_top1`` inside the scan's
   ``rescore_eps`` band (``l2_top1`` at the IVF1024 and PQ8x8 k-means
   shapes; ``band_use`` is the largest error over the band); ``rans_decode``
   bit-equal to the plain version run on a CPU copy on ``gap_ans``'s
   quotient model at (L, rows) = (128, 8192), (16, 64) and (1024, 1024),
   with ``step_cycles`` (one step at the top SM clock); ``wt_rank`` on a
   2^24-bit random bitvector (too large for shared memory: the global
   route) — with CUDA-event times (short
   kernels from a CUDA graph's replay, so the host's cost of each call is
   not counted), a roofline bound from this run's inputs (``l2_dist`` and
   ``l2_top1`` at the TF32 tensor-core rate, with the old SIMT f32 bound
   beside it as ``bound_f32_ms``) and one library call's time as a
   yardstick where there is one;
4. determinism: k-means (1024 centroids, 8 iterations) twice on the base
   vectors; the centroids must be bitwise equal;
5. main path: ``IVF1024,ids=roc`` and ``IVF1024,PQ8x8,ids=roc,codes=polya``
   built on the card from 1M ``sift-like`` vectors (k-means assignment and
   PQ encoding through ``l2_top1``) and served through ``AnnService``
   (4-query requests, ``max_batch=64``, ``nprobe=16``, top-10) twice,
   with the decoded-id cache cold and then warm; then an ingest pass: five
   ``add`` calls of 10,000 new vectors each (five epochs; two for the PQ
   spec, whose Pólya coding runs on the host), and the queries served
   again.  Every kernel's launch count (and the launch shapes:
   ``seg_topk`` by ``(n, k)``, ``l2_top1`` by ``(K, d, rows)``, the rows
   of ``pq_adc`` and ``l2_dist``) is set to 0 before the build and read
   after the last pass; results must equal ``search_ref`` exactly on the
   first 64 queries, before and after ingest;
6. Flat path: ``Flat`` on the card (``make_index("Flat")``) over the same
   1M vectors, serving the same queries through ``AnnService`` twice (the
   first pass uploads the base); every kernel's launch count set to 0
   before the build and read after; ids and dists equal to a CPU
   ``FlatIndex`` (the numpy loop) on the first 64 queries, and recall@10
   1.0 against exact search;
7. container path: ``save_index`` and ``load_index(device="cuda")`` of
   the ``IVF1024,ids=roc`` index after its ingest (six epochs) and of the
   Flat index, with pack and unpack seconds and blob MB; bits per id and
   epochs equal, and search after reload equal to search before over all
   queries (counts set to 0 before the path and read after);
8. sharded paths (``repro_torch.shard``), over the indexes built above,
   each counted on its own: the ``IVF1024,ids=roc`` index after its
   ingest planned onto 1, 2 and 4 shards by range and 4 by hash and served
   through ``ShardedAnnService`` cold (the monolith's decoded-id cache
   budget split across the shards) and warm, ids and dists equal to the
   monolith's on all queries, with QPS, p50/p99 and the merge share beside
   the monolith's warm QPS; one routed add of 10,000 vectors to the
   monolith and to both 4-shard services (every shard's n and epochs equal
   the monolith's, results equal); ``IVF1024,PQ8x8,ids=roc,codes=polya``
   over the first 100,000 vectors on 2 shards by hash (a host-bound cut:
   the planner re-encodes each shard's Pólya codes); Flat on 4 shards by
   hash, its plan saved and loaded onto the card (pack / unpack seconds,
   MB), equal before and after; an ``IVF1024,ids=roc`` plan over the first
   100,000 vectors saved and loaded (the joint ROC streams cost ~1 min at
   1M on the host), equal;
9. graph paths, on the reference's graph workload (1M ``deep-like``
   vectors, d = 96, seed 0, and its own 1000 queries): ``NSG32,ids=roc``
   built on the card (kNN through ``l2_dist`` + ``seg_topk``, the
   occlusion prune, the host's ROC coding, each timed; bits per edge, and
   the nodes a search can reach from the entry), served through
   ``AnnService`` (ef = 32) cold and warm, then grown by five ``add``
   calls of 10,000 vectors and served again; results equal to
   ``search_ref`` on the first 64 queries after each pass, recall@10
   against exact search.  One beam step's device path (copies, gather,
   ``l2_dist``, copy back) is timed against the host re-score of the same
   candidates at tiles of 64 x 128 .. 4096.  The reference's builders
   leave this base in pieces (a search reaches only the entry's mode), so
   ``NSG32`` is also built and served over the first ``GRAPH_NAV_N``
   vectors, where its graph is navigable: the reachable share and
   recall@10 must reach ``GRAPH_NAV_FLOOR``, and warm passes at each
   ``kernel_min`` of ``GRAPH_GATES`` in turns (results equal) give the
   reading behind ``graph_scan.KERNEL_MIN_CUDA`` and every step's tile
   width.  That navigable graph on 2 shards (each shard's graph rebuilt
   on the card), served through ``ShardedAnnService``: each shard equal to
   its own ``search_ref`` on 64 queries, the merge equal to an independent
   merge of the shards' results on all queries, the shards' reachable
   share and recall@10; and over its first 2000 vectors the reference's
   exhaustive regime (ef = 2048 >= n): the monolith and each shard return
   the exact top-10 over the nodes reachable from their entries, and the
   merge equals the monolith on every query whose exact top-10 is
   reachable in both (the other queries counted).  The card's decisions
   against the CPU's: the NSG32 and HNSW16
   prunes of the first 20,000 nodes' kNN lists (and NSG32's against the
   lists the 1M build made), HNSW's reverse edges on that subgraph (card,
   CPU and the reference's loop), ``knn_graph`` over 10,000 vectors
   (differing only inside ``rescore_eps``) and ``np_sum_f32`` (bit-equal
   to ``np.sum``).  ``HNSW16,ids=roc`` built over the 1M vectors and
   served cold and warm.  An ``NSG32,ids=roc`` index over the first
   100,000 vectors after one ``add`` saved with webgraph and REC edges
   and loaded onto the card (a host-only cut: the edge coders cost
   ~0.1-0.3 ms a node), search equal.  Every ``l2_dist`` tile and
   ``seg_topk`` ``(rows, n, k)`` these paths launched is held against its
   plain version and timed; each path's counts are set to 0 before it and
   read after.  Then the sharded degraded mode, after every counted path
   and not counted: a dead shard (``stats.partial``, none of its ids
   served) and a flaky one (full results after one retry);
10. main-path shapes: ``seg_topk`` at every ``(n, k)`` and ``l2_top1`` at
   every ``(K, d, rows)`` that phases 5-8 launched (each checked as in
   phase 3; at n = 2^20, Flat's width, the kernel reads its keys from
   global memory on every pass, and it is timed, bounded and set beside
   ``torch.topk`` on the block Flat gives it: the first 64 queries'
   distances to the padded base, lens = n on every row, held bit-equal
   as well), ``pq_adc`` and ``l2_dist`` at the IVF
   mean arena rows (``l2_dist`` at Flat's 2^20 rows in phase 3), and
   ``pq_adc`` / ``l2_dist`` at the sharded paths' mean arena rows and a
   Flat shard's padded rows; each
   kernel's ``main_path_ms`` is launches x time at the shape launched
   (the graph paths' launches at their tiles of phase 9 included);
11. kernel API path: ``wt_rank`` on level 0 of a wavelet tree over the flat
   index's assignment (2^20 positions, the resident route; bit-equal to
   ``BitVector`` and the plain version on a CPU copy) and ``rans_decode``
   on gap_ans-model streams at (128, 8192) and (16, 64) (bit-equal to the
   encoded symbols and the plain version).  No engine calls these two, so
   their launches (and ``wt_rank``'s routes) are counted here; the
   (1024, 1024) decode is timed in phase 3 and not counted.

The last four lines are the total of the phases' seconds, the card's
name and power limit (as ``nvidia-smi`` gives them), the ``kernels`` JSON
(one entry a kernel) and ``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the HBM3 rate; the
# non-tensor f32 rate of the SIMT kernels (pq_adc, seg_topk, wt_rank,
# rans_decode); and the dense TF32 tensor-core rate, at which l2_dist and
# l2_top1 run their dot products as three TF32 products (csrc/l2_mma.cuh)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 494.7e12
TF32_PRODUCTS = 3
# SASS mnemonics of the tensor-core MMA instructions (wgmma, mma.sync)
TENSOR_CORE_SASS = ("HGMMA", "HMMA")

SPECS = ("IVF1024,ids=roc", "IVF1024,PQ8x8,ids=roc,codes=polya")
NPROBE, TOPK, REQUEST, MAX_BATCH = 16, 10, 4, 64
NLIST = 1024
# l2_top1 at the k-means shapes of the main path: IVF1024 over ~1M
# 128-d rows, and one PQ8x8 subspace (256 centroids of 16 dims)
TOP1_SHAPES = ((1 << 20, NLIST, 128), (1 << 20, 256, 16))
INGEST_ADDS, INGEST_ROWS = 5, 10_000
# the PQ spec is grown by the first two adds only: each add's Pólya coding
# runs on the host (~20 s at 1M), a cut of depth that keeps the run with
# its sharded phases near 900 s of phases
PQ_INGEST_ADDS = 2
# seg_topk at two row widths and every k the scan's K-doubling retry
# reaches up to 2048 (and k = 16, the earlier kernel's shape), plus the
# retry's worst case k = n; the (n, k) the main path launched (at 1M
# sift-like rows, nprobe=16: n = 131072 and 262144) are added after it
SEG_NS = (16384, 32768)
SEG_KS = (16, 32, 64, 128, 256, 512, 1024, 2048)
# shared memory serves 32 four-byte words a clock on each SM
SMEM_WORDS_PER_CLOCK = 32
# rans_decode at (lanes, rows): 2^20 symbols, and one IVF1024 cluster at 1M
# (the kernel-API path); and eight decode warps at L = 1024, timed beside
# them but not counted in main_path_ms
RANS_SHAPES = ((128, 8192), (16, 64))
RANS_WIDE = (1024, 1024)
WT_QUERIES = 1 << 20
# wt_rank also on a bitvector too large for shared memory (the global route)
WT_LARGE_BITS = 1 << 24
# the graph paths run on the reference's graph workload, the deep-like
# preset (benchmarks/graph_bench.py:38; d = 96), seed 0, as many vectors
# and queries as the main path: NSG32 (the paper's Table 2 graph) at full
# scale, served and grown like the IVF specs; HNSW16 built and served; the
# card's decisions held against the CPU's on the first nodes; a graph
# container round trip on a host-only cut of the base (webgraph / REC
# coding is ~0.2-0.3 ms a node on the host)
GRAPH_PRESET = "deep-like"
GRAPH_SPECS = ("NSG32,ids=roc", "HNSW16,ids=roc")
GRAPH_EF = 32
# The reference's builders (exact kNN, the occlusion prune, no step that
# joins components) leave deep-like at 1M in pieces: from the entry a
# search reaches only the entry's Gaussian mode, whose points all have
# their 64 nearest neighbours inside it.  So NSG32 is served as well over
# the first GRAPH_NAV_N vectors, the most at which its graph is navigable
# (tools/graph_ladder.py), and must reach the floors below there; the
# kernel_min gate is read on that graph, in warm passes at each of
# GRAPH_GATES in turns (GRAPH_BLOCK_N: every step's tile on the kernel;
# the last: none)
GRAPH_NAV_N = 50_000
# (the ladder: reachable share 0.994-0.996 and recall@10 0.82-0.92 from
# 20,000 to 50,000 vectors; from 70,000 on, a search stays in one mode or
# recall falls to 0.36 and below)
GRAPH_NAV_FLOOR = dict(reachable_share=0.98, recall_at_10=0.75)
GRAPH_GATES = (128, 512, 1024, 2048, 1 << 30)
GRAPH_GATE_ROUNDS = 3
GRAPH_CHECK_NODES = 20_000
GRAPH_KNN_CHECK = 10_000
GRAPH_CONTAINER_N = 100_000
NPSUM_DIMS = (7, 24, 128, 129, 960)
# graph-step tiles (query rows, candidate columns) at which one step's
# device path is timed against the host re-score of the same candidates
STEP_TILES = tuple((64, n) for n in (128, 256, 512, 1024, 2048, 4096))
# the most elements of a beam step's l2_dist tile (64 rows x 4096)
STEP_TILE_MAX = 64 * 4096
# sharded serving (repro_torch.shard) over the indexes the paths above
# built: IVF1024,ids=roc after its ingest at 1, 2 and 4 shards by range and
# 4 by hash, then one routed add of SHARD_ADD_ROWS vectors; PQ over the
# first SHARD_PQ_N vectors (the planner re-encodes each shard's Pólya
# codes on the host: at 1M that costs about as much as the PQ build), 2
# shards by hash; Flat at full size, 4 by hash, its plan saved and loaded
# onto the card; an IVF plan saved and loaded over the first
# SHARD_CONTAINER_N vectors (the host's joint ROC streams cost ~1 min at
# 1M); the navigable NSG32 graph, 2 shards, and the reference's
# exhaustive regime (ef >= n) over its first SHARD_EXHAUSTIVE_N vectors
SHARD_IVF = ((1, "range"), (2, "range"), (4, "range"), (4, "hash"))
SHARD_ADD_ROWS = 10_000
SHARD_PQ_N = 100_000
SHARD_CONTAINER_N = 100_000
SHARD_GRAPH = 2
SHARD_EXHAUSTIVE_N = 2000
SHARD_EXHAUSTIVE_EF = 2048
SHARD_EXHAUSTIVE_Q = 128
# the time a run of this script may take, kernels' build included
RUN_LIMIT_S = 1200


class Phases:
    """The run's phase timer: ``with phases(name):`` prints the phase's
    start and, if it raised nothing, its seconds, which ``seconds`` keeps
    (their sum is the run's total of phase seconds)."""

    def __init__(self):
        self.seconds = []

    @contextlib.contextmanager
    def __call__(self, name):
        t = time.perf_counter()
        print(f"[phase] {name} ...", flush=True)
        yield
        s = time.perf_counter() - t
        self.seconds.append(s)
        print(f"[phase] {name} ok in {s:.3f} s", flush=True)


def cuda_ms(fn, reps=20, warmup=3, graph=False):
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up.

    ``graph=True`` captures the ``reps`` calls in one CUDA graph and times
    its replay, so a short kernel is timed without the host's cost of each
    call (the wrapper's checks, allocations and launch)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(reps):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes, nflops, peak=PEAK_F32_S):
    """(least time in ms, "bytes" | "operations") on the card's peaks, the
    operations at ``peak`` per second."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, nflops / peak * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def l2_bounds(nbytes, m, n, d):
    """Bounds of an (m, d) x (n, d) squared-L2 kernel: (ms, by) of the
    split-TF32 tensor-core design (three TF32 products of 2 m n d each),
    and the ms of the SIMT f32 design it replaced (the dot products, the
    norms and the 3-operation epilogue at the f32 rate)."""
    b, by = bound_ms(nbytes, TF32_PRODUCTS * 2 * m * n * d, PEAK_TF32_S)
    f32, _ = bound_ms(nbytes, 2 * m * n * d + 2 * (m + n) * d + 3 * m * n)
    return b, by, f32


def sass_tensor_core_count(lib_path):
    """Tensor-core MMA instructions in a built library's SASS, by
    ``cuobjdump -sass``: {mnemonic: count}."""
    from repro_torch.kernels import _build

    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass",
                           str(lib_path)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    ops = re.findall(r"\b(" + "|".join(TENSOR_CORE_SASS) + r")\.", sass)
    return {m: ops.count(m) for m in TENSOR_CORE_SASS}


def rescore_band(d, ref, qn):
    """The scan's ``rescore_eps(d, ref, qn)`` elementwise, as a tensor."""
    import torch

    eps32 = float(torch.finfo(torch.float32).eps)
    return 16.0 * d * eps32 * (1.0 + ref.abs().double() + qn)


def check_l2_dist(dev, gen, n=1 << 20, qb=64, d=128):
    import torch
    from repro_torch.kernels.l2_topk import l2_dist, l2_dist_ref

    q = torch.randn(qb, d, device=dev, generator=gen)
    a = torch.randn(n, d, device=dev, generator=gen)
    out = l2_dist(q, a)
    ref = l2_dist_ref(q, a)
    torch.cuda.synchronize()
    qn = (q.double() ** 2).sum(1, keepdim=True)
    err = (out.double() - ref.double()).abs()
    band_use = float((err / rescore_band(d, ref, qn)).max())
    if not band_use <= 1.0:
        raise AssertionError(f"l2_dist outside rescore_eps: max err "
                             f"{float(err.max())}, {band_use} of the band")
    qn32, an32 = (q * q).sum(1, keepdim=True), (a * a).sum(1)
    b, by, b32 = l2_bounds(4 * (qb * d + n * d + qb * n), qb, n, d)
    small = n < (1 << 16)        # a graph step's tile: time a graph replay
    return dict(
        name="l2_dist" if n == 1 << 20 else f"l2_dist(n={n})" if qb == 64
        else f"l2_dist({qb}x{n})", route="cuda",
        source="src/repro_torch/csrc/l2_dist.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:76",
        shape=f"q {qb}x{d}, arena {n}x{d} f32",
        max_abs_err=float(err.max()), band_use=band_use,
        ms=cuda_ms(lambda: l2_dist(q, a), graph=small),
        plain_ms=cuda_ms(lambda: l2_dist_ref(q, a), graph=small),
        bound_ms=b, bound_by=by, bound_f32_ms=b32,
        library_ms=cuda_ms(lambda: torch.addmm(an32[None], q, a.T,
                                               alpha=-2.0).add_(qn32),
                           graph=small))


def check_pq_adc(dev, gen, sm_hz, n=1 << 20, m=8):
    """pq_adc bitwise equal to a sequential j-ordered f32 sum (a loop over
    j on the card) and to the plain version (the same sum) and inside
    rescore_eps of it; with the lookup count (qb * n * m
    shared-memory words) and its time at 32 words a clock on every SM,
    beside the byte bound, and the launches one call makes (``chunks``:
    m >= 228 is scored as j-ordered chunks of tables)."""
    import torch
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_ref
    from repro_torch.kernels.pq_adc.ops import chunk_plan

    qb, d = 64, max(128, m)
    luts = torch.rand(qb, m, 256, device=dev, generator=gen) * 40.0
    codes = torch.randint(0, 256, (n, m), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    out = pq_adc(luts, codes)
    ref = pq_adc_ref(luts, codes)
    seq = torch.zeros(qb, n, device=dev)
    for j in range(m):
        seq += luts[:, j, codes[:, j].long()]
    torch.cuda.synchronize()
    if not torch.equal(out.view(torch.int32), seq.view(torch.int32)):
        raise AssertionError("pq_adc differs from the j-ordered f32 sum")
    if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError(f"pq_adc m={m} differs from the plain version")
    err = (out.double() - ref.double()).abs()
    if not bool((err <= rescore_band(d, ref, 0.0)).all()):
        raise AssertionError(f"pq_adc outside rescore_eps: max err "
                             f"{float(err.max())}")
    del seq
    # library yardstick: one embedding_bag sums rows lut[:, j, code[r, j]]
    # of an (m*256, qb) table, giving out.T (n, qb)
    bags = codes.long() + 256 * torch.arange(m, device=dev)
    table = luts.permute(1, 2, 0).reshape(m * 256, qb).contiguous()
    lib = torch.nn.functional.embedding_bag(bags, table, mode="sum")
    torch.cuda.synchronize()
    lib_err = (lib.T.double() - ref.double()).abs()
    if not bool((lib_err <= rescore_band(d, ref, 0.0)).all()):
        raise AssertionError(f"embedding_bag yardstick outside rescore_eps: "
                             f"max err {float(lib_err.max())}")
    b, by = bound_ms(4 * qb * m * 256 + n * m + 4 * qb * n, qb * n * m)
    lookups = qb * n * m
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(
        name=("pq_adc" if (n, m) == (1 << 20, 8) else f"pq_adc(n={n})"
              if m == 8 else f"pq_adc(m={m})"), route="cuda",
        source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:37",
        shape=f"luts {qb}x{m}x256 f32, codes {n}x{m} u8",
        chunks=len(chunk_plan(m)),
        max_abs_err=float(err.max()), bitwise_j_ordered=True,
        ms=cuda_ms(lambda: pq_adc(luts, codes), graph=True),
        plain_ms=cuda_ms(lambda: pq_adc_ref(luts, codes), reps=3, warmup=1),
        bound_ms=b, bound_by=by, lookups=lookups,
        lookup_ms=lookups / (SMEM_WORDS_PER_CLOCK * sms * sm_hz) * 1e3,
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            bags, table, mode="sum"), graph=True))


def seg_topk_inputs(dev, gen, qb=64, n=16384):
    """Random rows plus the edge rows: ties, +inf, -0.0/+0.0, lens < k,
    lens = 0, lens past n, and NaN of both signs and two payloads."""
    import torch

    d = torch.randn(qb, n, device=dev, generator=gen)
    lens = torch.randint(n // 2, n + 1, (qb,), device=dev, generator=gen,
                         dtype=torch.int32)
    d[1] = 1.0                                   # all tied
    d[2] = float("inf")                          # all +inf, full length
    d[3, ::2] = -0.0                             # signed zeros tie by column
    d[3, 1::2] = 0.0
    d[4, : n // 2] = torch.floor(d[4, : n // 2] * 4)   # duplicate values
    lens[5] = 5                                  # lens < k
    lens[6] = 0                                  # empty row
    lens[7] = n + 100                            # clamped to n
    d[8, 100:] = float("inf")                    # genuine +inf past a few hits
    bits = d[9].view(torch.int32)                # NaN: both signs, 2 payloads
    bits[1::7] = 0x7FC00000
    bits[2::7] = 0xFFC00000 - (1 << 32)
    bits[3::11] = 0x7FA00001
    lens[9] = n
    return d.contiguous(), lens.contiguous()


def seg_topk_held(d, lens, ks, n, what):
    """seg_topk at each k of ``ks`` on one (qb, n) block, bit-equal to the
    plain version run on a CPU copy (the card's stable sort orders NaN
    otherwise; whether it agrees is reported).  Returns {k: (max_abs_err,
    plain_on_card_agrees)}."""
    import torch
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    # the first k of one full stable sort are the plain version at k
    full_v, full_i = seg_topk_ref(d.cpu(), lens.cpu().clamp(max=n), n)
    held = {}
    for k in ks:
        v, i = seg_topk(d, lens, k)
        vr, ir = full_v[:, :k], full_i[:, :k]
        if not (torch.equal(v.cpu().view(torch.int32), vr.view(torch.int32))
                and torch.equal(i.cpu(), ir)):
            bad = (i.cpu() != ir).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"seg_topk n={n} k={k} on {what} differs "
                                 f"from the stable sort in rows {bad[:8]}")
        vc, ic = seg_topk_ref(d, lens.clamp(max=n), k)
        agrees = bool(torch.equal(vc.cpu().view(torch.int32),
                                  vr.view(torch.int32))
                      and torch.equal(ic.cpu(), ir))
        both = torch.isfinite(v) & torch.isfinite(vr.to(d.device))
        held[k] = (float(torch.where(both, (v - vr.to(d.device)).abs(),
                                     0.0).max()), agrees)
    return held


def check_seg_topk(dev, gen, shapes, flat=None):
    """seg_topk at each (n, k) of ``shapes``, bit-equal to the plain
    version on random rows with the edge rows (``seg_topk_inputs``); with a
    bound and a ``torch.topk`` yardstick at each shape, timed on those rows.
    ``flat`` = (dmat, lens), a (qb, n) block of Flat's own distances with
    every row's lens the index's rows: at its width n, seg_topk is held
    bit-equal on it too, and the time, the bound and ``torch.topk`` are
    taken on it, the input the Flat path gives the kernel.  Returns {(n,
    k): record}."""
    import torch
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    qb, rows = 64, {}
    for n in sorted({n for n, _ in shapes}):
        ks = sorted(k for m, k in shapes if m == n)
        d, lens = seg_topk_inputs(dev, gen, qb, n)
        held = seg_topk_held(d, lens, ks, n, "random and edge rows")
        timed_on = "random rows, lens in [n/2, n], edge rows"
        if flat is not None and flat[0].shape[1] == n:
            d, lens = flat
            on_flat = seg_topk_held(d, lens, ks, n, "Flat's distances")
            held = {k: (max(held[k][0], on_flat[k][0]),
                        held[k][1] and on_flat[k][1]) for k in ks}
            timed_on = (f"Flat's distances, {d.shape[0]} queries, lens = "
                        f"{int(lens[0])} on every row")
        live = int(lens.clamp(max=n).sum())
        masked = torch.where(
            torch.arange(n, device=dev)[None] < lens[:, None].clamp(max=n),
            d, torch.full((), float("inf"), device=dev))
        for k in ks:
            b, by = bound_ms(4 * live + 4 * qb + 8 * qb * k, live)
            reps = 5 if k > 4096 else 20
            rows[(n, k)] = dict(
                name=f"seg_topk(n={n},k={k})", route="cuda",
                source="src/repro_torch/csrc/seg_topk.cu",
                replaces="src/repro/kernels/seg_topk/kernel.py:71",
                shape=f"{qb}x{n} f32, k={k}", timed_on=timed_on,
                max_abs_err=held[k][0], plain_on_card_agrees=held[k][1],
                ms=cuda_ms(lambda: seg_topk(d, lens, k), reps=reps,
                           graph=True),
                plain_ms=cuda_ms(lambda: seg_topk_ref(d, lens, k),
                                 reps=reps),
                bound_ms=b, bound_by=by,
                library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1,
                                                      largest=False),
                                   reps=reps, graph=True))
        del masked
    return rows


def check_l2_top1(dev, gen, nq, k, d):
    """l2_top1 against its plain version: every row's index must be a
    nearest centroid inside ``rescore_eps`` of the plain minimum."""
    import torch
    from repro_torch.kernels.l2_topk import l2_dist_ref, l2_top1, l2_top1_ref
    from repro_torch.kernels.l2_topk.ref import TOP1_CHUNK

    q = torch.randn(nq, d, device=dev, generator=gen)
    c = torch.randn(k, d, device=dev, generator=gen)
    idx, val = l2_top1(q, c)
    ridx, rval = l2_top1_ref(q, c)
    torch.cuda.synchronize()
    band = rescore_band(d, rval, (q.double() ** 2).sum(1))
    at = torch.cat([
        l2_dist_ref(q[i:i + TOP1_CHUNK], c).gather(
            1, idx[i:i + TOP1_CHUNK].long()[:, None])[:, 0]
        for i in range(0, nq, TOP1_CHUNK)])
    if not bool(((at.double() - rval.double()).abs() <= band).all()):
        raise AssertionError(f"l2_top1 ({nq}, {k}, {d}): an index is not a "
                             "nearest centroid inside rescore_eps")
    err = (val.double() - rval.double()).abs()
    band_use = float((err / band).max())
    if not band_use <= 1.0:
        raise AssertionError(f"l2_top1 ({nq}, {k}, {d}) values outside "
                             f"rescore_eps: max err {float(err.max())}, "
                             f"{band_use} of the band")
    cn = (c * c).sum(1)[None]

    def chunked_addmm_min():
        # the yardstick: assign's chunked addmm + min before the kernel
        for i in range(0, nq, TOP1_CHUNK):
            sl = q[i:i + TOP1_CHUNK]
            torch.addmm(cn, sl, c.T, alpha=-2.0).add_(
                (sl * sl).sum(1, keepdim=True)).min(1)

    b, by, b32 = l2_bounds(4 * (nq * d + k * d + 2 * nq), nq, k, d)
    return dict(
        name="l2_top1" if (k, d) == (NLIST, 128) else f"l2_top1(K={k},d={d})",
        route="cuda", source="src/repro_torch/csrc/l2_top1.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:39",
        shape=f"rows {nq}x{d}, centroids {k}x{d} f32",
        max_abs_err=float(err.max()), band_use=band_use,
        idx_differ=int((idx != ridx).sum()),
        ms=cuda_ms(lambda: l2_top1(q, c), reps=10),
        plain_ms=cuda_ms(lambda: l2_top1_ref(q, c), reps=5, warmup=1),
        bound_ms=b, bound_by=by, bound_f32_ms=b32,
        library_ms=cuda_ms(chunked_addmm_min, reps=5, warmup=1))


def rans_stream(lanes, rows, seed):
    """(symbols (rows, lanes), heads, words, tables, r) on gap_ans's own
    quotient model, encoded by the port's 32/16 coder."""
    import numpy as np
    from repro_torch.core import gap_ans
    from repro_torch.core.vrans import VRans16Encoder
    from repro_torch.kernels.rans_decode import make_tables

    r, freqs, starts = gap_ans._Q_PRECISION, gap_ans._QF, gap_ans._QC
    rng = np.random.default_rng(seed)
    data = rng.choice(gap_ans._Q_SYMBOLS, size=(rows, lanes),
                      p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    return data, heads, words, make_tables(freqs, r), r


def rans_args(dev, heads, words, tables):
    import numpy as np
    import torch

    return [torch.from_numpy(heads.view(np.int32)).to(dev),
            torch.from_numpy(words.astype(np.int32)).to(dev),
            *(torch.from_numpy(t).to(dev) for t in tables)]


def check_rans_decode(dev, lanes, rows, sm_hz):
    """rans_decode bit-equal to the plain step loop run on a CPU copy and to
    the symbols; ``step_cycles`` is one step's time at the top SM clock."""
    import numpy as np
    import torch
    from repro_torch.kernels.rans_decode import rans_decode, rans_decode_ref

    data, heads, words, tables, r = rans_stream(lanes, rows, seed=lanes)
    args = rans_args(dev, heads, words, tables)
    out = rans_decode(*args, rows=rows, r=r)
    ref = rans_decode_ref(*(a.cpu() for a in args), rows=rows, r=r)
    if not (torch.equal(out.cpu(), ref)
            and np.array_equal(out.cpu().numpy(), data)):
        raise AssertionError(f"rans_decode L={lanes} rows={rows} differs "
                             "from the symbols or the plain version")
    # bytes: heads, words (int32 here), three tables, the symbols; the
    # integer operations (~12 a symbol) never decide the bound
    b, by = bound_ms(4 * (lanes + len(words) + 3 * (1 << r) + rows * lanes),
                     12 * rows * lanes)
    ms = cuda_ms(lambda: rans_decode(*args, rows=rows, r=r), reps=5,
                 graph=True)
    return dict(
        name="rans_decode" if (lanes, rows) == RANS_SHAPES[0] else
        f"rans_decode(L={lanes},rows={rows})",
        route="cuda", source="src/repro_torch/csrc/rans_decode.cu",
        replaces="src/repro/kernels/rans_decode/kernel.py:62",
        shape=f"L={lanes} rows={rows} r={r} words={len(words)}",
        max_abs_err=0.0, ms=ms, step_cycles=ms * 1e-3 * sm_hz / rows,
        plain_ms=cuda_ms(lambda: rans_decode_ref(*args, rows=rows, r=r),
                         reps=1, warmup=1),
        bound_ms=b, bound_by=by, library_ms=None)


def wavelet_level0(cluster_of):
    """Level 0 of the port's wavelet tree over an IVF assignment."""
    from repro_torch.core.wavelet_tree import WaveletTree

    return WaveletTree.build(cluster_of, NLIST).levels[0]


def wt_rank_args(dev, gen, level0):
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import pack_bits_u32

    words, sup = pack_bits_u32(level0.bits())
    q = torch.randint(0, level0.nbits + 1, (WT_QUERIES,), device=dev,
                      generator=gen, dtype=torch.int32)
    return [torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(sup).to(dev), q]


def wt_rank_large_args(dev, gen):
    """A random bitvector of WT_LARGE_BITS bits (too large for shared
    memory) and its ``BitVector``, with WT_QUERIES random queries."""
    import numpy as np
    import torch
    from repro_torch.core.bitvec import BitVector
    from repro_torch.kernels.wt_rank import pack_bits_u32

    bits = np.random.default_rng(7).random(WT_LARGE_BITS) < 0.5
    words, sup = pack_bits_u32(bits.astype(np.uint8))
    q = torch.randint(0, WT_LARGE_BITS + 1, (WT_QUERIES,), device=dev,
                      generator=gen, dtype=torch.int32)
    return [torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(sup).to(dev), q], BitVector.from_bits(bits)


def check_wt_rank(args, bitvec, what):
    """wt_rank bit-equal to the plain version run on a CPU copy and to
    ``BitVector``; the route the wrapper took."""
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import wt_rank, wt_rank_ref

    words, sup, q = args
    before = dict(wt_rank.routes)
    out = wt_rank(*args)
    (route,) = [r for r, n in wt_rank.routes.items() if n != before.get(r, 0)]
    if not (torch.equal(out.cpu(), wt_rank_ref(*(a.cpu() for a in args)))
            and np.array_equal(out.cpu().numpy(),
                               bitvec.rank1_batch(q.cpu().numpy()))):
        raise AssertionError("wt_rank differs from the plain version or "
                             "BitVector.rank1_batch")
    # bytes: words, superblock counts, queries and ranks once each; ops:
    # a popcount and an add per word each query needs (never decides)
    qs = q.long()
    ops = 2 * int((((qs >> 5) & 15) + ((qs & 31) > 0).long() + 1).sum())
    b, by = bound_ms(4 * (words.numel() + sup.numel() + 2 * q.numel()), ops)
    return dict(
        name="wt_rank", route="cuda", source="src/repro_torch/csrc/wt_rank.cu",
        replaces="src/repro/kernels/wt_rank/kernel.py:54",
        shape=f"{bitvec.nbits} bits ({what}), {q.numel()} queries",
        kernel_route=route,
        max_abs_err=0.0, ms=cuda_ms(lambda: wt_rank(*args), graph=True),
        plain_ms=cuda_ms(lambda: wt_rank_ref(*args), reps=5),
        bound_ms=b, bound_by=by, library_ms=None)


def exact_topk(base_dev, q_dev, k):
    """Ground-truth neighbours for recall (the harness's own yardstick)."""
    import torch

    out = []
    bn = (base_dev * base_dev).sum(1)
    for i in range(0, q_dev.shape[0], 256):
        q = q_dev[i:i + 256]
        d = (q * q).sum(1, keepdim=True) - 2.0 * q @ base_dev.T + bn[None]
        out.append(torch.topk(d, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy()


def serve_pass(svc, queries):
    """Submit ``queries`` as 4-query requests, flush; (tickets, report)."""
    import numpy as np

    svc.reset_stats()
    t = time.perf_counter()
    tickets = [svc.submit(queries[i:i + REQUEST])
               for i in range(0, len(queries), REQUEST)]
    svc.flush()
    wall = time.perf_counter() - t
    lat = np.array([tk.latency_s for tk in tickets])
    st = svc.stats()
    report = dict(
        qps=len(queries) / wall, serve_s=wall,
        p50_latency_ms=float(np.quantile(lat, 0.5)) * 1e3,
        p99_latency_ms=float(np.quantile(lat, 0.99)) * 1e3,
        search_s=st["search_s"], resolve_s=st["resolve_s"],
        decodes=st["decodes"], batches=st["batches"],
        mean_batch=st["mean_batch"], device_selects=st["device_selects"],
        host_block_bytes=st["host_block_bytes"])
    if getattr(svc, "steps", 0):     # a graph index's beam steps
        report.update(steps=svc.steps, dedup_hits=svc.dedup_hits)
    if "merge_s" in st:              # a sharded service
        report.update(merge_s=st["merge_s"],
                      merge_share=st["merge_s"] / st["search_s"],
                      shards=st["shards"],
                      partial_batches=st["partial_batches"])
    return tickets, report


def results(tickets):
    """(ids, dists) of a pass's tickets, in request order."""
    import numpy as np

    return (np.concatenate([tk.ids for tk in tickets]),
            np.concatenate([tk.dists for tk in tickets]))


def hold_equal(what, got, want):
    """Ids and dists ``np.array_equal`` (bit for bit), or raise."""
    import numpy as np

    if not (np.array_equal(got[0], want[0])
            and np.array_equal(got[1], want[1])):
        rows = int((~((got[0] == want[0]) & (got[1] == want[1]))).any(1)
                   .sum())
        raise AssertionError(f"{what}: differs from the monolith in {rows} "
                             f"of {len(want[0])} queries")


def check_parity(spec, idx, tickets, queries):
    """Served results of the right shape, finite, and equal to
    ``search_ref`` on the first 64 queries."""
    import numpy as np

    ids = np.concatenate([tk.ids for tk in tickets])
    dists = np.concatenate([tk.dists for tk in tickets])
    if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
        raise AssertionError(f"{spec}: bad result shape or non-finite dists")
    ids_r, d_r, _ = idx.ivf.search_ref(queries[:64], nprobe=NPROBE, topk=TOPK)
    if not (np.array_equal(ids[:64], ids_r)
            and np.array_equal(dists[:64], d_r)):
        raise AssertionError(f"{spec}: served results differ from "
                             "search_ref")
    return ids


def serve(spec, base, queries, gt, adds, device):
    """Build ``spec`` on ``device`` and serve ``queries`` through AnnService
    twice (decoded-id cache cold, then warm); then ingest ``adds`` one
    ``add`` call each and serve the queries again.  The launch counts are
    set to 0 before the build and read after the last pass.  Returns
    (report, launch counts, launch shapes, the built index's assignment,
    the index)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(spec, device=device).build(base, seed=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    build_top1 = launch_counts()["l2_top1"]
    cluster_of = np.array(idx.ivf.cluster_of, np.int64)
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device, nprobe=NPROBE)
    cold_t, cold = serve_pass(svc, queries)
    warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        ids = check_parity(spec, idx, tickets, queries)
    recall = recall_at_10(ids, gt)
    bits_built = idx.ivf.bits_per_id()

    top1 = launch_counts()["l2_top1"]
    t = time.perf_counter()
    for x in adds:
        svc.add(x)
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t
    ingest_top1 = launch_counts()["l2_top1"] - top1
    if idx.ivf.n != base.shape[0] + sum(len(x) for x in adds):
        raise AssertionError(f"{spec}: {idx.ivf.n} ids after ingest")
    grown_t, grown = serve_pass(svc, queries)
    counts, shapes = launch_counts(), launch_shapes()
    check_parity(spec, idx, grown_t, queries)
    return dict(
        spec=spec, n=int(base.shape[0]), build_s=build_s,
        recall_at_10=recall, bits_per_id=bits_built,
        cold=cold, warm=warm, parity_vs_search_ref=True,
        ingest=dict(adds=len(adds), rows=int(sum(len(x) for x in adds)),
                    add_s=add_s, epochs=idx.ivf.n_epochs, n=int(idx.ivf.n),
                    bits_per_id=idx.ivf.bits_per_id(),
                    l2_top1_launches_build=build_top1,
                    l2_top1_launches_ingest=ingest_top1,
                    served=grown, parity_vs_search_ref=True),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes, \
        cluster_of, idx


def recall_at_10(ids, gt):
    import numpy as np

    return float(np.mean([len(set(a) & set(b)) / TOPK
                          for a, b in zip(ids, gt)]))


def serve_flat(base, queries, gt, device):
    """Build ``Flat`` on ``device`` and serve ``queries`` through AnnService
    twice (the first pass uploads the padded base); launch counts set to 0
    before the build and read after the second pass.  Results must equal a
    CPU ``FlatIndex`` (the numpy loop) on the first 64 queries and reach
    recall@10 1.0.  Returns (report, counts, shapes, the index)."""
    import numpy as np
    import torch
    from repro_torch.api import make_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = make_index("Flat", device=device).build(base)
    build_s = time.perf_counter() - t
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device)
    first_t, first = serve_pass(svc, queries)
    second_t, second = serve_pass(svc, queries)
    torch.cuda.synchronize()
    counts, shapes = launch_counts(), launch_shapes()
    if svc.last_stats.engine != "flat-pallas":
        raise AssertionError(f"Flat served by {svc.last_stats.engine}")
    t = time.perf_counter()
    d_cpu, ids_cpu, st_cpu = make_index("Flat", device="cpu").build(
        base).search(queries[:64], k=TOPK)
    loop_s = time.perf_counter() - t
    if st_cpu.engine != "flat":
        raise AssertionError(f"CPU Flat ran {st_cpu.engine}")
    for tickets in (first_t, second_t):
        ids = np.concatenate([tk.ids for tk in tickets])
        dists = np.concatenate([tk.dists for tk in tickets])
        if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
            raise AssertionError("Flat: bad result shape or non-finite dists")
        if not (np.array_equal(ids[:64], ids_cpu)
                and np.array_equal(dists[:64], d_cpu)):
            raise AssertionError("Flat: served results differ from the "
                                 "numpy loop")
    recall = recall_at_10(ids, gt)
    if recall != 1.0:
        raise AssertionError(f"Flat recall@10 {recall} against exact search")
    return dict(
        spec="Flat", n=int(base.shape[0]), build_s=build_s,
        recall_at_10=recall, first=first, second=second,
        parity_vs_numpy_loop=True, numpy_loop_s_64_queries=loop_s,
        launches=counts, shapes=shape_report(counts, shapes)), counts, \
        shapes, idx


def container_path(name, idx, opts, queries, device):
    """``save_index`` and ``load_index(device=...)`` of one index: pack and
    unpack seconds, blob MB, bits per id and epochs equal, and search
    (with ``opts``) after reload equal to search before over all
    ``queries``.  Launch counts set to 0 before and read after.  Returns
    (report, counts, shapes)."""
    import numpy as np
    import torch
    from repro_torch.api import load_index, save_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)

    reset_launches()
    d0, i0, _ = idx.search(queries, k=TOPK, **opts)
    t = time.perf_counter()
    blob = save_index(idx)
    pack_s = time.perf_counter() - t
    t = time.perf_counter()
    back = load_index(blob, device=device)
    torch.cuda.synchronize()
    unpack_s = time.perf_counter() - t
    rec = dict(index=name, spec=idx.spec, blob_mb=len(blob) / 2**20,
               pack_s=pack_s, unpack_s=unpack_s)
    del blob
    if back.spec != idx.spec or back.device != idx.device:
        raise AssertionError(f"{name}: reloaded as {back.spec} on "
                             f"{back.device}")
    inner, inner2 = getattr(idx, "ivf", None), getattr(back, "ivf", None)
    if inner is not None:
        rec.update(bits_per_id=inner2.bits_per_id(),
                   epochs=inner2.n_epochs)
        if (inner2.bits_per_id() != inner.bits_per_id()
                or inner2.n_epochs != inner.n_epochs):
            raise AssertionError(f"{name}: bits per id or epochs differ "
                                 "after reload")
    t = time.perf_counter()
    d1, i1, st = back.search(queries, k=TOPK, **opts)
    rec.update(search_after_reload_s=time.perf_counter() - t,
               engine=st.engine)
    if not (np.array_equal(i1, i0) and np.array_equal(d1, d0)):
        raise AssertionError(f"{name}: search after reload differs")
    rec["search_equal_after_reload"] = True
    del back
    counts, shapes = launch_counts(), launch_shapes()
    return dict(rec, launches=counts), counts, shapes


def sharded_service(plan, device, **opts):
    """A ShardedAnnService over ``plan`` with the main path's batching."""
    from repro_torch.serve import BatchPolicy
    from repro_torch.shard import ShardedAnnService

    return ShardedAnnService(plan, topk=TOPK,
                             policy=BatchPolicy(max_batch=MAX_BATCH),
                             device=device, **opts)


def timed(fn):
    """(fn(), seconds), the card synchronised before the clock stops."""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def shard_ivf_path(idx, queries, add_x, device):
    """Sharded serving of the built ``IVF1024,ids=roc`` index (after its
    ingest): the monolith served warm through AnnService; each plan of
    SHARD_IVF served cold (the monolith's decoded-id cache budget split
    across the shards) and warm through ShardedAnnService, ids and dists
    equal to the monolith's on every query; then one routed add of
    ``add_x`` to the monolith and to both 4-shard services: every shard's
    n and epochs equal the monolith's, results equal again.  Counts set to
    0 before and read after.  Returns (report, counts, shapes)."""
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    mono_svc = AnnService(idx, topk=TOPK,
                          policy=BatchPolicy(max_batch=MAX_BATCH),
                          device=device, nprobe=NPROBE)
    mono_t, mono = serve_pass(mono_svc, queries)
    want = results(mono_t)
    budget_mb = idx.ivf.decoded_cache.max_bytes / 2**20
    plans, keep = [], {}
    for nshards, by in SHARD_IVF:
        plan, plan_s = timed(lambda: plan_shards(idx, nshards, by=by))
        svc = sharded_service(plan, device, cache_mb=budget_mb,
                              nprobe=NPROBE)
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
        for tickets in (cold_t, warm_t):
            hold_equal(f"{idx.spec} on {nshards} shards by {by}",
                       results(tickets), want)
        plans.append(dict(
            nshards=nshards, by=by, plan_s=plan_s,
            n_local=[info.n_local for info in plan.shards], cold=cold,
            warm=warm, warm_qps_over_monolith=warm["qps"] / mono["qps"],
            equal_on_all_queries=True))
        if nshards == 4:
            keep[by] = svc
        else:
            svc.close()
        del plan
    _, mono_add_s = timed(lambda: mono_svc.add(add_x))
    grown_t, grown = serve_pass(mono_svc, queries)
    want = results(grown_t)
    adds = []
    for by, svc in keep.items():
        _, add_s = timed(lambda: svc.add(add_x))
        got = [(sh.ivf.n, sh.ivf.n_epochs) for sh in svc.plan.indexes]
        if set(got) != {(idx.ivf.n, idx.ivf.n_epochs)}:
            raise AssertionError(f"routed add by {by}: shards at (n, "
                                 f"epochs) {got}, the monolith at "
                                 f"{(idx.ivf.n, idx.ivf.n_epochs)}")
        g_t, g = serve_pass(svc, queries)
        hold_equal(f"{idx.spec} on 4 shards by {by} after a routed add",
                   results(g_t), want)
        adds.append(dict(by=by, add_s=add_s, served=g,
                         equal_on_all_queries=True))
        svc.close()
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, cache_mb=budget_mb, monolith_warm=mono, plans=plans,
        routed_add=dict(rows=len(add_x), monolith_add_s=mono_add_s,
                        n=int(idx.ivf.n), epochs=idx.ivf.n_epochs,
                        monolith_served=grown, sharded=adds),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def shard_pq_path(base, queries, device):
    """``IVF1024,PQ8x8,ids=roc,codes=polya`` built on the card over the
    first SHARD_PQ_N vectors, served through AnnService (cold, warm), then
    planned onto 2 shards by hash (each shard's Pólya codes re-encoded on
    the host) and served cold and warm through ShardedAnnService, equal to
    the monolith on every query.  Counts set to 0 before the build and
    read after.  Returns (report, counts, shapes)."""
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    x = base[:SHARD_PQ_N]
    idx, build_s = timed(lambda: index_factory(SPECS[1], device=device)
                         .build(x, seed=1))
    mono_svc = AnnService(idx, topk=TOPK,
                          policy=BatchPolicy(max_batch=MAX_BATCH),
                          device=device, nprobe=NPROBE)
    serve_pass(mono_svc, queries)
    mono_t, mono = serve_pass(mono_svc, queries)
    want = results(mono_t)
    plan, plan_s = timed(lambda: plan_shards(idx, 2, by="hash"))
    budget_mb = idx.ivf.decoded_cache.max_bytes / 2**20
    with sharded_service(plan, device, cache_mb=budget_mb,
                         nprobe=NPROBE) as svc:
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        hold_equal(f"{idx.spec} at n={len(x)} on 2 shards", results(tickets),
                   want)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, n=len(x), build_s=build_s, plan_s=plan_s,
        bits_per_code=[sh.ivf.code_bits_per_element()
                       for sh in plan.indexes],
        monolith_bits_per_code=idx.ivf.code_bits_per_element(),
        monolith_warm=mono, cold=cold, warm=warm, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def save_load_plan(plan, device):
    """``plan.save`` into a temporary directory under the git-ignored
    ``build/`` and ``ShardPlan.load`` onto ``device``: (loaded plan,
    pack s, unpack s, MB on disk)."""
    import tempfile

    from repro_torch.shard import ShardPlan

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        _, pack_s = timed(lambda: plan.save(tmp))
        mb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 2**20
        loaded, unpack_s = timed(lambda: ShardPlan.load(tmp, device=device))
    return loaded, pack_s, unpack_s, mb


def shard_flat_path(idx, queries, device):
    """The 1M ``Flat`` index on 4 shards by hash: served twice through
    ShardedAnnService (the first pass uploads each shard's base), equal to
    the monolith's AnnService pass on every query; the plan saved and
    loaded onto the card, served again, equal.  Counts set to 0 before and
    read after.  Returns (report, counts, shapes)."""
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy
    from repro_torch.shard import plan_shards

    reset_launches()
    mono_t, mono = serve_pass(AnnService(
        idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
        device=device), queries)
    want = results(mono_t)
    plan, plan_s = timed(lambda: plan_shards(idx, 4))
    with sharded_service(plan, device) as svc:
        first_t, first = serve_pass(svc, queries)
        second_t, second = serve_pass(svc, queries)
    for tickets in (first_t, second_t):
        hold_equal("Flat on 4 shards", results(tickets), want)
    loaded, pack_s, unpack_s, mb = save_load_plan(plan, device)
    del plan
    with sharded_service(loaded, device) as svc:
        back_t, back = serve_pass(svc, queries)
    hold_equal("Flat on 4 shards after save and load", results(back_t), want)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec="Flat", n=int(idx.n), plan_s=plan_s,
        n_local=[info.n_local for info in loaded.shards], monolith=mono,
        first=first, second=second, plan_mb=mb, pack_s=pack_s,
        unpack_s=unpack_s, after_reload=back, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def shard_container_path(base, queries, device):
    """``IVF1024,ids=roc`` built over the first SHARD_CONTAINER_N vectors,
    planned onto 4 shards by hash, the plan saved and loaded onto the card
    (pack / unpack seconds, MB), and the loaded plan served equal to the
    monolith on every query.  Counts set to 0 before and read after.
    Returns (report, counts, shapes, the loaded plan)."""
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.shard import plan_shards

    reset_launches()
    x = base[:SHARD_CONTAINER_N]
    idx = index_factory(SPECS[0], device=device).build(x, seed=1)
    d0, i0, _ = idx.search(queries, k=TOPK, nprobe=NPROBE)
    plan = plan_shards(idx, 4, by="hash")
    loaded, pack_s, unpack_s, mb = save_load_plan(plan, device)
    with sharded_service(loaded, device, nprobe=NPROBE) as svc:
        served_t, served = serve_pass(svc, queries)
    hold_equal(f"{idx.spec} at n={len(x)} on 4 shards after save and load",
               results(served_t), (i0, d0))
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=idx.spec, n=len(x), plan_mb=mb, pack_s=pack_s,
        unpack_s=unpack_s, served=served, equal_on_all_queries=True,
        launches=counts, shapes=shape_report(counts, shapes)), counts, \
        shapes, loaded


def merge_by_dist_id(parts, k):
    """Each query's ``k`` smallest ``(dist, id)`` pairs over the shards'
    ``(ids, dists)``, one query at a time in Python: the graph shards'
    merge rule, written independently of the router's."""
    import numpy as np

    nq = parts[0][0].shape[0]
    ids = np.zeros((nq, k), np.int64)
    dists = np.full((nq, k), np.inf, np.float32)
    for qi in range(nq):
        pairs = sorted((float(d), int(i)) for ids_s, d_s in parts
                       for d, i in zip(d_s[qi], ids_s[qi]) if np.isfinite(d))
        for j, (d, i) in enumerate(pairs[:k]):
            ids[qi, j], dists[qi, j] = i, d
    return ids, dists


def exact_over(x, nodes, q, k):
    """The ``k`` smallest ``(dist, id)`` over ``nodes`` (global ids into
    ``x``) for each query, dists by the graph search's own numpy
    expression: (ids, dists)."""
    import numpy as np

    ids = np.zeros((len(q), k), np.int64)
    dists = np.full((len(q), k), np.inf, np.float32)
    for qi in range(len(q)):
        d = np.sum((x[nodes] - q[qi]) ** 2, axis=1)
        top = np.lexsort((nodes, d))[:k]
        ids[qi, :len(top)], dists[qi, :len(top)] = nodes[top], d[top]
    return ids, dists


def shard_graph_path(nav_idx, queries, gt, device):
    """The navigable ``NSG32,ids=roc`` index on SHARD_GRAPH shards by hash
    (each shard's graph rebuilt on the card), served cold and warm through
    ShardedAnnService (ef = GRAPH_EF): every shard's results equal its own
    ``search_ref`` on the first 64 queries, and the merged results equal an
    independent merge of the shards' results on every query; the shards'
    reachable share and the merged recall@10.  Then the reference's
    exhaustive regime over the first SHARD_EXHAUSTIVE_N vectors (ef =
    SHARD_EXHAUSTIVE_EF >= n): the monolith and every shard return the
    exact top-10 over the nodes reachable from their entries, the merge
    equals the merge of the shards, and the merge equals the monolith on
    every query whose exact top-10 lies inside the nodes reachable in both
    (the precondition of exhaustive parity; the other queries are
    counted).  Counts set to 0 before and read after.  Returns (report,
    counts, shapes)."""
    import numpy as np
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.shard import plan_shards

    reset_launches()
    plan, plan_s = timed(lambda: plan_shards(nav_idx, SHARD_GRAPH, seed=0))
    with sharded_service(plan, device, ef=GRAPH_EF) as svc:
        cold_t, cold = serve_pass(svc, queries)
        warm_t, warm = serve_pass(svc, queries)
    got = results(warm_t)
    hold_equal("NSG32 shards, cold against warm", results(cold_t), got)
    parts, shard_rows = [], []
    for sh in plan.indexes:
        g = sh.graph
        d, i, _ = sh.search(queries, k=TOPK, ef=GRAPH_EF)
        i_r, d_r, _ = g.search_ref(queries[:64], ef=GRAPH_EF, topk=TOPK)
        i_r = np.where(np.isfinite(d_r), g.id_map[i_r], 0)
        hold_equal("an NSG32 shard against its search_ref",
                   (i[:64], d[:64]), (i_r, d_r))
        parts.append((i, d))
        reach = reachable_from_entry(g.adj_raw, g.entry)
        shard_rows.append(dict(n=int(g.n), reachable_share=reach / g.n,
                               bits_per_edge=g.bits_per_edge()))
    hold_equal("NSG32 shards against a merge of the shards' results", got,
               merge_by_dist_id(parts, TOPK))

    # the exhaustive regime
    x = nav_idx.graph.x[:SHARD_EXHAUSTIVE_N]
    q = queries[:SHARD_EXHAUSTIVE_Q]
    small = index_factory(nav_idx.spec, device=device).build(x)
    splan = plan_shards(small, SHARD_GRAPH, seed=0)
    ef = SHARD_EXHAUSTIVE_EF
    d_m, i_m, _ = small.search(q, k=TOPK, ef=ef)
    with sharded_service(splan, device, ef=ef) as svc:
        merged = svc.search(q)
    reach_m = np.flatnonzero(reachable_mask(small.graph.adj_raw,
                                            small.graph.entry))
    hold_equal("exhaustive NSG32 monolith against the exact top-10 over "
               "its reachable nodes", (i_m, d_m),
               exact_over(x, reach_m, q, TOPK))
    sparts, reach_s = [], []
    for sh in splan.indexes:
        g = sh.graph
        d, i, _ = sh.search(q, k=TOPK, ef=ef)
        r = g.id_map[reachable_mask(g.adj_raw, g.entry)]
        hold_equal("an exhaustive NSG32 shard against the exact top-10 "
                   "over its reachable nodes", (i, d),
                   exact_over(x, r, q, TOPK))
        sparts.append((i, d))
        reach_s.append(r)
    hold_equal("exhaustive NSG32 shards against a merge of the shards",
               merged, merge_by_dist_id(sparts, TOPK))
    exact, _ = exact_over(x, np.arange(len(x)), q, TOPK)
    both = np.intersect1d(reach_m, np.concatenate(reach_s))
    held = np.isin(exact, both).all(1)
    hold_equal("exhaustive NSG32 shards against the monolith where every "
               "exact top-10 node is reachable in both",
               (merged[0][held], merged[1][held]), (i_m[held], d_m[held]))
    same = ((merged[0] == i_m) & (merged[1] == d_m)).all(1)
    counts, shapes = launch_counts(), launch_shapes()
    return dict(
        spec=nav_idx.spec, n=int(nav_idx.graph.n), ef=GRAPH_EF,
        plan_s=plan_s, shards=shard_rows, cold=cold, warm=warm,
        recall_at_10=recall_at_10(got[0], gt),
        shards_equal_search_ref_64=True, merge_equal_on_all_queries=True,
        exhaustive=dict(
            n=len(x), ef=ef, queries=len(q),
            reachable=[len(reach_m)] + [len(r) for r in reach_s],
            precondition_held=int(held.sum()),
            equal_to_monolith=int(same.sum()),
            equal_where_held=True),
        launches=counts, shapes=shape_report(counts, shapes)), counts, shapes


def degraded_passes(plan, queries, device):
    """Not counted, and run after every counted path: ``ScriptedFaults(
    dead=[1])`` must give ``stats.partial`` with no result id of shard 1,
    and ``ScriptedFaults(flaky={0: 1})`` the full results after one
    retry."""
    import numpy as np
    from repro_torch.shard import RetryPolicy, ScriptedFaults

    no_sleep = RetryPolicy(sleep=lambda s: None)
    with sharded_service(plan, device, nprobe=NPROBE) as svc:
        want = svc.search(queries)
    with sharded_service(plan, device, nprobe=NPROBE, retry=no_sleep,
                         fault_policy=ScriptedFaults(dead=[1])) as svc:
        ids, dists, st = svc.search(queries, with_stats=True)
    dead = np.concatenate([lst for lst in plan.indexes[1].ivf._lists
                           if len(lst)])
    if not (st.partial and st.shards_failed == 1
            and np.isfinite(dists[:, 0]).all()
            and not np.isin(ids[np.isfinite(dists)], dead).any()):
        raise AssertionError(f"dead shard 1: partial={st.partial}, "
                             f"failed={st.shards_failed}, or its ids served")
    with sharded_service(plan, device, nprobe=NPROBE, retry=no_sleep,
                         fault_policy=ScriptedFaults(flaky={0: 1})) as svc:
        ids_f, dists_f, st_f = svc.search(queries, with_stats=True)
    if st_f.partial or st_f.retries != 1:
        raise AssertionError(f"flaky shard 0: partial={st_f.partial}, "
                             f"retries={st_f.retries}")
    hold_equal("a flaky shard after its retry", (ids_f, dists_f), want)
    return dict(dead=dict(shard=1, partial=True, shards_failed=1,
                          ids_of_dead_shard_served=0),
                flaky=dict(shard=0, retries=1, partial=False,
                           equal_to_full=True))


def reachable_from_entry(adj, entry):
    """How many nodes a search can reach from ``entry``."""
    return int(reachable_mask(adj, entry).sum())


def reachable_mask(adj, entry):
    """Nodes a search can reach: those on a directed path from ``entry``
    (a frontier expansion over the friend lists), as a bool mask."""
    import numpy as np

    lens = np.fromiter((len(a) for a in adj), np.int64, len(adj))
    flat = np.concatenate(adj)
    start = np.concatenate([[0], np.cumsum(lens)[:-1]])
    seen = np.zeros(len(adj), bool)
    seen[entry] = True
    front = np.array([entry])
    while front.size:
        cnt = lens[front]
        pos = np.repeat(start[front] - np.cumsum(cnt) + cnt, cnt) + \
            np.arange(int(cnt.sum()))
        nb = np.unique(flat[pos])
        front = nb[~seen[nb]]
        seen[front] = True
    return seen


def check_graph_parity(spec, idx, tickets, queries):
    """Served graph results of the right shape, finite, and equal to the
    index's own ``search_ref`` on the first 64 queries."""
    import numpy as np

    ids = np.concatenate([tk.ids for tk in tickets])
    dists = np.concatenate([tk.dists for tk in tickets])
    if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
        raise AssertionError(f"{spec}: bad result shape or non-finite dists")
    ids_r, d_r, _ = idx.graph.search_ref(queries[:64], ef=GRAPH_EF,
                                         topk=TOPK)
    if not (np.array_equal(ids[:64], ids_r)
            and np.array_equal(dists[:64], d_r)):
        raise AssertionError(f"{spec}: served results differ from "
                             "search_ref")
    return ids


def serve_graph(spec, base, queries, gt, adds, device, floor=None):
    """Build the graph ``spec`` on ``device`` (stage seconds from
    ``build_s``) and serve ``queries`` through AnnService (``ef``) cold and
    warm; then, when ``adds`` are given, ingest them one ``add`` call each
    and serve again.  Parity with ``search_ref`` on the first 64 queries
    after each pass; recall@10 against ``gt``, and the share of nodes a
    search can reach from the entry, each held to ``floor`` when given.
    Launch counts are set to 0 before the build and read after the last
    pass.  Returns (report, counts, shapes, the index, its first
    GRAPH_CHECK_NODES friend lists as built)."""
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(spec, device=device).build(base)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    built_head = [a.copy() for a in idx.graph.adj_raw[:GRAPH_CHECK_NODES]]
    build_launches = launch_counts()
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device, ef=GRAPH_EF)
    cold_t, cold = serve_pass(svc, queries)
    warm_t, warm = serve_pass(svc, queries)
    for tickets in (cold_t, warm_t):
        ids = check_graph_parity(spec, idx, tickets, queries)
    reach = reachable_from_entry(idx.graph.adj_raw, idx.graph.entry)
    report = dict(
        spec=spec, n=int(base.shape[0]), ef=GRAPH_EF, build_s=build_s,
        build_stages_s=dict(idx.build_s),
        edges=int(sum(len(a) for a in idx.graph.adj_raw)),
        bits_per_edge=idx.graph.bits_per_edge(),
        reachable_from_entry=reach, reachable_share=reach / base.shape[0],
        recall_at_10=recall_at_10(ids, gt), cold=cold, warm=warm,
        parity_vs_search_ref=True, build_launches=build_launches)
    if floor is not None:
        low = {k: report[k] for k, v in floor.items() if report[k] < v}
        if low:
            raise AssertionError(f"{spec} at n={base.shape[0]}: {low} below "
                                 f"the floors {floor}")
        report["floor"] = floor
    if adds:
        t = time.perf_counter()
        for x in adds:
            svc.add(x)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t
        if idx.graph.n != base.shape[0] + sum(len(x) for x in adds):
            raise AssertionError(f"{spec}: {idx.graph.n} nodes after ingest")
        grown_t, grown = serve_pass(svc, queries)
        check_graph_parity(spec, idx, grown_t, queries)
        report["ingest"] = dict(
            adds=len(adds), rows=int(sum(len(x) for x in adds)), add_s=add_s,
            epochs=idx.graph.n_epochs, n=int(idx.graph.n),
            bits_per_edge=idx.graph.bits_per_edge(), served=grown,
            parity_vs_search_ref=True)
    counts, shapes = launch_counts(), launch_shapes()
    report.update(launches=counts, shapes=shape_report(counts, shapes))
    return report, counts, shapes, idx, built_head


def gate_passes(spec, idx, queries, gates, device, rounds):
    """Warm passes through AnnService at each ``kernel_min`` of ``gates``
    in turns, forwards then backwards (so each gate runs early and late),
    ``rounds`` times; each pass's results must equal the first's (the
    gate never changes them).  Returns (one record a pass: QPS, p50/p99,
    search seconds, steps and the ``l2_dist`` launches by ``(NQ, N)``
    tile; per gate: the median search seconds and QPS over its passes,
    its launches a pass and the share of steps they are)."""
    import numpy as np
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.serve import AnnService, BatchPolicy

    first, rows = None, []
    for gate in (list(gates) + list(gates)[::-1]) * rounds:
        svc = AnnService(idx, topk=TOPK,
                         policy=BatchPolicy(max_batch=MAX_BATCH),
                         device=device, ef=GRAPH_EF, kernel_min=gate)
        reset_launches()
        tickets, rep = serve_pass(svc, queries)
        ids = np.concatenate([tk.ids for tk in tickets])
        dists = np.concatenate([tk.dists for tk in tickets])
        if first is None:
            first = (ids, dists)
        elif not (np.array_equal(ids, first[0])
                  and np.array_equal(dists, first[1])):
            raise AssertionError(f"{spec}: kernel_min={gate} changed the "
                                 "results")
        rows.append(dict(kernel_min=gate, **{k: rep[k] for k in (
            "qps", "p50_latency_ms", "p99_latency_ms", "search_s",
            "steps")}, l2_dist_launches=launch_counts()["l2_dist"],
            tiles=dict(sorted(launch_shapes()["l2_dist_tiles"].items()))))
    summary = {}
    for gate in gates:
        mine = [r for r in rows if r["kernel_min"] == gate]
        summary[gate] = dict(
            passes=len(mine),
            median_search_s=float(np.median([r["search_s"] for r in mine])),
            median_qps=float(np.median([r["qps"] for r in mine])),
            l2_dist_launches=mine[0]["l2_dist_launches"],
            share_of_steps=mine[0]["l2_dist_launches"] / mine[0]["steps"])
    return rows, summary


def graph_decisions(base, nsg_head, device):
    """The card's graph decisions against the CPU's (no launch counted):
    the NSG32 and HNSW16 prunes of the first GRAPH_CHECK_NODES nodes' kNN
    lists equal on both devices (and NSG's equal to the lists the 1M build
    made), HNSW's closed-form reverse edges on that subgraph equal on both
    devices and to the reference's loop, ``knn_graph`` over the first
    GRAPH_KNN_CHECK vectors differing from the CPU's only at near-ties
    inside ``rescore_eps``, and ``np_sum_f32`` bit-equal to ``np.sum``."""
    import numpy as np
    import torch
    from repro_torch.ann.graph import (hnsw_reverse_edges, kept_lists,
                                       knn_graph, prune_kept)
    from repro_torch.ann.npsum import np_sum_f32
    from repro_torch.ann.scan import rescore_eps

    rec = {}
    xdev = torch.from_numpy(base).to(device)
    xcpu = torch.from_numpy(base)
    nodes = np.arange(GRAPH_CHECK_NODES)
    for name, r, k in (("NSG32", 32, 64), ("HNSW16", 16, 32)):
        nn = knn_graph(xdev, k, rows=GRAPH_CHECK_NODES)
        t = time.perf_counter()
        card = prune_kept(xdev, nn, nodes, r)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = prune_kept(xcpu, nn, nodes, r)
        cpu_s = time.perf_counter() - t
        if not np.array_equal(card, cpu):
            bad = np.flatnonzero((card != cpu).any(1))
            raise AssertionError(f"{name} prune: card differs from the CPU "
                                 f"at nodes {bad[:8].tolist()}")
        rec[f"{name}_prune"] = dict(nodes=GRAPH_CHECK_NODES, card_s=card_s,
                                    cpu_s=cpu_s, equal=True)
        if name == "NSG32":
            if not all(np.array_equal(a, b)
                       for a, b in zip(kept_lists(card), nsg_head)):
                raise AssertionError("NSG32 prune of the first nodes differs "
                                     "from the lists the build made")
            rec[f"{name}_prune"]["equal_to_build"] = True
        else:
            sub = np.where(card < GRAPH_CHECK_NODES, card, -1)
            got = hnsw_reverse_edges(sub, r, device=device)
            want = hnsw_reverse_edges(sub, r, device="cpu")
            adj = [[int(j) for j in row if j >= 0] for row in sub]
            for i in range(len(adj)):               # the reference's loop
                for j in adj[i]:
                    if len(adj[j]) < r and i not in adj[j]:
                        adj[j].append(i)
            if not all(np.array_equal(a, b) and np.array_equal(
                    a, np.asarray(sorted(set(c)), np.int64))
                    for a, b, c in zip(got, want, adj)):
                raise AssertionError("HNSW16 reverse edges: card, CPU and "
                                     "the loop differ")
            rec["HNSW16_reverse_edges"] = dict(
                nodes=GRAPH_CHECK_NODES, equal_card_cpu_loop=True,
                edges=int(sum(len(a) for a in got)))
    del xdev
    sub = base[:GRAPH_KNN_CHECK]
    card = knn_graph(torch.from_numpy(sub).to(device), 64)
    cpu = knn_graph(torch.from_numpy(sub), 64)
    x64 = sub.astype(np.float64)
    diff = np.argwhere(card != cpu)
    band_use = 0.0
    for i, j in diff:
        da = float(np.sum((x64[cpu[i, j]] - x64[i]) ** 2))
        db = float(np.sum((x64[card[i, j]] - x64[i]) ** 2))
        eps = rescore_eps(sub.shape[1], da, float(x64[i] @ x64[i]))
        band_use = max(band_use, abs(da - db) / eps)
    if band_use > 1.0:
        raise AssertionError(f"knn_graph: card and CPU differ outside "
                             f"rescore_eps ({band_use} of the band)")
    rec["knn_graph"] = dict(n=GRAPH_KNN_CHECK, k=64,
                            positions_differ=int(len(diff)),
                            rows_differ=int((card != cpu).any(1).sum()),
                            band_use=band_use)
    rng = np.random.default_rng(5)
    for d in NPSUM_DIMS:
        a = (rng.standard_normal((4096, d)) ** 2 * rng.uniform(
            0.01, 1e4, (4096, 1))).astype(np.float32)
        got = np_sum_f32(torch.from_numpy(a).to(device)).cpu().numpy()
        if not np.array_equal(got.view(np.int32),
                              np.sum(a, axis=1).view(np.int32)):
            raise AssertionError(f"np_sum_f32 d={d} on the card differs "
                                 "from np.sum")
    rec["np_sum_f32"] = dict(dims=list(NPSUM_DIMS), rows=4096,
                             bit_equal=True)
    return rec


def graph_container_path(base, queries, add, device):
    """``save_index`` / ``load_index(device=...)`` of an NSG32 index over
    the first GRAPH_CONTAINER_N vectors after one ``add``, with webgraph and
    REC edges: pack and unpack seconds, blob MB, bits per edge and epochs
    equal, search after reload equal over all ``queries``.  Launch counts
    set to 0 before and read after.  Returns (report, counts, shapes)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory, load_index, save_index
    from repro_torch.kernels import (launch_counts, launch_shapes,
                                     reset_launches)

    reset_launches()
    t = time.perf_counter()
    idx = index_factory(GRAPH_SPECS[0], device=device).build(
        base[:GRAPH_CONTAINER_N])
    idx.add(add)
    torch.cuda.synchronize()
    rec = dict(spec=GRAPH_SPECS[0], n=int(idx.n), build_and_add_s=(
        time.perf_counter() - t), epochs=idx.n_epochs,
        bits_per_edge=idx.graph.bits_per_edge())
    d0, i0, _ = idx.search(queries, k=TOPK, ef=GRAPH_EF)
    for codec in ("webgraph", "rec"):
        t = time.perf_counter()
        blob = save_index(idx, graph_codec=codec)
        pack_s = time.perf_counter() - t
        t = time.perf_counter()
        back = load_index(blob, device=device)
        torch.cuda.synchronize()
        unpack_s = time.perf_counter() - t
        if (back.spec != idx.spec or back.device != idx.device
                or back.graph.bits_per_edge() != idx.graph.bits_per_edge()
                or back.n_epochs != idx.n_epochs):
            raise AssertionError(f"graph container ({codec}): spec, device, "
                                 "bits per edge or epochs differ")
        d1, i1, st = back.search(queries, k=TOPK, ef=GRAPH_EF)
        if not (np.array_equal(i1, i0) and np.array_equal(d1, d0)):
            raise AssertionError(f"graph container ({codec}): search after "
                                 "reload differs")
        rec[codec] = dict(blob_mb=len(blob) / 2**20, pack_s=pack_s,
                          unpack_s=unpack_s, engine=st.engine,
                          search_equal_after_reload=True)
        del blob, back
    counts, shapes = launch_counts(), launch_shapes()
    return dict(rec, launches=counts), counts, shapes


def time_step_tiles(idx, queries):
    """One graph step's device path (``score_step``: the H2D copies, the
    gather of the candidates, ``l2_dist`` and the ``(n_pad,)`` copy back,
    on the host clock with a synchronize) against the host re-score of
    the same candidates (the engine's numpy expression), at each tile of
    STEP_TILES; and the smallest tile where the device path is faster.
    The candidates are random nodes spread over the tile's query rows."""
    import numpy as np
    import torch
    from repro_torch.ann.graph_scan import KERNEL_MIN_CUDA, score_step

    g = idx.graph
    rng = np.random.default_rng(3)
    rows, crossover = [], None
    for qb, n_pad in STEP_TILES:
        cand_v = rng.integers(0, g.n, n_pad)
        cand_row = np.sort(rng.integers(0, qb, n_pad))
        qblk = np.ascontiguousarray(queries[:qb], np.float32)
        idx_pad = cand_v.astype(np.int32)

        def device_step():
            score_step(g, qblk, idx_pad, cand_row)

        def host_rescore():
            np.sum((g.x[cand_v] - qblk[cand_row]) ** 2, axis=1)

        times = {}
        for name, fn in (("device_ms", device_step),
                         ("host_rescore_ms", host_rescore)):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            reps = 50
            t = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t) / reps * 1e3
        rows.append(dict(tile=f"{qb}x{n_pad}", **times))
        if crossover is None and times["device_ms"] < times["host_rescore_ms"]:
            crossover = n_pad
    return dict(tiles=rows, device_faster_from=crossover,
                kernel_min_cuda=KERNEL_MIN_CUDA)


def time_graph_tiles(l2_tiles, seg_tiles, base_dev, queries_dev):
    """Every kernel launch shape of the graph paths, held and timed:
    ``l2_dist`` at each ``(NQ, N)`` tile (the queries against the first N
    base rows; inside ``rescore_eps`` of ``l2_dist_ref``; a CUDA graph's
    replay for a beam step's tiles) and ``seg_topk`` at each ``(rows,
    n, k)`` on the base's own distances with ``lens = n`` (bit-equal to the
    plain version on a CPU copy of 16 rows).  At the most launched wide
    tile of each (the kNN build's block) also the bound, the plain
    version's time and a library call's (``torch.addmm``, ``torch.topk``).
    Returns ({tile: ms} for ``l2_dist``, {tile: ms} for ``seg_topk``,
    {kernel: record at its widest tile})."""
    import torch
    from repro_torch.kernels.l2_topk import l2_dist, l2_dist_ref
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    d = base_dev.shape[1]
    l2_ms, seg_ms, wide = {}, {}, {}
    wide_l2 = max((t for t in l2_tiles if t[0] * t[1] > STEP_TILE_MAX),
                  key=l2_tiles.get)
    wide_seg = max(seg_tiles, key=seg_tiles.get)
    for nq, n in sorted(l2_tiles):
        q = (queries_dev if nq <= queries_dev.shape[0] else base_dev)[:nq]
        a = base_dev[:n]
        out, ref = l2_dist(q, a), l2_dist_ref(q, a)
        qn = (q.double() ** 2).sum(1, keepdim=True)
        band_use = float(((out.double() - ref.double()).abs()
                          / rescore_band(d, ref, qn)).max())
        if not band_use <= 1.0:
            raise AssertionError(f"l2_dist at tile {nq}x{n} outside "
                                 f"rescore_eps ({band_use} of the band)")
        del out, ref
        small = nq * n <= STEP_TILE_MAX     # a beam step's tile
        l2_ms[(nq, n)] = cuda_ms(lambda: l2_dist(q, a), graph=small,
                                 reps=20 if small else 3,
                                 warmup=3 if small else 1)
        if (nq, n) == wide_l2:
            qn32, an32 = (q * q).sum(1, keepdim=True), (a * a).sum(1)
            b, by, _ = l2_bounds(4 * (nq * d + n * d + nq * n), nq, n, d)
            wide["l2_dist"] = dict(
                tile=f"{nq}x{n}", launches=l2_tiles[wide_l2],
                ms=l2_ms[wide_l2], band_use=band_use, bound_ms=b,
                bound_by=by, plain_ms=cuda_ms(lambda: l2_dist_ref(q, a),
                                              reps=3, warmup=1),
                library_ms=cuda_ms(lambda: torch.addmm(
                    an32[None], q, a.T, alpha=-2.0).add_(qn32), reps=3,
                    warmup=1))
    for rows, n, k in sorted(seg_tiles):
        dmat = l2_dist(base_dev[:rows], base_dev[:n])
        lens = torch.full((rows,), n, dtype=torch.int32,
                          device=base_dev.device)
        v, i = seg_topk(dmat[:16].contiguous(), lens[:16], k)
        vr, ir = seg_topk_ref(dmat[:16].cpu(), lens[:16].cpu(), k)
        if not (torch.equal(v.cpu().view(torch.int32), vr.view(torch.int32))
                and torch.equal(i.cpu(), ir)):
            raise AssertionError(f"seg_topk at ({rows}, {n}, {k}) differs "
                                 "from the plain version")
        seg_ms[(rows, n, k)] = cuda_ms(lambda: seg_topk(dmat, lens, k),
                                       reps=3, warmup=1)
        if (rows, n, k) == wide_seg:
            b, by = bound_ms(4 * rows * n + 4 * rows + 8 * rows * k,
                             rows * n)
            wide["seg_topk"] = dict(
                tile=f"{rows}x{n},k={k}", launches=seg_tiles[wide_seg],
                ms=seg_ms[wide_seg], bound_ms=b, bound_by=by,
                plain_ms=cuda_ms(lambda: seg_topk_ref(dmat, lens, k),
                                 reps=2, warmup=1),
                library_ms=cuda_ms(lambda: torch.topk(dmat, k, dim=1,
                                                      largest=False),
                                   reps=3, warmup=1))
        del dmat
    return l2_ms, seg_ms, wide


def shape_report(counts, shapes):
    """The launch shapes of a main-path run, JSON-ready."""
    return dict(
        seg_topk={f"n={n},k={k}": c for (n, k), c in
                  sorted(shapes["seg_topk"].items())},
        pq_adc=dict(launches=counts["pq_adc"], rows=shapes["pq_adc"]),
        l2_dist=dict(launches=counts["l2_dist"], rows=shapes["l2_dist"]),
        l2_top1={f"K={k},d={d},rows={r}": c for (k, d, r), c
                 in sorted(shapes["l2_top1"].items())})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database vectors of the main path (sift-like) "
                    "and of the graph paths (deep-like)")
    ap.add_argument("--queries", type=int, default=1000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    phase = Phases()

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        # the SM clock the lookup time of pq_adc is counted at
        sm_hz = 1e6 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        print(f"card: {smi}, max SM clock {sm_hz / 1e6:.0f} MHz")

    from repro_torch.kernels import (_build, launch_counts, launch_shapes,
                                     reset_launches)

    with phase("build"):
        libs = _build.build_all()
        for name in _build.KERNELS:
            log = _build.build_log(name) or "(prebuilt)"
            info = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"{name}: " + " | ".join(info))
            mma = sass_tensor_core_count(libs[name])
            print(f"{name}: tensor-core instructions in SASS "
                  f"{json.dumps(mma)}")
            if name in ("l2_dist", "l2_top1") and not sum(mma.values()):
                raise AssertionError(f"{name}: no tensor-core MMA in its "
                                     "SASS")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = []
    with phase("kernels vs plain"):
        results.append(check_l2_dist(dev, gen))
        results.append(check_pq_adc(dev, gen, sm_hz))
        pq256 = check_pq_adc(dev, gen, sm_hz, m=256)
        seg = check_seg_topk(dev, gen, [(n, k) for n in SEG_NS
                                        for k in SEG_KS + (n,)])
        for nq, k, d in TOP1_SHAPES:
            results.append(check_l2_top1(dev, gen, nq, k, d))
        for lanes, rows in RANS_SHAPES:
            results.append(check_rans_decode(dev, lanes, rows, sm_hz))
        rans_wide = check_rans_decode(dev, *RANS_WIDE, sm_hz)
        wt_large = dict(check_wt_rank(*wt_rank_large_args(dev, gen),
                                      "random, p = 0.5"),
                        name="wt_rank(2^24 bits)")
        for r in results + list(seg.values()) + [pq256, rans_wide,
                                                 wt_large]:
            print("  " + json.dumps(r))

    import numpy as np
    from repro_torch.data import make_dataset

    with phase(f"data sift-like n={args.n}"):
        base, queries = make_dataset("sift-like", args.n, args.queries, seed=0)
        gt = exact_topk(torch.from_numpy(base).to(dev),
                        torch.from_numpy(queries).to(dev), TOPK)
        new, _ = make_dataset("sift-like", INGEST_ADDS * INGEST_ROWS, 0,
                              seed=1)
        adds = np.split(new, INGEST_ADDS)
        shard_add, _ = make_dataset("sift-like", SHARD_ADD_ROWS, 0, seed=2)

    from repro_torch.ann.kmeans import kmeans

    with phase("determinism: k-means twice on the card"):
        runs = []
        for _ in range(2):
            t = time.perf_counter()
            runs.append(kmeans(base, NLIST, iters=8, seed=1, device=dev))
            print(f"  kmeans({args.n}, {NLIST}, iters=8): "
                  f"{time.perf_counter() - t:.3f} s")
        a, b = (torch.from_numpy(c).view(torch.int32) for c in runs)
        if not torch.equal(a, b):
            raise AssertionError(
                f"k-means centroids differ between two runs on the card in "
                f"{int((a != b).any(1).sum())} of {NLIST} rows")
        print("  centroids bitwise equal")

    main_path, shapes = {}, []
    cluster_of = ivf_idx = None
    for spec in SPECS:
        with phase(f"main path {spec}"):
            report, counts, spec_shapes, assignment, idx = serve(
                spec, base, queries, gt,
                adds[:PQ_INGEST_ADDS] if "PQ" in spec else adds, dev)
            print("  " + json.dumps(report))
            for k, v in counts.items():
                main_path[k] = main_path.get(k, 0) + v
            shapes.append(spec_shapes)
            cluster_of = assignment if cluster_of is None else cluster_of
            ivf_idx = idx if ivf_idx is None else ivf_idx
            del idx

    # the Flat path and the container path, each counted on its own: every
    # count set to 0 before the path and read after it
    with phase("flat path Flat"):
        flat_report, flat_counts, flat_shapes, flat_idx = serve_flat(
            base, queries, gt, dev)
        print("  " + json.dumps(flat_report))
        print("  Flat launches: " + json.dumps(flat_counts)
              + ", seg_topk by (n, k): " + json.dumps(
                  flat_report["shapes"]["seg_topk"])
              + ", l2_dist rows: " + json.dumps(
                  flat_report["shapes"]["l2_dist"]))
    with phase("container path: save_index, load_index onto the card"):
        cont_ivf, cont_ivf_counts, cont_ivf_shapes = container_path(
            f"{SPECS[0]} after {INGEST_ADDS} adds", ivf_idx,
            dict(nprobe=NPROBE), queries, dev)
        print("  " + json.dumps(cont_ivf))
        cont_flat, cont_flat_counts, cont_flat_shapes = container_path(
            "Flat", flat_idx, {}, queries, dev)
        print("  " + json.dumps(cont_flat))
    # sharded serving over the indexes built above, each path counted on
    # its own (counts set to 0 before it, read after)
    with phase(f"sharded path {SPECS[0]} at 1, 2 and 4 shards, routed add"):
        sh_ivf, sh_ivf_counts, sh_ivf_shapes = shard_ivf_path(
            ivf_idx, queries, shard_add, dev)
        print("  " + json.dumps(sh_ivf))
        mono_qps = sh_ivf["monolith_warm"]["qps"]
        for r in sh_ivf["plans"]:
            w = r["warm"]
            print(f"  {r['nshards']} shards by {r['by']}: warm QPS "
                  f"{w['qps']:.2f} (monolith {mono_qps:.2f}, "
                  f"{r['warm_qps_over_monolith']:.3f}x), p50/p99 "
                  f"{w['p50_latency_ms']:.2f}/{w['p99_latency_ms']:.2f} ms, "
                  f"merge share {w['merge_share']:.4f}; cold QPS "
                  f"{r['cold']['qps']:.2f}")
    with phase(f"sharded path {SPECS[1]} n={min(args.n, SHARD_PQ_N)} "
               "on 2 shards"):
        sh_pq, sh_pq_counts, sh_pq_shapes = shard_pq_path(base, queries, dev)
        print("  " + json.dumps(sh_pq))
    with phase("sharded path Flat on 4 shards, plan saved and loaded"):
        sh_flat, sh_flat_counts, sh_flat_shapes = shard_flat_path(
            flat_idx, queries, dev)
        print("  " + json.dumps(sh_flat))
    with phase(f"sharded container path {SPECS[0]} "
               f"n={min(args.n, SHARD_CONTAINER_N)}: plan saved and loaded"):
        sh_cont, sh_cont_counts, sh_cont_shapes, degraded_plan = \
            shard_container_path(base, queries, dev)
        print("  " + json.dumps(sh_cont))
    sift_queries = queries

    # the block Flat's first query block hands seg_topk (its own distances,
    # lens = n on every row), for timing seg_topk at Flat's width; made
    # after every path's counts were read
    from repro_torch.kernels import l2_dist

    flat_q = torch.from_numpy(queries[:64]).to(dev)
    flat_block = (l2_dist(flat_q, flat_idx.base_dev),
                  torch.full((64,), flat_idx.n, dtype=torch.int32,
                             device=dev))
    del ivf_idx, flat_idx, flat_q
    paths = dict(main=main_path, flat=flat_counts,
                 container_ivf=cont_ivf_counts,
                 container_flat=cont_flat_counts,
                 shard_ivf=sh_ivf_counts, shard_pq=sh_pq_counts,
                 shard_flat=sh_flat_counts, shard_container=sh_cont_counts)

    # the graph paths, each counted on its own; their launches by tile
    l2_tiles, seg_tiles = {}, {}

    def graph_path(name, counts, gshapes):
        paths[name] = counts
        for tiles, key in ((l2_tiles, "l2_dist_tiles"),
                           (seg_tiles, "seg_topk_tiles")):
            for t, c in gshapes[key].items():
                tiles[t] = tiles.get(t, 0) + c

    del base, queries, gt, adds
    with phase(f"data {GRAPH_PRESET} n={args.n}"):
        base, queries = make_dataset(GRAPH_PRESET, args.n, args.queries,
                                     seed=0)
        base_dev = torch.from_numpy(base).to(dev)
        queries_dev = torch.from_numpy(queries).to(dev)
        gt = exact_topk(base_dev, queries_dev, TOPK)
        new, _ = make_dataset(GRAPH_PRESET, INGEST_ADDS * INGEST_ROWS, 0,
                              seed=1)
        adds = np.split(new, INGEST_ADDS)
    with phase(f"graph path {GRAPH_SPECS[0]}"):
        nsg, counts, gshapes, nsg_idx, nsg_head = serve_graph(
            GRAPH_SPECS[0], base, queries, gt, adds, dev)
        print("  " + json.dumps(nsg))
        graph_path("graph_nsg", counts, gshapes)
    with phase("graph step tiles: device path against the host re-score"):
        step_tiles = time_step_tiles(nsg_idx, queries)
        print("  " + json.dumps(step_tiles))
    del nsg_idx
    from repro_torch.ann.graph_scan import KERNEL_MIN_CUDA

    nav_n = min(args.n, GRAPH_NAV_N)
    with phase(f"graph path {GRAPH_SPECS[0]} n={nav_n}, navigable"):
        nav_gt = exact_topk(base_dev[:nav_n], queries_dev, TOPK)
        nav, counts, gshapes, nav_idx, _ = serve_graph(
            GRAPH_SPECS[0], base[:nav_n], queries, nav_gt, [], dev,
            floor=GRAPH_NAV_FLOOR)
        print("  " + json.dumps(nav))
        graph_path("graph_nsg_nav", counts, gshapes)
        gate_rows, gates = gate_passes(GRAPH_SPECS[0], nav_idx, queries,
                                       GRAPH_GATES, dev, GRAPH_GATE_ROUNDS)
        for r in gate_rows:
            print("  " + json.dumps(dict(r, tiles={
                f"{nq}x{n}": c for (nq, n), c in r["tiles"].items()})))
        # every step's tile, from a pass at the smallest gate
        step_tiles_all = gate_rows[0]["tiles"]
        print("  kernel_min by gate: " + json.dumps(
            {"kernel_min_cuda": KERNEL_MIN_CUDA, "step_tiles": {
                f"{nq}x{n}": c for (nq, n), c in step_tiles_all.items()},
             **{str(g): v for g, v in gates.items()}}))
    with phase(f"sharded path {GRAPH_SPECS[0]} n={nav_n} on {SHARD_GRAPH} "
               f"shards, exhaustive at n={SHARD_EXHAUSTIVE_N}"):
        sh_graph, counts, gshapes = shard_graph_path(nav_idx, queries, nav_gt,
                                                     dev)
        print("  " + json.dumps(sh_graph))
        graph_path("shard_nsg", counts, gshapes)
    del nav_idx
    with phase("graph decisions: the card against the CPU"):
        decisions = graph_decisions(base, nsg_head, dev)
        print("  " + json.dumps(decisions))
    del nsg_head
    with phase(f"graph path {GRAPH_SPECS[1]}"):
        hnsw, counts, gshapes, _, _ = serve_graph(
            GRAPH_SPECS[1], base, queries, gt, [], dev)
        print("  " + json.dumps(hnsw))
        graph_path("graph_hnsw", counts, gshapes)
    with phase("graph container path: save_index, load_index onto the card"):
        gcont, counts, gshapes = graph_container_path(base, queries, adds[0],
                                                      dev)
        print("  " + json.dumps(gcont))
        graph_path("graph_container", counts, gshapes)
    with phase("sharded degraded mode: a dead shard, a flaky shard "
               "(not counted)"):
        degraded = degraded_passes(degraded_plan, sift_queries, dev)
        print("  " + json.dumps(degraded))
    del degraded_plan, sift_queries, shard_add
    with phase("graph-path shapes"):
        # the tiles of the ingest's blocks reach past n: score them against
        # the base followed by the added rows
        grown_base = torch.cat([base_dev, torch.from_numpy(new).to(dev)])
        del base_dev
        l2_ms, seg_ms, wide = time_graph_tiles(
            l2_tiles, seg_tiles, grown_base, queries_dev)
        print("  widest graph tiles: " + json.dumps(wide))
        # the graph step's most frequent tile (over every step of the
        # navigable graph's passes), with its bound and addmm
        top_tile = max(step_tiles_all, key=step_tiles_all.get)
        l2_step = check_l2_dist(dev, gen, n=top_tile[1], qb=top_tile[0],
                                d=base.shape[1])
        print("  " + json.dumps(l2_step))
        print("  l2_dist graph tiles (launches, ms): " + json.dumps(
            {f"{nq}x{n}": [c, l2_ms[(nq, n)]]
             for (nq, n), c in sorted(l2_tiles.items())}))
        print("  seg_topk graph tiles (launches, ms): " + json.dumps(
            {f"{r}x{n},k={k}": [c, seg_ms[(r, n, k)]]
             for (r, n, k), c in sorted(seg_tiles.items())}))
    del grown_base
    graph_ms = dict(
        l2_dist=sum(c * l2_ms[t] for t, c in l2_tiles.items()),
        seg_topk=sum(c * seg_ms[t] for t, c in seg_tiles.items()))

    # the main path's own shapes: seg_topk at every (n, k) and l2_top1 at
    # every (K, d, rows) it launched, pq_adc and l2_dist at its mean arena
    # rows
    seg_launches, top1 = {}, {}
    shard_shapes = [sh_ivf_shapes, sh_pq_shapes, sh_flat_shapes,
                    sh_cont_shapes]
    for sh in shapes + [flat_shapes, cont_ivf_shapes,
                        cont_flat_shapes] + shard_shapes:
        for key, c in sh["seg_topk"].items():
            seg_launches[key] = seg_launches.get(key, 0) + c
        for key, c in sh["l2_top1"].items():
            top1[key] = top1.get(key, 0) + c
    mean_rows = {name: round(sum(sh[name] for sh in shapes) / main_path[name])
                 for name in ("pq_adc", "l2_dist")}
    # l2_dist launches at Flat's padded rows (2^20 at 1M) and at the IVF
    # arenas (the main path's mean)
    flat_n = flat_shapes["l2_dist"] // flat_counts["l2_dist"]
    l2_at = dict(arena=main_path["l2_dist"] + cont_ivf_counts["l2_dist"],
                 flat=flat_counts["l2_dist"] + cont_flat_counts["l2_dist"])
    # the sharded paths: l2_dist at the IVF paths' mean arena rows (as the
    # main path) and at each padded width the Flat path launched (its
    # shards' and its monolith's), pq_adc at the PQ path's mean arena rows
    shard_arena = [(sh_ivf_counts, sh_ivf_shapes), (sh_pq_counts, sh_pq_shapes),
                   (sh_cont_counts, sh_cont_shapes)]
    arena_launches = sum(c["l2_dist"] for c, _ in shard_arena)
    shard_l2 = dict(
        arena=arena_launches,
        arena_mean_rows=round(sum(sh["l2_dist"] for _, sh in shard_arena)
                              / max(1, arena_launches)))
    flat_widths = {}
    for (_, n), c in sh_flat_shapes["l2_dist_tiles"].items():
        flat_widths[n] = flat_widths.get(n, 0) + c
    shard_pq = dict(launches=sh_pq_counts["pq_adc"],
                    mean_rows=round(sh_pq_shapes["pq_adc"]
                                    / sh_pq_counts["pq_adc"]))
    with phase("main-path shapes"):
        more = check_seg_topk(dev, gen, [s for s in seg_launches
                                         if s not in seg], flat=flat_block)
        del flat_block
        seg.update(more)
        pq_mean = check_pq_adc(dev, gen, sm_hz, n=mean_rows["pq_adc"])
        l2_mean = check_l2_dist(dev, gen, n=mean_rows["l2_dist"])
        pq_shard = check_pq_adc(dev, gen, sm_hz, n=shard_pq["mean_rows"])
        l2_shard = check_l2_dist(dev, gen, n=shard_l2["arena_mean_rows"])
        # phase 3 timed l2_dist at 2^20 rows, the monolith's width
        l2_full = next(r for r in results if r["name"] == "l2_dist")
        l2_flat_width = {n: l2_full if n == 1 << 20
                         else check_l2_dist(dev, gen, n=n)
                         for n in sorted(flat_widths)}
        top1_at = {}
        for k, d, rows in sorted(top1):
            r = check_l2_top1(dev, gen, rows, k, d)
            top1_at[(k, d, rows)] = dict(r, name=f"l2_top1(K={k},d={d},"
                                               f"rows={rows})")
        for r in (*more.values(), pq_mean, l2_mean, pq_shard, l2_shard,
                  *l2_flat_width.values(), *top1_at.values()):
            print("  " + json.dumps(r))
        print("  seg_topk launches by (n, k): " + json.dumps(
            {f"n={n},k={k}": c for (n, k), c in sorted(seg_launches.items())}))

    with phase("kernel API path: wt_rank, rans_decode"):
        level0 = wavelet_level0(cluster_of)
        wt_args = wt_rank_args(dev, gen, level0)
        streams = [rans_stream(lanes, rows, seed=lanes)
                   for lanes, rows in RANS_SHAPES]
        from repro_torch.kernels.rans_decode import rans_decode
        from repro_torch.kernels.wt_rank import wt_rank

        reset_launches()
        ranks = wt_rank(*wt_args)
        decoded = [rans_decode(*rans_args(dev, h, w, tabs), rows=len(data),
                               r=r) for data, h, w, tabs, r in streams]
        api_path = launch_counts()
        api_routes = launch_shapes()["wt_rank"]
        if not np.array_equal(ranks.cpu().numpy(),
                              level0.rank1_batch(wt_args[2].cpu().numpy())):
            raise AssertionError("wt_rank differs from BitVector.rank1_batch")
        for out, (data, *_rest) in zip(decoded, streams):
            if not np.array_equal(out.cpu().numpy(), data):
                raise AssertionError("rans_decode differs from the encoded "
                                     "symbols")
        results.append(check_wt_rank(
            wt_args, level0, f"level 0 of the IVF{NLIST} wavelet tree"))
        print("  " + json.dumps(results[-1]))
        print(f"  launches: {json.dumps(api_path)}, wt_rank by route: "
              f"{json.dumps(api_routes)}")

    on_api = ("wt_rank", "rans_decode")
    totals = {k: api_path[k] if k in on_api else
              sum(path[k] for path in paths.values()) for k in main_path}
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel of the port never launched on its "
                             f"path: {totals}")

    # each kernel's time a run on its path: launches x time at the shape
    # launched
    by_name = {r["name"]: r for r in results}
    run_ms = dict(
        l2_dist=(l2_at["arena"] * l2_mean["ms"]
                 + l2_at["flat"] * by_name["l2_dist"]["ms"]
                 + shard_l2["arena"] * l2_shard["ms"]
                 + sum(c * l2_flat_width[n]["ms"]
                       for n, c in flat_widths.items())
                 + graph_ms["l2_dist"]),
        pq_adc=(main_path["pq_adc"] * pq_mean["ms"]
                + shard_pq["launches"] * pq_shard["ms"]),
        seg_topk=(sum(c * seg[s]["ms"] for s, c in seg_launches.items())
                  + graph_ms["seg_topk"]),
        l2_top1=sum(c * top1_at[s]["ms"] for s, c in top1.items()),
        wt_rank=api_path["wt_rank"] * by_name["wt_rank"]["ms"],
        rans_decode=sum(r["ms"] for r in results
                        if r["name"].startswith("rans_decode")))
    rans_rows = [r for r in results if r["name"].startswith("rans_decode")]
    keep = ("shape", "ms", "step_cycles", "plain_ms", "bound_ms")
    top_seg = max(seg_launches, key=seg_launches.get)
    shown = dict(by_name, seg_topk=seg[top_seg])
    flat_seg = {f"n={n},k={k}": dict(
        launches=c, **{key: seg[(n, k)][key] for key in (
            "ms", "bound_ms", "plain_ms", "library_ms")})
        for (n, k), c in sorted(flat_shapes["seg_topk"].items())}
    extra = dict(
        l2_dist=dict(mean_rows=mean_rows["l2_dist"],
                     mean_rows_ms=l2_mean["ms"],
                     launches_by_rows={mean_rows["l2_dist"]: l2_at["arena"],
                                       flat_n: l2_at["flat"]},
                     launches_by_path={p: c["l2_dist"]
                                       for p, c in paths.items()},
                     shard=dict(shard_l2, arena_ms=l2_shard["ms"],
                                flat_launches_by_rows={
                                    n: [c, l2_flat_width[n]["ms"]]
                                    for n, c in sorted(flat_widths.items())}),
                     graph=dict(main_path_ms=graph_ms["l2_dist"],
                                knn_tile=wide["l2_dist"],
                                step_tile={key: l2_step[key] for key in (
                                    "shape", "ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "band_use")},
                                step_tile_steps=step_tiles_all[top_tile],
                                step_vs_host=step_tiles,
                                kernel_min_cuda=KERNEL_MIN_CUDA,
                                gates={str(g): v for g, v in gates.items()})),
        pq_adc=dict(lookups=by_name["pq_adc"]["lookups"],
                    lookup_ms=by_name["pq_adc"]["lookup_ms"],
                    mean_rows=mean_rows["pq_adc"], mean_rows_ms=pq_mean["ms"],
                    mean_rows_lookup_ms=pq_mean["lookup_ms"],
                    shard=dict(shard_pq, ms=pq_shard["ms"]),
                    launches_by_path={p: c["pq_adc"]
                                      for p, c in paths.items()},
                    m256={key: pq256[key] for key in (
                        "shape", "chunks", "max_abs_err", "ms", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}),
        seg_topk=dict(shape=f"n={top_seg[0]},k={top_seg[1]}",
                      launches_by_shape={
                          f"n={n},k={k}": [c, seg[(n, k)]["ms"]]
                          for (n, k), c in sorted(seg_launches.items())},
                      flat=flat_seg,
                      launches_by_path={p: c["seg_topk"]
                                        for p, c in paths.items()},
                      graph=dict(main_path_ms=graph_ms["seg_topk"],
                                 knn_tile=wide["seg_topk"],
                                 launches_by_tile={
                                     f"{r}x{n},k={k}": [c, seg_ms[(r, n, k)]]
                                     for (r, n, k), c in
                                     sorted(seg_tiles.items())})),
        l2_top1=dict(launches_by_shape={
            f"K={k},d={d},rows={rows}": [c, top1_at[(k, d, rows)]["ms"]]
            for (k, d, rows), c in sorted(top1.items())},
            launches_by_path={p: c["l2_top1"] for p, c in paths.items()}),
        rans_decode=dict(
            step_cycles=by_name["rans_decode"]["step_cycles"],
            shapes={r["name"]: {k: r[k] for k in keep}
                    for r in rans_rows + [rans_wide]
                    if r["name"] != "rans_decode"}),
        wt_rank=dict(kernel_route=by_name["wt_rank"]["kernel_route"],
                     routes=api_routes,
                     large={k: wt_large[k] for k in (
                         "shape", "kernel_route", "ms", "plain_ms",
                         "bound_ms", "bound_by")}))
    kernels = []
    for name in _build.KERNELS:
        r = shown[name]
        kernels.append({key: r[key] for key in (
            "route", "source", "replaces")} | {
            "name": name,
            "path": "kernel API" if name in on_api else "main path",
            "launches": totals[name]} | {key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_f32_ms", "band_use") if key in r} | {
            "main_path_ms": run_ms[name]} | extra.get(name, {}))
    print(f"phase seconds: {sum(phase.seconds):.3f} in "
          f"{len(phase.seconds)} phases (limit {RUN_LIMIT_S} s)")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
