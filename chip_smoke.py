#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full size: 1M sift-like vectors
    python3 chip_smoke.py --n 200000      # a quicker, smaller main path

Phases, each printed with its seconds; any failure raises and the script
exits non-zero without the final ``ok`` line:

1. environment: card name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``src/repro_torch/csrc`` compiled by ``nvcc``
   (all sources in parallel) into the git-ignored ``build/``, with each
   kernel's registers and spills and its count of tensor-core MMA
   instructions in the SASS (``cuobjdump -sass``); ``l2_dist`` and
   ``l2_top1`` must have some;
3. kernels vs plain: each CUDA kernel against its plain torch version on
   the card at the main path's shapes — ``seg_topk`` bit-equal;
   ``l2_dist``, ``pq_adc`` and ``l2_top1`` inside the scan's
   ``rescore_eps`` band (``l2_top1`` at the IVF1024 and PQ8x8 k-means
   shapes; ``band_use`` is the largest error over the band); ``rans_decode``
   bit-equal on ``gap_ans``'s quotient model — with CUDA-event times, a
   roofline bound from this run's inputs (``l2_dist`` and ``l2_top1`` at
   the TF32 tensor-core rate, with the old SIMT f32 bound beside it as
   ``bound_f32_ms``) and one library call's time as a yardstick where there
   is one;
4. determinism: k-means (1024 centroids, 8 iterations) twice on the base
   vectors; the centroids must be bitwise equal;
5. main path: ``IVF1024,ids=roc`` and ``IVF1024,PQ8x8,ids=roc,codes=polya``
   built on the card from 1M ``sift-like`` vectors (k-means assignment and
   PQ encoding through ``l2_top1``) and served through ``AnnService``
   (4-query requests, ``max_batch=64``, ``nprobe=16``, top-10) twice,
   with the decoded-id cache cold and then warm; then an ingest pass: five
   ``add`` calls of 10,000 new vectors each (five epochs), and the queries
   served again.  Every kernel's launch count is set to 0 before the build
   and read after the last pass; results must equal ``search_ref`` exactly
   on the first 64 queries, before and after ingest;
6. kernel API path: ``wt_rank`` on level 0 of a wavelet tree over the flat
   index's assignment (2^20 positions, bit-equal to ``BitVector`` and the
   plain version) and ``rans_decode`` on gap_ans-model streams (bit-equal
   to the encoded symbols and the plain version).  No engine calls these
   two, so their launches are counted here.

The last three lines are the card's name and power limit (as
``nvidia-smi`` gives them), the ``kernels`` JSON and
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
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
# rans_decode at (lanes, rows): 2^20 symbols, and one IVF1024 cluster at 1M
RANS_SHAPES = ((128, 8192), (16, 64))
WT_QUERIES = 1 << 20


@contextlib.contextmanager
def phase(name):
    """Print a phase's start and, if it raised nothing, its seconds."""
    t = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok in {time.perf_counter() - t:.3f} s", flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call of ``fn`` by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def check_l2_dist(dev, gen):
    import torch
    from repro_torch.kernels.l2_topk import l2_dist, l2_dist_ref

    qb, n, d = 64, 1 << 20, 128
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
    return dict(
        name="l2_dist", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:76",
        shape=f"q {qb}x{d}, arena {n}x{d} f32",
        max_abs_err=float(err.max()), band_use=band_use,
        ms=cuda_ms(lambda: l2_dist(q, a)),
        plain_ms=cuda_ms(lambda: l2_dist_ref(q, a)),
        bound_ms=b, bound_by=by, bound_f32_ms=b32,
        library_ms=cuda_ms(lambda: torch.addmm(an32[None], q, a.T,
                                               alpha=-2.0).add_(qn32)))


def check_pq_adc(dev, gen):
    import torch
    from repro_torch.kernels.pq_adc import pq_adc, pq_adc_ref

    qb, n, m, d = 64, 1 << 20, 8, 128
    luts = torch.rand(qb, m, 256, device=dev, generator=gen) * 40.0
    codes = torch.randint(0, 256, (n, m), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    out = pq_adc(luts, codes)
    ref = pq_adc_ref(luts, codes)
    torch.cuda.synchronize()
    err = (out.double() - ref.double()).abs()
    if not bool((err <= rescore_band(d, ref, 0.0)).all()):
        raise AssertionError(f"pq_adc outside rescore_eps: max err "
                             f"{float(err.max())}")
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
    return dict(
        name="pq_adc", route="cuda", source="src/repro_torch/csrc/pq_adc.cu",
        replaces="src/repro/kernels/pq_adc/kernel.py:37",
        shape=f"luts {qb}x{m}x256 f32, codes {n}x{m} u8",
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: pq_adc(luts, codes)),
        plain_ms=cuda_ms(lambda: pq_adc_ref(luts, codes), reps=3, warmup=1),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(lambda: torch.nn.functional.embedding_bag(
            bags, table, mode="sum")))


def seg_topk_inputs(dev, gen, qb=64, n=16384):
    """Random rows plus the edge rows: ties, +inf, -0.0/+0.0, lens < k,
    lens = 0, lens past n."""
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
    return d.contiguous(), lens.contiguous()


def check_seg_topk(dev, gen):
    import torch
    from repro_torch.kernels.seg_topk import seg_topk, seg_topk_ref

    qb, n = 64, 16384
    d, lens = seg_topk_inputs(dev, gen, qb, n)
    # the function reads only each row's first min(lens, n) columns
    live = int(lens.clamp(max=n).sum())
    rows = []
    for k in (16, 64):
        v, i = seg_topk(d, lens, k)
        vr, ir = seg_topk_ref(d, lens.clamp(max=n), k)
        torch.cuda.synchronize()
        if not (torch.equal(v.view(torch.int32), vr.view(torch.int32))
                and torch.equal(i, ir)):
            bad = (i != ir).any(1).nonzero().flatten().tolist()
            raise AssertionError(f"seg_topk k={k} differs from the stable "
                                 f"sort in rows {bad[:8]}")
        both = torch.isfinite(v) & torch.isfinite(vr)
        err = float(torch.where(both, (v - vr).abs(), 0.0).max())
        masked = torch.where(
            torch.arange(n, device=dev)[None] < lens[:, None].clamp(max=n),
            d, torch.full((), float("inf"), device=dev))
        b, by = bound_ms(4 * live + 4 * qb + 8 * qb * k, live)
        rows.append(dict(
            name="seg_topk" if k == 16 else f"seg_topk(k={k})",
            route="cuda", source="src/repro_torch/csrc/seg_topk.cu",
            replaces="src/repro/kernels/seg_topk/kernel.py:71",
            shape=f"{qb}x{n} f32, k={k}", max_abs_err=err,
            ms=cuda_ms(lambda: seg_topk(d, lens, k)),
            plain_ms=cuda_ms(lambda: seg_topk_ref(d, lens, k)),
            bound_ms=b, bound_by=by,
            library_ms=cuda_ms(lambda: torch.topk(masked, k, dim=1,
                                                  largest=False))))
    # worst case of the scan's retry path: k doubled up to the padded width
    k = n
    v, i = seg_topk(d, lens, k)
    vr, ir = seg_topk_ref(d, lens.clamp(max=n), k)
    torch.cuda.synchronize()
    if not (torch.equal(v.view(torch.int32), vr.view(torch.int32))
            and torch.equal(i, ir)):
        raise AssertionError("seg_topk k=n differs from the stable sort")
    rows.append(dict(name="seg_topk(k=n)", worst_case_ms=cuda_ms(
        lambda: seg_topk(d, lens, k), reps=1, warmup=0)))
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


def check_rans_decode(dev, lanes, rows):
    """rans_decode bit-equal to the plain step loop and to the symbols."""
    import numpy as np
    import torch
    from repro_torch.kernels.rans_decode import rans_decode, rans_decode_ref

    data, heads, words, tables, r = rans_stream(lanes, rows, seed=lanes)
    args = rans_args(dev, heads, words, tables)
    out = rans_decode(*args, rows=rows, r=r)
    ref = rans_decode_ref(*args, rows=rows, r=r)
    if not (torch.equal(out, ref)
            and np.array_equal(out.cpu().numpy(), data)):
        raise AssertionError(f"rans_decode L={lanes} rows={rows} differs "
                             "from the symbols or the plain version")
    # bytes: heads, words (int32 here), three tables, the symbols; the
    # integer operations (~12 a symbol) never decide the bound
    b, by = bound_ms(4 * (lanes + len(words) + 3 * (1 << r) + rows * lanes),
                     12 * rows * lanes)
    return dict(
        name="rans_decode" if rows >= 1024 else
        f"rans_decode(L={lanes},rows={rows})",
        route="cuda", source="src/repro_torch/csrc/rans_decode.cu",
        replaces="src/repro/kernels/rans_decode/kernel.py:62",
        shape=f"L={lanes} rows={rows} r={r} words={len(words)}",
        max_abs_err=0.0,
        ms=cuda_ms(lambda: rans_decode(*args, rows=rows, r=r), reps=5),
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


def check_wt_rank(args, level0):
    """wt_rank bit-equal to the plain version and to ``BitVector``."""
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import wt_rank, wt_rank_ref

    words, sup, q = args
    out = wt_rank(*args)
    if not (torch.equal(out, wt_rank_ref(*args)) and np.array_equal(
            out.cpu().numpy(), level0.rank1_batch(q.cpu().numpy()))):
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
        shape=f"{level0.nbits} bits (level 0 of the IVF{NLIST} wavelet "
              f"tree), {q.numel()} queries",
        max_abs_err=0.0, ms=cuda_ms(lambda: wt_rank(*args)),
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
    return tickets, dict(
        qps=len(queries) / wall, serve_s=wall,
        p50_latency_ms=float(np.quantile(lat, 0.5)) * 1e3,
        p99_latency_ms=float(np.quantile(lat, 0.99)) * 1e3,
        search_s=st["search_s"], resolve_s=st["resolve_s"],
        decodes=st["decodes"], batches=st["batches"],
        mean_batch=st["mean_batch"], device_selects=st["device_selects"],
        host_block_bytes=st["host_block_bytes"])


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
    (report, launch counts, the built index's assignment)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import launch_counts, reset_launches
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
    recall = float(np.mean([len(set(a) & set(b)) / TOPK
                            for a, b in zip(ids, gt)]))
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
    counts = launch_counts()
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
        launches=counts), counts, cluster_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="database vectors of the main path (sift-like)")
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

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        print(f"card: {smi}")

    from repro_torch.kernels import _build, launch_counts, reset_launches

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
        results.append(check_pq_adc(dev, gen))
        results.extend(check_seg_topk(dev, gen))
        for nq, k, d in TOP1_SHAPES:
            results.append(check_l2_top1(dev, gen, nq, k, d))
        for lanes, rows in RANS_SHAPES:
            results.append(check_rans_decode(dev, lanes, rows))
        for r in results:
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

    main_path = {}
    cluster_of = None
    for spec in SPECS:
        with phase(f"main path {spec}"):
            report, counts, assignment = serve(spec, base, queries, gt, adds,
                                               dev)
            print("  " + json.dumps(report))
            for k, v in counts.items():
                main_path[k] = main_path.get(k, 0) + v
            cluster_of = assignment if cluster_of is None else cluster_of

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
        if not np.array_equal(ranks.cpu().numpy(),
                              level0.rank1_batch(wt_args[2].cpu().numpy())):
            raise AssertionError("wt_rank differs from BitVector.rank1_batch")
        for out, (data, *_rest) in zip(decoded, streams):
            if not np.array_equal(out.cpu().numpy(), data):
                raise AssertionError("rans_decode differs from the encoded "
                                     "symbols")
        results.append(check_wt_rank(wt_args, level0))
        print("  " + json.dumps(results[-1]))
        print(f"  launches: {json.dumps(api_path)}")

    on_api = ("wt_rank", "rans_decode")
    totals = {k: api_path[k] if k in on_api else v
              for k, v in main_path.items()}
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel of the port never launched on its "
                             f"path: {totals}")

    kernels = []
    for r in results:
        if r["name"] in totals:
            kernels.append({key: r[key] for key in (
                "name", "route", "source", "replaces")} | {
                "path": "kernel API" if r["name"] in on_api else "main path",
                "launches": totals[r["name"]]} | {key: r[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "bound_f32_ms", "band_use") if key in r})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
