#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                 # full size: 1M sift-like vectors
    python3 chip_smoke.py --n 200000      # a quicker, smaller main path

Phases, each printed with its seconds; any failure raises and the script
exits non-zero without the final ``ok`` line:

1. environment: card name and power limit (``nvidia-smi``), torch/CUDA;
2. build: every kernel of ``src/repro_torch/csrc`` compiled by ``nvcc``
   (all sources in parallel) into the git-ignored ``build/``;
3. kernels: each CUDA kernel against its plain torch version on the card
   at the main path's shapes — ``seg_topk`` bit-equal, ``l2_dist`` and
   ``pq_adc`` inside the scan's ``rescore_eps`` band — with CUDA-event
   times, a roofline bound from this run's inputs and one library call's
   time as a yardstick;
4. main path: ``IVF1024,ids=roc`` and ``IVF1024,PQ8x8,ids=roc,codes=polya``
   built on the card from 1M ``sift-like`` vectors and served through
   ``AnnService`` (4-query requests, ``max_batch=64``, ``nprobe=16``,
   top-10) twice, with the decoded-id cache cold and then warm; every
   kernel's launch count is read around the serve runs, and results must
   equal ``search_ref`` exactly on the first 64 queries.

The last three lines are the card's name and power limit (as
``nvidia-smi`` gives them), the ``kernels`` JSON and
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 rate and the
# non-tensor f32 rate every kernel here runs at
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12

SPECS = ("IVF1024,ids=roc", "IVF1024,PQ8x8,ids=roc,codes=polya")
NPROBE, TOPK, REQUEST, MAX_BATCH = 16, 10, 4, 64


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


def bound_ms(nbytes, nflops):
    """(least time in ms, "bytes" | "operations") on the card's peaks."""
    tb, tf = nbytes / PEAK_BYTES_S * 1e3, nflops / PEAK_F32_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
    if not bool((err <= rescore_band(d, ref, qn)).all()):
        raise AssertionError(f"l2_dist outside rescore_eps: max err "
                             f"{float(err.max())}")
    qn32, an32 = (q * q).sum(1, keepdim=True), (a * a).sum(1)
    b, by = bound_ms(4 * (qb * d + n * d + qb * n),
                     2 * qb * n * d + 2 * (qb + n) * d + 3 * qb * n)
    return dict(
        name="l2_dist", route="cuda", source="src/repro_torch/csrc/l2_dist.cu",
        replaces="src/repro/kernels/l2_topk/kernel.py:76",
        shape=f"q {qb}x{d}, arena {n}x{d} f32",
        max_abs_err=float(err.max()),
        ms=cuda_ms(lambda: l2_dist(q, a)),
        plain_ms=cuda_ms(lambda: l2_dist_ref(q, a)),
        bound_ms=b, bound_by=by,
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


def serve(spec, base, queries, gt, device):
    """Build ``spec`` on ``device`` and serve ``queries`` through AnnService
    twice: with the decoded-id cache cold, then warm.  Returns (report,
    launch counts of the two serve passes)."""
    import numpy as np
    import torch
    from repro_torch.api import index_factory
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.serve import AnnService, BatchPolicy

    t = time.perf_counter()
    idx = index_factory(spec, device=device).build(base, seed=1)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    svc = AnnService(idx, topk=TOPK, policy=BatchPolicy(max_batch=MAX_BATCH),
                     device=device, nprobe=NPROBE)
    reset_launches()
    cold_t, cold = serve_pass(svc, queries)
    warm_t, warm = serve_pass(svc, queries)
    counts = launch_counts()
    ids_r, d_r, _ = idx.ivf.search_ref(queries[:64], nprobe=NPROBE, topk=TOPK)
    for tickets in (cold_t, warm_t):
        ids = np.concatenate([tk.ids for tk in tickets])
        dists = np.concatenate([tk.dists for tk in tickets])
        if ids.shape != (len(queries), TOPK) or not np.isfinite(dists).all():
            raise AssertionError(f"{spec}: bad result shape or non-finite "
                                 "dists")
        if not (np.array_equal(ids[:64], ids_r)
                and np.array_equal(dists[:64], d_r)):
            raise AssertionError(f"{spec}: served results differ from "
                                 "search_ref")
    recall = float(np.mean([len(set(a) & set(b)) / TOPK
                            for a, b in zip(ids, gt)]))
    return dict(
        spec=spec, n=int(base.shape[0]), build_s=build_s,
        recall_at_10=recall, bits_per_id=idx.ivf.bits_per_id(),
        cold=cold, warm=warm, launches=counts,
        parity_vs_search_ref=True), counts


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

    from repro_torch.kernels import _build

    with phase("build"):
        _build.build_all()
        for name in _build.KERNELS:
            log = _build.build_log(name) or "(prebuilt)"
            info = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
            print(f"{name}: " + " | ".join(info))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = []
    with phase("kernels vs plain"):
        results.append(check_l2_dist(dev, gen))
        results.append(check_pq_adc(dev, gen))
        results.extend(check_seg_topk(dev, gen))
        for r in results:
            print("  " + json.dumps(r))

    from repro_torch.data import make_dataset

    with phase(f"data sift-like n={args.n}"):
        base, queries = make_dataset("sift-like", args.n, args.queries, seed=0)
        gt = exact_topk(torch.from_numpy(base).to(dev),
                        torch.from_numpy(queries).to(dev), TOPK)

    totals = {"l2_dist": 0, "pq_adc": 0, "seg_topk": 0}
    for spec in SPECS:
        with phase(f"main path {spec}"):
            report, counts = serve(spec, base, queries, gt, dev)
            print("  " + json.dumps(report))
            for k, v in counts.items():
                totals[k] += v
    if min(totals.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{totals}")

    kernels = []
    for r in results:
        if r["name"] in totals:
            kernels.append({key: r[key] for key in (
                "name", "route", "source", "replaces")} | {
                "launches": totals[r["name"]]} | {key: r[key] for key in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
