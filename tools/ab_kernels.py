#!/usr/bin/env python3
"""Same-call A/B of the port's kernels against earlier sources on one card.

    mkdir -p build/old; C=src/repro_torch/csrc
    git show 75a5809:$C/rans_decode.cu > build/old/rans_decode.cu
    git show 75a5809:$C/wt_rank.cu > build/old/wt_rank.cu
    python3 tools/ab_kernels.py build/old

    # seg_topk and pq_adc, against the sources of commit 3c8ab66
    git show 3c8ab66:$C/seg_topk.cu > build/old/seg_topk.cu
    git show 3c8ab66:$C/pq_adc.cu > build/old/pq_adc.cu

A development tool, not part of the port.  Each group runs when its
earlier source is in OLD_DIR, and times in turns (old, new, new, old, each
from a CUDA graph's replay):

* ``rans_decode``: the earlier ``rans_decode.cu`` (C entry point
  ``rans_decode_launch(heads, words, sym_t, freq_t, start_t, out, lanes,
  n_words, rows, r, stream)``) against the current kernel on gap_ans's
  quotient model at (L, rows) = (128, 8192), (16, 64) and (1024, 1024);
  and, for L = 128, 256, 512 and 1024, a copy of the current kernel that
  decodes with one warp of S = 4, 8, 16 or 32 lanes a thread against the
  shipped one (up to 8 warps joined by a named barrier);
* ``wt_rank``: the earlier ``wt_rank.cu`` (``wt_rank_launch(words,
  super_cum, queries, out, nq, n_words, n_super, stream)``) against the
  current kernel, 2^12 to 2^20 random queries over a 1,050,000-bit
  bitvector (the size of level 0 of a 1M-id wavelet tree) and a 2^24-bit
  one; and, at 1,050,000 bits and 2^16 to 2^20 queries, two copies of
  the current kernel against each other, one built to take only the
  global route and one only the resident route (the cut-over
  ``RESIDENT_MIN_QUERIES`` patched), which sets that cut-over;
* ``lds``: one thread chasing pointers through shared memory, each load's
  address the value of the one before: the cycles of one dependent
  ``ld.shared.u32`` (no earlier source needed; always runs);
* ``seg_topk`` and ``pq_adc`` (commit 3c8ab66's sources) at the main
  path's widths;
* ``pq_adc chunks``: the current ``pq_adc`` at m = 256 (64 queries, 2^20
  codes), scored in chunks of ``PQ_CHUNKS`` subquantizers a launch in
  turns (the wrapper's ``M_CHUNK`` set for each), each result bit-equal
  to the plain version, with the time split into the chunks' strided
  copies, the launches, and the later launches' read-back of the partial
  output; this sets ``M_CHUNK`` (no earlier source
  needed; always runs).

Prints the card's name and power limit, then one JSON line of ``{kernel,
shape, old_ms, new_ms}`` records (the ``lds`` record carries
``cycles_per_lds``).  OLD_DIR must lie inside the checkout (``build/`` is
git-ignored); the variants are built there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEG_SHAPES = ([(n, k) for n in (131072, 262144)
               for k in (32, 64, 128, 256, 512, 1024, 2048)]
              + [(16384, 16), (16384, 64)])
ONE_BLOCK_NS = (16384, 32768, 131072, 262144)
PQ_ROWS = (1 << 20, 435_760)
RANS_SHAPES = ((128, 8192), (16, 64), (1024, 1024))
RANS_WIDE_LANES = (128, 256, 512, 1024)
# rans_decode.cu's dispatch past 64 lanes, and the one-warp variant it is
# held against: S = 4, 8, 16 or 32 lanes a thread
RANS_MULTI_WARP = """  } else {
    const int nw = std::min(MAX_WARPS, per_thread);
"""
RANS_ONE_WIDE_WARP = """  } else if (per_thread <= 4) {
    err = launch<4>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else if (per_thread <= 8) {
    err = launch<8>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else if (per_thread <= 16) {
    err = launch<16>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else if (per_thread <= 32) {
    err = launch<32>(s, heads, sym_t, freq_t, start_t, out, lanes, rows, r, st);
  } else {
    const int nw = std::min(MAX_WARPS, per_thread);
"""
PQ_CHUNKS = (8, 16, 24, 32, 48, 64, 128, 224)
WT_BITS = (1_050_000, 1 << 24)
WT_QUERIES = (1 << 20, 1 << 18, 1 << 16, 1 << 14, 1 << 12)
# the two routes against each other, around the cut-over
WT_ROUTE_QUERIES = (1 << 20, 3 << 18, 5 << 17, 1 << 19, 3 << 17,
                    1 << 18, 1 << 16)
ROUTES = ("global", "resident")
LDS_CHASE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// one thread follows a cycle of shared-memory addresses; each load's
// address is the value of the load before it
__global__ void chase(long long* out, int n, int steps) {
  extern __shared__ uint32_t ring[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(ring);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    ring[i] = base + 4u * (uint32_t)((i * 37 + 11) % n);
  __syncthreads();
  if (threadIdx.x) return;
  uint32_t a = base;
  const long long t0 = clock64();
#pragma unroll 16
  for (int k = 0; k < steps; ++k)
    asm volatile("ld.shared.u32 %0, [%0];" : "+r"(a) :: "memory");
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = a;
}
extern "C" int chase_launch(void* out, int n, int steps, void* stream) {
  chase<<<1, 256, n * 4, (cudaStream_t)stream>>>((long long*)out, n, steps);
  return (int)cudaGetLastError();
}
"""


def build(src: Path, out: Path, text: str | None = None) -> ctypes.CDLL:
    """nvcc ``src`` (or ``text`` written to ``src``) into ``out``."""
    from repro_torch.kernels import _build

    if text is not None:
        src.write_text(text)
    subprocess.run([_build.cuda_tool(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True, timeout=600)
    return ctypes.CDLL(str(out))


def patched(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"ab_kernels: {old!r} not found once in the source")
    return text.replace(old, new)


def stream():
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def turns(old_fn, new_fn):
    """(old ms, new ms), timed old, new, new, old."""
    import chip_smoke as cs

    t = [cs.cuda_ms(f, graph=True) for f in (old_fn, new_fn, new_fn, old_fn)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def same(a, b):
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def ab_seg_pq(old: Path, dev, gen):
    import chip_smoke as cs
    import torch
    from repro_torch.kernels.pq_adc import pq_adc
    from repro_torch.kernels.seg_topk import seg_topk

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    libs = {
        "seg_old": build(old / "seg_topk.cu", old / "seg_topk-old.so"),
        "pq_old": build(old / "pq_adc.cu", old / "pq_adc-old.so"),
        "pq_old16": build(old / "pq_adc16.cu", old / "pq_adc16-old.so",
                          patched((old / "pq_adc.cu").read_text(),
                                  "constexpr int QT_MAX = 8;",
                                  "constexpr int QT_MAX = 16;")),
        "seg_one": build(old / "seg_topk_one_block.cu",
                         old / "seg_topk_one_block.so",
                         patched((csrc / "seg_topk.cu").read_text(),
                                 "  nblk = max(1, nblk);", "  nblk = 1;")),
    }

    def old_seg(d, lens, k):
        v = torch.empty(d.shape[0], k, device=dev)
        i = torch.empty(d.shape[0], k, dtype=torch.int32, device=dev)
        fn = libs["seg_old"].seg_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn(d.data_ptr(), lens.data_ptr(), v.data_ptr(), i.data_ptr(),
           d.shape[0], d.shape[1], k, stream())
        return v, i

    def one_block(d, lens, k):
        v = torch.empty(d.shape[0], k, device=dev)
        i = torch.empty(d.shape[0], k, dtype=torch.int32, device=dev)
        fn = libs["seg_one"].seg_topk_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn(d.data_ptr(), lens.data_ptr(), v.data_ptr(), i.data_ptr(), None,
           d.shape[0], d.shape[1], k, stream())
        return v, i

    def old_pq(luts, codes, qt=8, lib="pq_old"):
        qb, m, _ = luts.shape
        out = torch.empty(qb, codes.shape[0], device=dev)
        fn = libs[lib].pq_adc_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn(luts.data_ptr(), codes.data_ptr(), out.data_ptr(), qb,
           codes.shape[0], m, qt, stream())
        return out

    rows = []
    inputs = {}
    for n in sorted({n for n, _ in SEG_SHAPES} | set(ONE_BLOCK_NS)):
        inputs[n] = cs.seg_topk_inputs(dev, gen, 64, n)
    for n, k in SEG_SHAPES:
        d, lens = inputs[n]
        o, w = turns(lambda: old_seg(d, lens, k), lambda: seg_topk(d, lens, k))
        rows.append(dict(kernel="seg_topk", shape=f"64x{n},k={k}",
                         old_ms=o, new_ms=w))
    for n in ONE_BLOCK_NS:
        d, lens = inputs[n]
        if not same(one_block(d, lens, 32), seg_topk(d, lens, 32)):
            raise AssertionError(f"seg_topk n={n}: one block a row differs "
                                 "from the cluster")
        o, w = turns(lambda: one_block(d, lens, 32),
                     lambda: seg_topk(d, lens, 32))
        rows.append(dict(kernel="seg_topk one block a row vs cluster",
                         shape=f"64x{n},k=32", old_ms=o, new_ms=w))
    for n in PQ_ROWS:
        luts = torch.rand(64, 8, 256, device=dev, generator=gen) * 40.0
        codes = torch.randint(0, 256, (n, 8), device=dev, generator=gen,
                              dtype=torch.int32).to(torch.uint8)
        new = pq_adc(luts, codes)
        if not (same([old_pq(luts, codes)], [new])
                and same([old_pq(luts, codes, 16, "pq_old16")], [new])):
            raise AssertionError(f"pq_adc n={n}: the kernels differ")
        o, w = turns(lambda: old_pq(luts, codes), lambda: pq_adc(luts, codes))
        o16, w16 = turns(lambda: old_pq(luts, codes, 16, "pq_old16"),
                         lambda: pq_adc(luts, codes))
        rows.append(dict(kernel="pq_adc", shape=f"64x8x256,n={n}",
                         old_ms=o, new_ms=w))
        rows.append(dict(kernel="pq_adc, old layout at 16 tables a block",
                         shape=f"64x8x256,n={n}", old_ms=o16, new_ms=w16))
    return rows


def ab_rans(old: Path, dev):
    import chip_smoke as cs
    import torch
    from repro_torch.kernels.rans_decode import rans_decode

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    libs = {"old": build(old / "rans_decode.cu", old / "rans_decode-old.so"),
            "wide": build(old / "rans_decode_wide.cu",
                          old / "rans_decode_wide.so",
                          patched((csrc / "rans_decode.cu").read_text(),
                                  RANS_MULTI_WARP, RANS_ONE_WIDE_WARP))}

    def call(lib, args, rows, r):
        heads, words = args[0], args[1]
        out = torch.empty(rows, heads.shape[0], dtype=torch.int32, device=dev)
        fn = libs[lib].rans_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(),
                heads.shape[0], words.shape[0], rows, r, stream())
        if rc:
            raise RuntimeError(f"rans_decode ({lib}) launch failed: {rc}")
        return out

    rows_out = []
    shapes = [("old", L, rows) for L, rows in RANS_SHAPES]
    shapes += [("wide", L, 1024) for L in RANS_WIDE_LANES]
    for lib, L, rows in shapes:
        data, heads, words, tables, r = cs.rans_stream(L, rows, seed=L)
        args = cs.rans_args(dev, heads, words, tables)
        new = rans_decode(*args, rows=rows, r=r)
        if not (same([call(lib, args, rows, r)], [new])
                and torch.equal(new.cpu(), torch.from_numpy(
                    data.astype("int32")))):
            raise AssertionError(f"rans_decode L={L} rows={rows}: {lib} "
                                 "differs")
        o, w = turns(lambda: call(lib, args, rows, r),
                     lambda: rans_decode(*args, rows=rows, r=r))
        name = ("rans_decode" if lib == "old" else
                "rans_decode, one warp (old) vs named-barrier warps (new)")
        rows_out.append(dict(kernel=name, shape=f"L={L},rows={rows},r={r}",
                             old_ms=o, new_ms=w))
    return rows_out


def ab_wt(old: Path, dev, gen):
    import numpy as np
    import torch
    from repro_torch.kernels.wt_rank import pack_bits_u32, wt_rank

    csrc = ROOT / "src" / "repro_torch" / "csrc"
    libs = {"old": build(old / "wt_rank.cu", old / "wt_rank-old.so")}
    # copies of the current kernel that always take one route: the global
    # one (cut-over never reached) and the resident one (wherever it fits)
    for name, at in (("global", "0x7fffffff"), ("resident", "0")):
        text = re.subn(r"constexpr int RESIDENT_MIN_QUERIES = [^;]+;",
                       f"constexpr int RESIDENT_MIN_QUERIES = {at};",
                       (csrc / "wt_rank.cu").read_text())
        if text[1] != 1:
            raise SystemExit("ab_kernels: RESIDENT_MIN_QUERIES not found once")
        libs[name] = build(old / f"wt_rank_{name}.cu",
                           old / f"wt_rank_{name}.so", text[0])
    route_of = libs["resident"].wt_rank_route
    route_of.argtypes = [ctypes.c_int] * 3
    from repro_torch.kernels import _build

    lib_new = _build.library("wt_rank")
    lib_new.wt_rank_route.argtypes = [ctypes.c_int] * 3

    def call(lib, args):
        words, sup, q = args
        out = torch.empty(q.numel(), dtype=torch.int32, device=dev)
        fn = libs[lib].wt_rank_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        rc = fn(*(t.data_ptr() for t in (words, sup, q, out)), q.numel(),
                words.numel(), sup.numel(), stream())
        if rc:
            raise RuntimeError(f"wt_rank ({lib}) launch failed: {rc}")
        return out

    rows = []
    for nbits in WT_BITS:
        bits = (np.random.default_rng(nbits).random(nbits) < 0.5)
        words, sup = pack_bits_u32(bits.astype(np.uint8))
        fits = route_of(len(words), len(sup), 1)
        for nq in sorted(set(WT_QUERIES) | set(WT_ROUTE_QUERIES if fits else ()),
                         reverse=True):
            q = torch.randint(0, nbits + 1, (nq,), device=dev, generator=gen,
                              dtype=torch.int32)
            args = [torch.from_numpy(words.view(np.int32)).to(dev),
                    torch.from_numpy(sup).to(dev), q]
            new = wt_rank(*args)
            if not same([call("old", args)], [new]):
                raise AssertionError(f"wt_rank {nbits} bits: old differs")
            if nq in WT_QUERIES:
                route = ROUTES[lib_new.wt_rank_route(len(words), len(sup), nq)]
                o, w = turns(lambda: call("old", args),
                             lambda: wt_rank(*args))
                rows.append(dict(kernel="wt_rank", shape=f"{nbits} bits, "
                                 f"{nq} queries ({route} route)",
                                 old_ms=o, new_ms=w))
            if fits:
                if not same([call("global", args)], [call("resident", args)]):
                    raise AssertionError("wt_rank: the routes differ")
                o, w = turns(lambda: call("global", args),
                             lambda: call("resident", args))
                rows.append(dict(kernel="wt_rank, global (old) vs resident "
                                 "(new) route", shape=f"{nbits} bits, {nq} "
                                 "queries", old_ms=o, new_ms=w))
    return rows


def pq_chunks(dev, gen, m=256, n=1 << 20, qb=64):
    """pq_adc at m past one launch's tables, in chunks of each of
    PQ_CHUNKS subquantizers, timed forward then backward.  Beside the
    wrapper's time (``ms``), each chunk size reports its parts: the
    strided copies that make each chunk's tables and codes contiguous
    (``copies_ms``), the launches alone on copies made beforehand
    (``kernels_ms``), and the same launches with every one starting from
    0 (``kernels_from_zero_ms``, a wrong sum, timed only), whose gap to
    ``kernels_ms`` is the later launches' read-back of the partial output
    (``readback_ms``)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.pq_adc import ops, pq_adc, pq_adc_ref

    luts = torch.rand(qb, m, 256, device=dev, generator=gen) * 40.0
    codes = torch.randint(0, 256, (n, m), device=dev, generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    want = pq_adc_ref(luts, codes)
    out = torch.empty(qb, n, device=dev)
    shipped = ops.M_CHUNK
    keys = ("ms", "copies_ms", "kernels_ms", "kernels_from_zero_ms")
    ms = {c: {key: [] for key in keys} for c in PQ_CHUNKS}
    try:
        for order in (PQ_CHUNKS, PQ_CHUNKS[::-1]):
            for c in order:
                ops.M_CHUNK = c
                plan = ops.chunk_plan(m)

                def copies():
                    return [(luts[:, a:b].contiguous(),
                             codes[:, a:b].contiguous()) for a, b in plan]

                parts = copies()

                def kernels(first_only_from_zero=True):
                    for i, (lc, cc) in enumerate(parts):
                        ops.launch(lc, cc, out, first_only_from_zero and i > 0)

                if not same(pq_adc(luts, codes), want):
                    raise AssertionError(f"pq_adc in chunks of {c} differs")
                kernels()
                if not same(out, want):
                    raise AssertionError(f"pq_adc launches of {c} differ")
                t = ms[c]
                t["ms"].append(cs.cuda_ms(lambda: pq_adc(luts, codes),
                                          reps=5, graph=True))
                t["copies_ms"].append(cs.cuda_ms(copies, reps=5, graph=True))
                t["kernels_ms"].append(cs.cuda_ms(kernels, reps=5,
                                                  graph=True))
                t["kernels_from_zero_ms"].append(cs.cuda_ms(
                    lambda: kernels(False), reps=5, graph=True))
                del parts
    finally:
        ops.M_CHUNK = shipped
    rows = []
    for c, t in ms.items():
        mean = {key: sum(v) / len(v) for key, v in t.items()}
        rows.append(dict(kernel="pq_adc chunks", shape=f"64x{m}x256, n={n}",
                         chunk=c, launches=len(range(0, m, c)), **mean,
                         readback_ms=(mean["kernels_ms"]
                                      - mean["kernels_from_zero_ms"]),
                         runs=t["ms"]))
    return rows


def lds_chase(old: Path, dev):
    import torch

    lib = build(old / "lds_chase.cu", old / "lds_chase.so", LDS_CHASE)
    fn = lib.chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    steps = 1 << 16
    cycles = []
    for _ in range(5):
        if fn(out.data_ptr(), 4096, steps, stream()):
            raise RuntimeError("lds chase launch failed")
        torch.cuda.synchronize()
        cycles.append(int(out[0]) / steps)
    return [dict(kernel="lds", shape=f"dependent ld.shared.u32 x {steps}",
                 cycles_per_lds=min(cycles), runs=cycles)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir", type=Path,
                    help="directory with the earlier kernel sources")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    old = args.old_dir.resolve()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = lds_chase(old, dev) + pq_chunks(dev, gen)
    if (old / "rans_decode.cu").exists():
        rows += ab_rans(old, dev)
    if (old / "wt_rank.cu").exists():
        rows += ab_wt(old, dev, gen)
    if (old / "seg_topk.cu").exists() and (old / "pq_adc.cu").exists():
        rows += ab_seg_pq(old, dev, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
