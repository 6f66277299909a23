#!/usr/bin/env python3
"""Same-call A/B of the port's ``seg_topk`` and ``pq_adc`` kernels on one card.

    git show 3c8ab66:src/repro_torch/csrc/seg_topk.cu > build/old/seg_topk.cu
    git show 3c8ab66:src/repro_torch/csrc/pq_adc.cu > build/old/pq_adc.cu
    python3 tools/ab_kernels.py build/old

A development tool, not part of the port.  It times, in turns (old, new,
new, old, each from a CUDA graph's replay of 20 calls):

* the earlier ``seg_topk.cu`` in OLD_DIR against the current kernel, at
  the main path's widths (1M vectors: n = 131072 and 262144, k = 32 ..
  2048) and at n = 16384, k = 16 and 64;
* the current ``seg_topk.cu`` built with one block a row against the
  cluster of blocks a row it picks, at n = 16384 .. 262144, k = 32;
* the earlier ``pq_adc.cu`` (4-byte table layout, at most 8 tables a
  block) against the current kernel, and a copy of it allowed 16 tables a
  block, against the current kernel at its own 16 tables;

and prints one JSON line of ``{kernel, shape, old_ms, new_ms}`` records
after the card's name and power limit.  The earlier sources must have the
C entry points of commit 3c8ab66: ``seg_topk_launch(d, lens, vals, idx,
nq, n, k, stream)`` and ``pq_adc_launch(luts, codes, out, qb, n, m, qt,
stream)``.  OLD_DIR must lie inside the checkout (``build/`` is
git-ignored); the variants are built there.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEG_SHAPES = ([(n, k) for n in (131072, 262144)
               for k in (32, 64, 128, 256, 512, 1024, 2048)]
              + [(16384, 16), (16384, 64)])
ONE_BLOCK_NS = (16384, 32768, 131072, 262144)
PQ_ROWS = (1 << 20, 435_760)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("old_dir", type=Path,
                    help="directory with the earlier seg_topk.cu, pq_adc.cu")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels.pq_adc import pq_adc
    from repro_torch.kernels.seg_topk import seg_topk

    old = args.old_dir.resolve()
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
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

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

    def turns(old_fn, new_fn):
        t = [cs.cuda_ms(f, graph=True)
             for f in (old_fn, new_fn, new_fn, old_fn)]
        return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2

    def same(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
