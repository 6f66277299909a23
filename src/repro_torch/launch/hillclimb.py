"""The hill-climb's three comparisons on the dry-run's counts — the port
of ``repro.launch.hillclimb``.

* minitron-4b and llama4-scout-17b-a16e at ``prefill_32k``: the current
  attention (blocked past ``attention._BLOCK_THRESHOLD``, split by heads
  or by sequence on the model axis) against the dense baseline, with the
  threshold raised to ``1 << 30`` (restored afterwards, also when a cell
  fails);
* qwen2-72b at ``train_4k``: ``remat_policy`` ``"full"`` against
  ``"dots"``.

Each side is one full-depth dry-run cell (:func:`probe_total`,
``launch.dryrun.lower_cell``) of rank 0 on the 16 x 16 mesh: the port's
eager layer loop counts every layer, so nothing is extrapolated from
probes.  The output keys are the reference's: ``flops`` (this rank's),
``coll`` (this rank's collective bytes a step), and ``bytes``: this
rank's peak bytes (``memory.peak_bytes``, MemTracker), in place of
XLA's ``bytes accessed``, which the port does not count.  The table is
written to ``experiments/results/torch_hillclimb.json`` or to ``--out``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Optional, Sequence

from ..configs import SHAPES, get_config, reduced as _reduced
from ..configs.base import ModelConfig, ShapeSpec
from ..models import attention as A
from .dryrun import lower_cell

__all__ = ["probe_total", "main", "OUT_PATH"]

OUT_PATH = (Path(__file__).resolve().parents[3] / "experiments" / "results"
            / "torch_hillclimb.json")


def probe_total(cfg: ModelConfig, shape_name: str, *, device="cuda",
                shape: Optional[ShapeSpec] = None,
                mesh_shape: Optional[Sequence[int]] = None):
    """``[flops, bytes, coll]`` of one rank of the cell's step at full
    depth (module docstring)."""
    rec = lower_cell(cfg.name, shape_name, False, device=device, cfg=cfg,
                     shape=shape, mesh_shape=mesh_shape)
    return [rec["cost"]["flops"], float(rec["memory"]["peak_bytes"]),
            float(rec["collectives"]["total_bytes"])]


def _side(c):
    return {"flops": c[0], "bytes": c[1], "coll": c[2]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cpu needs no card)")
    ap.add_argument("--out", type=Path, default=OUT_PATH)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a quick check)")
    ap.add_argument("--seq-len", type=int,
                    help="every cell at this sequence length")
    ap.add_argument("--batch", type=int, help="every cell at this batch")
    ap.add_argument("--mesh", default=None,
                    help="another mesh than 16x16, as DATAxMODEL")
    args = ap.parse_args(argv)
    mesh_shape = (tuple(int(n) for n in args.mesh.split("x"))
                  if args.mesh else None)

    def config(arch):
        cfg = get_config(arch)
        return _reduced(cfg) if args.reduced else cfg

    def shape_of(name):
        s = SHAPES[name]
        return dataclasses.replace(
            s, seq_len=args.seq_len or s.seq_len,
            global_batch=args.batch or s.global_batch)

    def probe(cfg, name):
        return probe_total(cfg, name, device=args.device,
                           shape=shape_of(name), mesh_shape=mesh_shape)

    out = {}
    # --- #1/#2: blocked attention + sharding constraint (prefill cells) ---
    for arch in ("minitron-4b", "llama4-scout-17b-a16e"):
        cfg = config(arch)
        new = probe(cfg, "prefill_32k")
        thr = A._BLOCK_THRESHOLD
        A._BLOCK_THRESHOLD = 1 << 30        # disable blocking+constraint
        try:
            old = probe(cfg, "prefill_32k")
        finally:
            A._BLOCK_THRESHOLD = thr
        out[f"{arch}__prefill_32k"] = {
            "dense_baseline": _side(old),
            "blocked+constraint": _side(new),
            "collective_reduction": old[2] / max(1.0, new[2]),
        }
        print(json.dumps(out[f"{arch}__prefill_32k"], indent=1), flush=True)

    # --- #3: remat policy (qwen2-72b train) -------------------------------
    cfg = config("qwen2-72b")
    full = probe(dataclasses.replace(cfg, remat_policy="full"), "train_4k")
    dots = probe(dataclasses.replace(cfg, remat_policy="dots"), "train_4k")
    out["qwen2-72b__train_4k"] = {
        "remat_full": _side(full),
        "remat_dots": _side(dots),
        "flops_reduction": full[0] / max(1.0, dots[0]),
    }
    print(json.dumps(out["qwen2-72b__train_4k"], indent=1), flush=True)

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    main()
