#!/usr/bin/env python3
"""How far xlstm-1.3b's f32 train-step gradients lie from the same
gradients in f64, one process and sharded.

    PYTHONPATH=src python3 tools/xlstm_grad_gap.py              # one card
    PYTHONPATH=src python3 tools/xlstm_grad_gap.py --batch 2 --no-sharded

xlstm-1.3b at full width cut to one super-block (``--layers`` 6: 5 mLSTM
and 1 sLSTM), random weights from seed 0, the ``TokenPipeline`` batch of
seed 0 (``--batch`` x ``--seq`` tokens, as ``chip_smoke.py`` phase 18
trains it), the loss of ``train.step.loss_fn`` under its default
recomputation:

* ``f32`` and ``f64``: the one-process gradients, the model's f32 weights
  (and activations) in f32 and cast to f64;
* ``sharded`` (unless ``--no-sharded``): ``sharded_loss_and_grads`` on a
  (2, 2) ``("data", "model")`` mesh of four gloo ranks spawned on the
  same card (the mixers split by head), each gradient gathered whole.

For each leaf its gap is ``max |g - g64| / max |g64|``; the script prints
the losses, the largest gap of each side and the leaves with the largest
f32 gaps, as JSON.  TF32 is off (``torch.set_float32_matmul_precision(
"highest")``), as in ``chip_smoke.py``.  ``--device cpu`` runs it on the
CPU (with ``--reduced`` for a config small enough there).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402


def _setup(device: str) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0) if device == "cuda" else torch.device(
        "cpu")


def _cfg(args, dtype="float32"):
    from repro_torch.configs import get_config, reduced

    cfg = get_config("xlstm-1.3b")
    if args.reduced:
        cfg = reduced(cfg)
    return dataclasses.replace(cfg, dtype=dtype, n_layers=args.layers)


def _batch(cfg, args, dev):
    from repro_torch.data import TokenPipeline

    b = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                      seq_len=args.seq, seed=0).batch_at(0)
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def _one(args, dev, dtype):
    """``(loss, {leaf: gradient in f64 on the host})`` in one process."""
    from repro_torch.models import build
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.step import loss_fn

    p = init_decoder(0, _cfg(args), dev)
    cfg = _cfg(args, dtype)
    if dtype == "float64":
        p = p.to(torch.float64)
        p.cfg = cfg
    named = list(p.named_parameters())
    loss, _ = loss_fn(build(cfg, device=dev), p, _batch(cfg, args, dev), cfg)
    grads = torch.autograd.grad(loss, [q for _, q in named])
    return float(loss.detach()), {n: g.detach().double().cpu()
                                  for (n, _), g in zip(named, grads)}


def _rank(rank, world, init, out, args):
    torch.set_num_threads(1)
    dev = _setup(args.device)
    from repro_torch.checkpoint import reshard
    from repro_torch.distributed import compat, param_shardings
    from repro_torch.distributed.sharding import unshard
    from repro_torch.launch.mesh import make_mesh_compat
    from repro_torch.models import build
    from repro_torch.models.transformer import init_decoder
    from repro_torch.train.step import sharded_loss_and_grads

    compat.init_distributed(device=str(dev), backend="gloo",
                            init_method=f"file://{init}", world_size=world,
                            rank=rank)
    try:
        mesh = make_mesh_compat((2, 2), ("data", "model"), device=dev)
        cfg = _cfg(args)
        p = init_decoder(0, cfg, dev)
        specs = param_shardings(p, mesh, 0)
        params = reshard(p, specs, mesh)
        del p
        loss, _, grads = sharded_loss_and_grads(
            build(cfg, device=dev), params, _batch(cfg, args, dev), cfg)
        grads = {n: unshard(g.contiguous(), specs[n], mesh).double().cpu()
                 for n, g in grads.items()}
        if rank == 0:
            torch.save((float(loss), grads), Path(out) / "sharded.pt")
    finally:
        torch.distributed.destroy_process_group()


def _gap(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--no-sharded", dest="sharded", action="store_false")
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("xlstm_grad_gap: no CUDA device", file=sys.stderr)
        return 2
    dev = _setup(args.device)
    losses, grads = {}, {}
    if args.sharded:
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank, args=(4, os.path.join(tmp, "init"), tmp, args),
                     nprocs=4)
            losses["sharded"], grads["sharded"] = torch.load(
                Path(tmp) / "sharded.pt")
    for dtype in ("float32", "float64"):
        losses[dtype], grads[dtype] = _one(args, dev, dtype)
    want = grads.pop("float64")
    gaps = {side: {n: _gap(g[n], want[n]) for n in want}
            for side, g in grads.items()}
    worst = sorted(want, key=lambda n: -gaps["float32"][n])[:args.top]
    print(json.dumps(dict(
        batch=[args.batch, args.seq], layers=args.layers,
        device=torch.cuda.get_device_name(0) if args.device == "cuda"
        else "cpu", losses=losses,
        worst={side: max(g.values()) for side, g in gaps.items()},
        leaves={n: {side: gaps[side][n] for side in gaps} for n in worst})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
