"""Training driver: any --arch at any scale, fault-tolerant by default —
the port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --reduced --steps 40 --batch 4 --seq 64 --lr 1e-3 --device cpu

Runs on the card unless ``--device cpu``.  Features exercised end to end:
  * ``train.step.make_train_step`` (autograd, AdamW + cosine schedule,
    grad clipping), each step synchronised on its metrics;
  * optional int8 gradient compression (``--compress-grads``);
  * checkpoint/restart: atomic saves every ``--ckpt-every`` in the
    reference's layout, auto-resume from LATEST (``--stop-after`` ends
    the run early, as a crash would);
  * straggler watchdog: logs steps that take more than ``--deadline`` x
    the median step time.
Parameters come from a ``torch.Generator`` seeded 0 (the port's own init
stream, not the reference's); batches from ``TokenPipeline`` (seed 0).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..checkpoint.checkpoint import (latest_step, restore_checkpoint,
                                     save_checkpoint)
from ..configs import get_config, reduced
from ..data.pipeline import TokenPipeline
from ..device import resolve_device
from ..train.optim import AdamWConfig, init_opt
from ..train.step import make_train_step

__all__ = ["main"]


def main(argv=None):
    """Train per ``argv``; returns the losses of the steps run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--deadline", type=float, default=3.0,
                    help="straggler threshold (x median step time)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--stop-after", type=int, default=0,
                    help="simulate a crash: exit after this many steps")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 20))
    model, train_step = make_train_step(cfg, opt_cfg,
                                        compress_grads=args.compress_grads,
                                        device=dev)

    params = model.init(torch.Generator(device=dev).manual_seed(0))
    opt_state = init_opt(params)
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=args.batch,
                         seq_len=args.seq, seed=0)

    start = 0
    if args.ckpt_dir and args.resume == "auto":
        step0 = latest_step(args.ckpt_dir)
        if step0 is not None:
            (params, opt_state), manifest = restore_checkpoint(
                args.ckpt_dir, (params, opt_state))
            pipe.restore(manifest["extra"]["pipeline"])
            start = manifest["step"]
            print(f"[train] resumed from step {start}")

    times = []
    losses = []
    for step in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        t0 = time.perf_counter()
        params, opt_state, metrics = train_step(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(metrics["loss"])
        med = float(np.median(times[-50:]))
        if len(times) > 5 and dt > args.deadline * med:
            print(f"[straggler] step {step} took {dt:.3f}s "
                  f"(median {med:.3f}s)")
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"ce {metrics['ce']:.4f} gnorm {metrics['grad_norm']:.3f} "
                  f"lr {metrics['lr']:.2e} {dt*1e3:.0f}ms", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            pipe.step = step + 1
            save_checkpoint(Path(args.ckpt_dir), step + 1, (params, opt_state),
                            extra={"pipeline": pipe.state()})
        if args.stop_after and step + 1 >= args.stop_after:
            print(f"[train] simulated crash after step {step + 1}")
            return losses
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"({np.mean(times[1:] or times)*1e3:.0f} ms/step)")
    return losses


if __name__ == "__main__":
    main()
