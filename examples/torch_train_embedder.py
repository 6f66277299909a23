"""Train an LM embedder on the PyTorch port, then mount a compressed
retrieval index on it.

The steps of ``examples/train_embedder.py`` through ``repro_torch``, the
pipeline a kNN-LM / RAG deployment runs:
  1. train a decoder LM for a few hundred steps through
     ``repro_torch.launch.train.main`` (reduced gemma3-1b by default;
     ``--full`` trains gemma3-1b at its published width, and embeds with
     the ~100M-param config below, as the reference example does),
  2. embed a corpus with a model of that config (weights drawn anew from
     seed 7: the index mechanics are the point, not embedding quality),
  3. build a RetrievalIndex with ROC-compressed ids (the paper's feature),
  4. serve queries and report self-recall and the id-compression ledger.

    PYTHONPATH=src python examples/torch_train_embedder.py [--steps 200] [--full]
    PYTHONPATH=src python examples/torch_train_embedder.py --device cpu --steps 20 --docs 640

Runs on the card unless ``--device cpu``; there the index builds with
``l2_top1`` and searches with ``l2_dist`` + ``seg_topk``.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.train import main as train_main
from repro_torch.models import build, count_params
from repro_torch.retrieval.index import RetrievalIndex, embed_corpus


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true",
                    help="gemma3-1b at full width, ~100M-param embedder")
    ap.add_argument("--docs", type=int, default=5_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gemma3-1b")
    if args.full:
        cfg = dataclasses.replace(cfg, n_layers=12, d_model=768, n_heads=4,
                                  n_kv_heads=1, head_dim=192, d_ff=3072,
                                  vocab_size=32_768, vocab_pad_to=1,
                                  sliding_window=256, dtype="float32")
    else:
        cfg = reduced(cfg)

    n_params = count_params(cfg)
    print(f"[1/4] training {cfg.name} ({n_params/1e6:.1f}M params) "
          f"for {args.steps} steps...")
    train_args = ["--arch", "gemma3-1b", "--steps", str(args.steps),
                  "--batch", "4", "--seq", "64", "--lr", "1e-3",
                  "--device", args.device]
    if not args.full:
        train_args.append("--reduced")
    train_main(train_args)

    # a model of the trained shape, its weights drawn anew (train_main keeps
    # its weights internal)
    model = build(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(7))

    print(f"[2/4] embedding {args.docs} documents...")
    pipe = TokenPipeline(vocab=cfg.vocab_size, batch=32, seq_len=64, seed=9)
    batches = [pipe.batch_at(i)["tokens"] for i in range(args.docs // 32)]
    emb = embed_corpus(cfg, params, batches)
    print(f"  embeddings: {emb.shape}")

    print("[3/4] building RetrievalIndex (factory spec: IVF64,ids=roc)...")
    ri = RetrievalIndex(spec="IVF64,ids=roc", device=args.device).build(emb)
    stats = ri.stats()
    print(f"  ids: {stats['bits_per_id']:.2f} bits/id "
          f"(compact would be {stats['compact_bits']:.0f})")

    print("[4/4] querying...")
    qids, _, st = ri.search(emb[:64], nprobe=8, topk=5)
    self_recall = np.mean(qids[:, 0] == np.arange(64))
    print(f"  self-recall@1: {self_recall:.2f} "
          f"({st.wall_s/64*1e3:.2f} ms/query)")


if __name__ == "__main__":
    main()
