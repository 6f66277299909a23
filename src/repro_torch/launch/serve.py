"""Serving loop: batched LM decode + compressed retrieval side-car.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --batch 8 --prompt-len 32 --gen 32 --retrieval

The port of ``repro.launch.serve``, same CLI and loop, plus ``--device``
(default ``cuda``; raises where no CUDA device is present).  The prompt
is fed token by token through the one-token decode step
(``make_serve_step``) against a KV cache; for the encoder-decoder
(whisper) the prompt is ``--prompt-len`` frames of ``d_model`` (the first
draw of ``default_rng(0)``, as in the reference) run once through the
encoder into the cache's memory, and decoding starts from token 0.  Then
``--gen`` greedy steps
follow (first maximum wins) and tokens/s is reported, with each step's
milliseconds (every step copies its tokens to the host, so a step's time
includes the device's).  With ``--retrieval`` a ``RetrievalIndex`` over
20,000 deep-like vectors (``IVF64,ids=roc``) is mounted on the same device
and searched every 8 steps.  The cache is f32, as in the reference, so a
bf16 config's attention scores against it in f32 (JAX's promotion).

Every family serves: dense, local/global (gemma3), MoE (olmoe,
llama4-scout), the Mamba2 hybrid (zamba2), xLSTM and the
encoder-decoder (whisper).  Parameters come from the port's own init
(``torch.Generator``, seed 0) unless ``main``/``run`` are handed a
:class:`Decoder` or :class:`EncDec` (``params=``, e.g. the reference's
weights through ``params_from_jax``); its own config is then
the model's (``--arch`` must name it), so a model cut in depth serves as
it was built.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.encdec import encdec_prefill_memory
from repro_torch.train.step import make_serve_step

__all__ = ["ServeRun", "parse_args", "run", "main"]

RETRIEVAL_EVERY = 8


@dataclasses.dataclass
class ServeRun:
    tokens: np.ndarray              # (gen, batch) greedy tokens
    step_ms: List[float]            # each generation step, host clock
    prompt_s: float                 # feeding the prompt (or the frames)
    wall_s: float                   # the generation loop
    bits_per_id: Optional[float] = None
    search_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens.size / self.wall_s


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, params=None) -> ServeRun:
    """Serve one batch as ``args`` say; returns the tokens and timings."""
    if params is not None:
        cfg = params.cfg
        if cfg.name != args.arch:
            raise ValueError(f"--arch {args.arch} but the parameters are "
                             f"{cfg.name}'s")
    else:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    device = resolve_device(args.device)
    if device.type == "cuda":
        # bf16 GEMMs reduce in f32, as the reference's dots accumulate
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    model, serve_step = make_serve_step(cfg, device=device)
    if params is None:
        params = model.init(0)
    cache_kw = {"mem_len": args.prompt_len} if cfg.encoder_decoder else {}
    cache = model.init_cache(args.batch, args.prompt_len + args.gen,
                             dtype=torch.float32, **cache_kw)

    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    if cfg.encoder_decoder:
        frames = rng.standard_normal((args.batch, args.prompt_len,
                                      cfg.d_model)).astype(np.float32)
        cache = encdec_prefill_memory(params, cfg,
                                      torch.from_numpy(frames).to(device),
                                      cache)
        tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=device)
    elif cfg.frontend == "vision":
        tok = None
    else:
        # prefill by feeding prompt tokens one at a time (decode path)
        prompt = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        prompt = torch.from_numpy(prompt.astype(np.int32)).to(device)
        for i in range(args.prompt_len):
            tok, cache = serve_step(params, cache,
                                    {"token": prompt[:, i:i + 1]})
        tok = tok[:, None]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prompt_s = time.perf_counter() - t0

    ri = None
    if args.retrieval:
        from repro_torch.data.synthetic import make_dataset
        from repro_torch.retrieval.index import RetrievalIndex

        base, _ = make_dataset("deep-like", 20_000, 10)
        ri = RetrievalIndex(nlist=64, id_codec="roc",
                            device=device).build(base)
        print(f"[serve] retrieval side-car: "
              f"{ri.stats()['bits_per_id']:.2f} bits/id")

    steps = 0
    generated, step_ms, search_ms = [], [], []
    t0 = time.perf_counter()
    for _ in range(args.gen):
        ts = time.perf_counter()
        if cfg.frontend == "vision":
            emb = rng.standard_normal((args.batch, 1, cfg.d_model))
            inputs = {"embedding": torch.from_numpy(
                emb.astype(np.float32)).to(device)}
        else:
            inputs = {"token": tok}
        nxt, cache = serve_step(params, cache, inputs)
        tok = nxt[:, None]
        generated.append(nxt.cpu().numpy())
        step_ms.append(1e3 * (time.perf_counter() - ts))
        steps += 1
        if ri is not None and steps % RETRIEVAL_EVERY == 0:
            q = rng.standard_normal((args.batch, 96)).astype(np.float32)
            ts = time.perf_counter()
            ri.search(q, nprobe=4, topk=5)
            search_ms.append(1e3 * (time.perf_counter() - ts))
    wall = time.perf_counter() - t0
    out = ServeRun(tokens=np.stack(generated), step_ms=step_ms,
                   prompt_s=prompt_s, wall_s=wall, search_ms=search_ms,
                   bits_per_id=ri.stats()["bits_per_id"] if ri else None)
    ms = np.asarray(step_ms)
    print(f"[serve] {out.tokens.size} tokens in {wall:.2f}s -> "
          f"{out.tokens_per_s:,.0f} tok/s (batch {args.batch}); decode "
          f"ms/step mean {ms.mean():.3f} p50 {np.percentile(ms, 50):.3f} "
          f"p99 {np.percentile(ms, 99):.3f} on {device}")
    return out


def main(argv=None, params=None) -> np.ndarray:
    """CLI entry: serve and return the ``(gen, batch)`` greedy tokens."""
    return run(parse_args(argv), params).tokens


if __name__ == "__main__":
    main()
