#!/usr/bin/env python3
"""Decode against prefill in the reference (JAX) and in the port, on the
CPU at reduced sizes, in f32.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/lm_forms.py

For each reduced config (the reference's weights from ``PRNGKey(0)``,
carried into the port by ``params_from_jax``; 2 x 64 numpy-seeded
tokens) prints one JSON line: the largest |decode - prefill| over every
position of each package (the prompt fed one token at a time through the
one-token decode from an empty f32 cache, against the whole-sequence
forward), the logit scale, and the share of positions whose argmax
agrees.  MoE configs run twice: at their capacity factor (a prefill of
128 tokens drops assignments past the capacity, a one-token step never
does) and at ``capacity_factor = 100`` (nothing drops).  The two
packages' columns agree with each other: the port reproduces each of the
reference's forms, also where the two forms disagree.  Whisper (the
encoder-decoder) runs at two memory lengths, 24 frames (dense) and 2100
(past ``_BLOCK_THRESHOLD``: the prefill's encoder and cross-attention
take the blocked path, a one-token decode's cross-attention does not),
2 x 12 decoder tokens fed through the decode after
``encdec_prefill_memory``, against ``encdec_apply``.  A development
tool: it imports both packages, as the tests do.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
from repro.models import encdec as RE
from repro.models import transformer as RT
import repro_torch.configs as PC
from repro_torch.models import encdec as PE
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as PT

B, S = 2, 64
CASES = (("zamba2-2.7b", None), ("olmoe-1b-7b", None), ("olmoe-1b-7b", 100.0),
         ("llama4-scout-17b-a16e", None), ("llama4-scout-17b-a16e", 100.0),
         ("xlstm-1.3b", None), ("gemma3-1b", None))
ENCDEC_ARCH, ENCDEC_DEC_TOKENS = "whisper-medium", 12
ENCDEC_FRAMES = (24, 2100)


def ref_forms(cfg, params, tokens):
    prefill = np.asarray(jax.jit(lambda p, t: RT.decoder_apply(
        p, cfg, tokens=t)[0])(params, tokens))
    step = jax.jit(lambda p, c, t: RT.decoder_decode(p, cfg, c, token=t))
    cache = RT.init_decoder_cache(B, S, cfg, dtype=jnp.float32)
    out = []
    for i in range(S):
        logits, cache = step(params, cache, tokens[:, i:i + 1])
        out.append(np.asarray(logits)[:, 0])
    return prefill, np.stack(out, 1)


def port_forms(cfg, params, tokens):
    tk = torch.from_numpy(tokens)
    with torch.no_grad():
        prefill = PT.decoder_apply(params, cfg, tokens=tk)[0].numpy()
        cache = PT.init_decoder_cache(B, S, cfg, torch.float32, "cpu")
        out = []
        for i in range(S):
            logits, cache = PT.decoder_decode(params, cfg, cache,
                                              token=tk[:, i:i + 1])
            out.append(logits[:, 0].numpy())
    return prefill, np.stack(out, 1)


def ref_encdec_forms(cfg, params, frames, tokens):
    prefill = np.asarray(jax.jit(lambda p, f, t: RE.encdec_apply(
        p, cfg, f, t)[0])(params, frames, tokens))
    cache = RE.init_encdec_cache(B, tokens.shape[1], cfg, jnp.float32,
                                 mem_len=frames.shape[1])
    cache = RE.encdec_prefill_memory(params, cfg, frames, cache)
    step = jax.jit(lambda p, c, t: RE.encdec_decode(p, cfg, c, t))
    out = []
    for i in range(tokens.shape[1]):
        logits, cache = step(params, cache, tokens[:, i:i + 1])
        out.append(np.asarray(logits)[:, 0])
    return prefill, np.stack(out, 1)


def port_encdec_forms(cfg, params, frames, tokens):
    f, tk = torch.from_numpy(frames), torch.from_numpy(tokens)
    with torch.no_grad():
        prefill = PE.encdec_apply(params, cfg, f, tk)[0].numpy()
        cache = PE.init_encdec_cache(B, tokens.shape[1], cfg, torch.float32,
                                     frames.shape[1], "cpu")
        cache = PE.encdec_prefill_memory(params, cfg, f, cache)
        out = []
        for i in range(tokens.shape[1]):
            logits, cache = PE.encdec_decode(params, cfg, cache,
                                             tk[:, i:i + 1])
            out.append(logits[:, 0].numpy())
    return prefill, np.stack(out, 1)


def summary(prefill, decode):
    return dict(max_abs_diff=float(np.abs(decode - prefill).max()),
                logit_scale=float(np.abs(prefill).max()),
                argmax_equal=float(np.mean(decode.argmax(-1)
                                           == prefill.argmax(-1))))


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    for arch, cf in CASES:
        ref_cfg = RC.reduced(RC.get_config(arch))
        cfg = PC.reduced(PC.get_config(arch))
        if cf is not None:
            ref_cfg = dataclasses.replace(ref_cfg, capacity_factor=cf)
            cfg = dataclasses.replace(cfg, capacity_factor=cf)
        tree = RT.init_decoder(jax.random.PRNGKey(0), ref_cfg)
        params = params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                                 device="cpu")
        tokens = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        print(json.dumps(dict(
            arch=arch, capacity_factor=cfg.capacity_factor
            if cfg.n_experts else None,
            reference=summary(*ref_forms(ref_cfg, tree, tokens)),
            port=summary(*port_forms(cfg, params, tokens)))), flush=True)
    ref_cfg = RC.reduced(RC.get_config(ENCDEC_ARCH))
    cfg = PC.reduced(PC.get_config(ENCDEC_ARCH))
    tree = RE.init_encdec(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, tree),
                             device="cpu")
    for n_frames in ENCDEC_FRAMES:
        rng = np.random.default_rng(1)
        frames = rng.standard_normal(
            (B, n_frames, cfg.d_model)).astype(np.float32)
        tokens = rng.integers(0, cfg.vocab_size,
                              (B, ENCDEC_DEC_TOKENS)).astype(np.int32)
        print(json.dumps(dict(
            arch=ENCDEC_ARCH, frames=n_frames,
            reference=summary(*ref_encdec_forms(ref_cfg, tree, frames,
                                                tokens)),
            port=summary(*port_encdec_forms(cfg, params, frames, tokens)))),
            flush=True)


if __name__ == "__main__":
    main()
