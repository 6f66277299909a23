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
reference's forms, also where the two forms disagree.  A development
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
from repro.models import transformer as RT
import repro_torch.configs as PC
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as PT

B, S = 2, 64
CASES = (("zamba2-2.7b", None), ("olmoe-1b-7b", None), ("olmoe-1b-7b", 100.0),
         ("llama4-scout-17b-a16e", None), ("llama4-scout-17b-a16e", 100.0),
         ("xlstm-1.3b", None), ("gemma3-1b", None))


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


if __name__ == "__main__":
    main()
