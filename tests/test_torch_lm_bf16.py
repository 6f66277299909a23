"""The port's bf16 decode against the reference's (CPU, reduced configs).

The configs keep ``dtype="bfloat16"`` and decode against the serve
loop's f32 cache, so, as in JAX, the bf16 residual stream turns f32 at
the first attention layer's output.  The reference's scanned decode
refuses that carry; its ``decoder_decode(..., unroll=True)`` runs it and
is the oracle.  The reference's weights reach the port through
``params_from_jax``; 2 x 16 numpy-seeded tokens.

* granite-20b (dense, MQA) and olmoe-1b-7b (``capacity_factor`` 100,
  nothing dropped): each step's logits within ``tests/_torch_lm.py::close``
  (10^-4 of the logit scale), the first 8 tokens fed and 8 greedy, the
  greedy tokens equal.
* zamba2-2.7b and xlstm-1.3b run most of a step in bf16 (Mamba2 and
  mLSTM/sLSTM layers before or without attention), where the two
  packages round differently; teacher-forced, the port's bf16 logits lie
  within twice the reference's own bf16-against-f32 gap of the
  reference's bf16 logits (two bf16 roundings of one f32 model, each
  that far from it).

gemma3's ``local_global`` super-block is left out: the reference's inner
scan over its local blocks refuses the carry even unrolled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as RT
from repro_torch.models import build, params_from_jax

from _torch_lm import close, configs, t

jax.config.update("jax_platforms", "cpu")

B, S, FEED = 2, 16, 8
TOKENS = np.random.default_rng(1).integers(0, 256, (B, S)).astype(np.int32)


def _decode(arch, dtype, feed, **changes):
    """(reference, port) logits (B, S, V) of each package's decode from an
    empty f32 cache, the reference unrolled: the first ``feed`` tokens of
    ``TOKENS``, then each package's own greedy tokens."""
    ref_cfg, cfg = configs(arch, dtype=dtype, **changes)
    tree = jax.tree.map(np.asarray,
                        RT.init_decoder(jax.random.PRNGKey(0), ref_cfg))
    step = jax.jit(lambda p, c, tk: RT.decoder_decode(
        p, ref_cfg, c, token=tk, unroll=True))
    cache = RT.init_decoder_cache(B, S, ref_cfg, dtype=jnp.float32)
    want, tok = [], TOKENS[:, :1]
    for i in range(S):
        logits, cache = step(tree, cache, tok)
        logits = np.asarray(logits.astype(jnp.float32))[:, 0]
        want.append(logits)
        tok = (TOKENS[:, i + 1:i + 2] if i + 1 < feed
               else np.argmax(logits, -1)[:, None].astype(np.int32))
    params = params_from_jax(cfg, tree, device="cpu")
    model = build(cfg, device="cpu")
    cache = model.init_cache(B, S, dtype=torch.float32)
    tokens = t(TOKENS)
    got, tok = [], tokens[:, :1]
    with torch.no_grad():
        for i in range(S):
            logits, cache = model.decode_step(params, cache, token=tok)
            got.append(logits[:, 0].float().numpy())
            tok = (tokens[:, i + 1:i + 2] if i + 1 < feed
                   else torch.argmax(logits[:, 0], -1)[:, None].to(
                       torch.int32))
    return np.stack(want, 1), np.stack(got, 1)


@pytest.mark.parametrize("arch,changes", [
    ("granite-20b", {}),
    ("olmoe-1b-7b", {"capacity_factor": 100.0}),
], ids=["granite-20b", "olmoe-1b-7b"])
def test_bf16_decode_equals_the_unrolled_reference(arch, changes):
    want, got = _decode(arch, "bfloat16", FEED, **changes)
    for i in range(S):
        close(got[:, i], want[:, i])
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "xlstm-1.3b"])
def test_bf16_decode_within_the_references_own_bf16_gap(arch):
    want, got = _decode(arch, "bfloat16", S)
    want32, got32 = _decode(arch, "float32", S)
    close(got32, want32)
    gap = float(np.abs(want - want32).max())
    assert float(np.abs(got - want).max()) <= 2 * gap
