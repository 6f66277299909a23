"""The xLSTM gradient gap measured against f64 (run as a script by
tests/test_torch_train_xlstm_f64.py; prints one JSON line).

Gradients of ``loss_fn`` for reduced xlstm-1.3b at the train-step tests'
weights (tests/_torch_train.py), at two batches: ``pipeline``, their
first batch (Zipf tokens), and ``uniform``, tokens drawn uniformly over
the vocabulary (``default_rng(1)``, as tests/_torch_lm.py draws them).
Four ways each: the reference (jitted) and the port in f32, then both in
f64.  For f64 the
config's dtype is float64 and every explicit f32 cast of both packages
is made an f64 one (``jnp.float32``, ``torch.float32``,
``Tensor.float``, torch's default dtype), with ``jax_enable_x64`` on: a
process of its own, since none of that can be undone safely.  Each gap
is ``max`` over tensors of ``max|a - b| / max|b|``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_train import B, S, TrainCase  # noqa: E402

from repro.train import step as RS  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.convert import tree_of  # noqa: E402
from repro_torch.train import step as PS  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def batches(case):
    toks = np.random.default_rng(1).integers(
        0, case.cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return dict(pipeline=case.batches[0],
                uniform={"tokens": toks[:, :-1], "labels": toks[:, 1:]})


def ref_grads(case, f64):
    cfg = dataclasses.replace(case.ref_cfg, dtype="float64") if f64 \
        else case.ref_cfg
    dt = np.float64 if f64 else np.float32
    model = RS.build(cfg)
    params = jax.tree.map(lambda a: jnp.asarray(a.astype(dt)), case.tree)
    grad = jax.jit(jax.grad(lambda p, b: RS.loss_fn(model, p, b, cfg)[0]))
    return {name: [np.asarray(a, np.float64) for a in jax.tree.leaves(
        grad(params, {k: jnp.asarray(v) for k, v in b.items()}))]
        for name, b in batches(case).items()}


def port_grads(case, f64):
    cfg = dataclasses.replace(case.cfg, dtype="float64") if f64 \
        else case.cfg
    params = params_from_jax(cfg, case.tree, device="cpu")
    model, _ = PS.make_train_step(cfg, device="cpu")
    named = list(params.named_parameters())
    out = {}
    for name, b in batches(case).items():
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        loss, _ = PS.loss_fn(model, params, b, cfg)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        tree = tree_of({n: g.double() for (n, _), g in zip(named, grads)})
        out[name] = [np.asarray(a, np.float64) for a in jax.tree.leaves(tree)]
    return out


def gap(got, want):
    return max(float(np.abs(a - b).max() / np.abs(b).max())
               for a, b in zip(got, want))


def main():
    torch.set_num_threads(1)
    case = TrainCase("xlstm-1.3b")
    r32, p32 = ref_grads(case, False), port_grads(case, False)
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    torch.set_default_dtype(torch.float64)
    torch.float32 = torch.float64
    torch.Tensor.float = torch.Tensor.double
    r64, p64 = ref_grads(case, True), port_grads(case, True)
    print(json.dumps({name: dict(
        port64_vs_ref64=gap(p64[name], r64[name]),
        ref32_vs_f64=gap(r32[name], r64[name]),
        port32_vs_f64=gap(p32[name], r64[name]),
        port32_vs_ref32=gap(p32[name], r32[name])) for name in r32}))


if __name__ == "__main__":
    main()
