"""AdamW with decoupled weight decay and a cosine LR schedule — the port of
``repro.train.optim``, written out in the reference's arithmetic.

``torch.optim.AdamW`` and ``clip_grad_norm_`` are not used: the first folds
the bias corrections and the decay into other roundings, the second adds
1e-6 to the norm where the reference adds 1e-9.  Every scalar of the
schedule is an f32 tensor, as ``jnp`` computes it (not a Python double),
on the host (``step`` lives there, so the schedule neither launches on
the card nor waits for it; the cosine is the C library's ``cosf``, which
is XLA's), and every division by a constant divides by an f32 tensor:
a CUDA kernel turns division by a host scalar into multiplication by its
reciprocal, and ``c / t`` in torch is ``t.reciprocal() * c``, both of
which round otherwise than the reference's ``c / t``.

Parameters are an ``nn.Module`` (``models.transformer.Decoder``,
``models.encdec.EncDec``) and are updated in place under ``no_grad``;
gradients, ``mu`` and ``nu`` are dicts keyed by parameter name, the
moments f32 whatever the parameters' dtype.  On a mesh the parameters
are this rank's shards (``distributed.sharding.Sharded``): the moments
are shards of the same specs (optimizer state shardings mirror params),
the gradients are the sharded step's (this rank's model shard of each
tensor the rules split over "model", whole over the data axes), their
global norm is the ``psum`` over "model" of each rank's squares of its
shards plus, once, the squares of the tensors left whole on that axis,
and each rank updates its own slices.  A parameter written in
place moves its version counter, so ``models.layers.cast`` drops its kept
bf16 copy and the next serve step reads the new weights.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import math
from typing import Dict, NamedTuple

import torch

from ..distributed import compat
from ..distributed.sharding import Sharded, axis_size, only_model

__all__ = ["AdamWConfig", "OptState", "init_opt", "apply_updates", "lr_at"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # parameter name -> f32 first moment
    nu: Dict[str, torch.Tensor]     # parameter name -> f32 second moment
    step: torch.Tensor              # int32 scalar, on the host


def _named(params):
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def init_opt(params) -> OptState:
    """Zero moments (f32, on each parameter's device) and step 0; for a
    ``Sharded`` set of parameters, shards of the same specs."""
    mu = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
          for n, p in _named(params)}
    nu = {n: torch.zeros_like(m) for n, m in mu.items()}
    if isinstance(params, Sharded):
        mu, nu = params.like(mu), params.like(nu)
    return OptState(mu=mu, nu=nu, step=torch.zeros((), dtype=torch.int32))


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """The Python number ``x`` as an f32 scalar tensor on ``like``'s
    device (what ``jnp`` makes of a weakly typed constant)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


@functools.lru_cache(maxsize=None)
def _cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def _host_cos(x: torch.Tensor) -> torch.Tensor:
    """The C library's ``cosf`` of a host f32 scalar: XLA's f32 cos on the
    CPU is that function, while ``torch.cos`` differs from it in the last
    place at about 1% of arguments."""
    return torch.tensor(_cosf()(float(x)), dtype=torch.float32)


def _host_step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32).cpu()


def lr_at(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int32 scalar tensor) as
    a host f32 scalar tensor: linear warmup over ``warmup_steps``, then a
    cosine from ``lr`` down to ``min_lr_ratio * lr`` at
    ``total_steps``."""
    step = _host_step(step)
    warm = torch.minimum(_f32(1.0, step), (step + 1).float()
                         / _f32(max(1, cfg.warmup_steps), step))
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / _f32(max(1, cfg.total_steps - cfg.warmup_steps), step),
                    0.0, 1.0)
    cos = 0.5 * (1 + _host_cos(_f32(math.pi, step) * t))
    scale = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def _sharded_norm(params: Sharded, grads) -> torch.Tensor:
    """The global norm of gradients held as model shards: the ``psum`` over
    "model" of the squares of each rank's shards, plus, once, those of
    the tensors the rules leave whole on that axis (the same on every
    model rank)."""
    dev = next(iter(grads.values())).device
    own = torch.zeros((), dtype=torch.float32, device=dev)
    rest = torch.zeros((), dtype=torch.float32, device=dev)
    for n in params:
        sq = grads[n].float().square().sum()
        if any(only_model(params.specs[n])):
            own = own + sq
        else:
            rest = rest + sq
    own = compat.psum(own, params.mesh.group("model"), axis="model")
    return torch.sqrt(own + rest)


@torch.no_grad()
def apply_updates(params, grads: Dict[str, torch.Tensor],
                  state: OptState, cfg: AdamWConfig):
    """One AdamW step: clip by the global norm, update the moments and the
    parameters in place.  Returns ``(params, new_state, metrics)`` with
    ``metrics = {"grad_norm", "lr"}`` (f32 scalar tensors); ``new_state``
    holds the same moment tensors and ``step + 1``.  ``params`` is a
    module or a ``Sharded`` set of this rank's slices (module
    docstring)."""
    named = _named(params)
    if isinstance(params, Sharded) and axis_size(params.mesh, "model") > 1:
        gnorm = _sharded_norm(params, grads)
    else:
        gnorm = torch.sqrt(sum(grads[n].float().square().sum()
                               for n, _ in named))
    clip = torch.minimum(_f32(1.0, gnorm),
                         _f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9))
    step = _host_step(state.step)
    dev = gnorm.device
    lr = lr_at(step, cfg)
    b1c, b2c = (1 - torch.pow(_f32(b, step), step.float() + 1)
                for b in (cfg.b1, cfg.b2))
    lr_d, b1c_d, b2c_d = (x.to(dev) for x in (lr, b1c, b2c))
    for n, p in named:
        g = grads[n]
        if isinstance(params, Sharded):
            g = params.data_slice(n, g)
        g = g.float() * clip
        m, v = state.mu[n], state.nu[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c_d) / (torch.sqrt(v / b2c_d) + cfg.eps)
        delta += cfg.weight_decay * p.float()
        p.copy_(p.float() - lr_d * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(mu=state.mu, nu=state.nu, step=step + 1), metrics
