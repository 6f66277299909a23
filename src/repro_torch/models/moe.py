"""Mixture-of-Experts layer with static-shape sort-based dispatch.

The port of ``repro.models.moe``, step for step:

  1. router logits -> top-k experts per token (+ softmax weights);
  2. the (tokens*k) assignments are sorted by expert id (stable);
  3. each assignment's position *within its expert* comes from the sorted
     order; assignments beyond the per-expert capacity C are dropped;
  4. tokens are gathered into an (E, C, d) buffer, batched matmuls apply
     the expert FFNs, and results come back weighted by router probs.

Steps 1-3 are :func:`moe_route`, a function of the router logits alone,
so the routing can be held bit for bit given the same logits.  Its order
decisions are the reference's: the top k of each token's probabilities
by a stable descending sort (``lax.top_k`` puts the lower expert first
on ties; ``torch.topk`` does not promise it, and bf16 logits tie often),
the assignments by a stable argsort.  No float atomics: kept rows are
written once into their slots (dropped rows into a sink row past the
buffer), the expert counts are an integer scatter-add (``torch.bincount``
would sync with the card to size its output), and each token's k
contributions are added in the reference's order, expert-ascending, after
a gather through the inverse permutation.

A batch split across processes (the sharded train step's data axes,
``train.step.make_train_step(..., mesh=)``) is routed as the reference
routes the whole batch: inside :func:`split_tokens` each process holds a
contiguous slice of the batch's tokens, the capacity is that of the whole
batch's ``T``, each expert's slots are numbered across the slices in
token order (the counts of the slices before this one, gathered), and the
Switch loss takes the whole batch's token fractions, with this slice's
share of the probability mean (the slices' losses sum to the reference's).
Each data rank still sizes its ``(E, C, d)`` buffer by the whole batch
and fills only its own slots.

Under a model axis that splits the experts (``distributed.tp``: the
sharded steps hand it this rank's model shards), each model rank holds
``E / tp`` contiguous experts and runs the batched matmuls over their
rows of the buffer only; the router's logits are whole (its kernel gathered, the
routing computed alike on every model rank), the gate weights enter by
``copy`` (their gradient summed over the model ranks), and each rank's
combined output, which holds only its experts' contributions, is
summed by ``reduce``.  The shared expert is the dense MLP's split.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed import tp as _tp
from .layers import MLP, Dense, _he, cast, dense, mlp_apply

__all__ = ["MoE", "Routing", "TokenSplit", "moe_apply", "moe_capacity",
           "moe_route", "split_tokens"]


def moe_capacity(n_tokens: int, cfg) -> int:
    """Per-expert capacity with the configured slack factor (may exceed
    ``n_tokens`` below 8 tokens, as in the reference)."""
    k = cfg.experts_per_token
    c = int(cfg.capacity_factor * n_tokens * k / cfg.n_experts)
    return max(8, min(c, n_tokens))


class ExpertDense(nn.Module):
    """One ``(E, d_in, d_out)`` kernel: a dense layer per expert."""

    def __init__(self, n_experts: int, d_in: int, d_out: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(n_experts, d_in, d_out,
                                               device=device))

    def init_(self, gen: torch.Generator) -> None:
        _he(gen, self.kernel, self.kernel.shape[1])


class MoE(nn.Module):
    """``router`` ``(d, E)``, ``wi_gate`` / ``wi_up`` ``(E, d, ff)``, ``wo``
    ``(E, ff, d)`` and, with ``cfg.shared_expert``, a dense ``shared``
    SwiGLU MLP of width ``cfg.d_ff`` applied to every token."""

    def __init__(self, cfg, device=None):
        super().__init__()
        E, d, ff = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        self.router = Dense(d, E, device=device)
        self.wi_gate = ExpertDense(E, d, ff, device)
        self.wi_up = ExpertDense(E, d, ff, device)
        self.wo = ExpertDense(E, ff, d, device)
        self.shared = MLP(d, cfg.d_ff, device=device) \
            if cfg.shared_expert else None

    def init_(self, gen: torch.Generator) -> None:
        for m in (self.router, self.wi_gate, self.wi_up, self.wo,
                  self.shared):
            if m is not None:
                m.init_(gen)


class Routing(NamedTuple):
    expert_ids: torch.Tensor   # (T, k) int64, the top k, best first
    gate: torch.Tensor         # (T, k) f32, renormalised top-k probs
    order: torch.Tensor        # (T*k,) stable argsort of the flat experts
    keep: torch.Tensor         # (T*k,) bool, sorted order: within capacity
    slot: torch.Tensor         # (T*k,) expert * C + position (0 if dropped)
    counts: torch.Tensor       # (E,) int64 assignments per expert (all slices)
    probs: torch.Tensor        # (T, E) f32 softmax of the logits


class TokenSplit(NamedTuple):
    """This process's slice of a batch split into ``n`` equal contiguous
    slices of tokens: its ``index`` and ``gather``, which maps this slice's
    ``(E,)`` int64 expert counts to every slice's, ``(n, E)`` in slice
    order (a collective over the processes)."""
    n: int
    index: int
    gather: Callable[[torch.Tensor], torch.Tensor]


_SPLIT: contextvars.ContextVar = contextvars.ContextVar("moe_split",
                                                        default=None)


@contextlib.contextmanager
def split_tokens(split: TokenSplit):
    """Route every MoE layer inside the block as ``split``'s slice of the
    whole batch (module docstring)."""
    token = _SPLIT.set(split)
    try:
        yield split
    finally:
        _SPLIT.reset(token)


def moe_route(logits: torch.Tensor, k: int, capacity: int,
              split: Optional[TokenSplit] = None) -> Routing:
    """Route ``(T, E)`` f32 router logits to ``k`` experts a token with
    ``capacity`` slots an expert, as the reference does (module
    docstring); with ``split``, as that slice of the whole batch."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    flat_expert = expert_ids.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    counts = torch.zeros(E, dtype=torch.int64, device=logits.device)
    counts.scatter_add_(0, sorted_expert, torch.ones_like(sorted_expert))
    starts = torch.cumsum(counts, 0) - counts
    if split is not None:
        every = split.gather(counts)
        starts = starts - every[:split.index].sum(0)
        counts = every.sum(0)
    pos_in_expert = (torch.arange(T * k, device=logits.device)
                     - starts[sorted_expert])
    keep = pos_in_expert < capacity
    slot = sorted_expert * capacity + torch.where(
        keep, pos_in_expert, torch.zeros_like(pos_in_expert))
    return Routing(expert_ids, gate_vals, order, keep, slot, counts, probs)


def moe_apply(params: MoE, x: torch.Tensor, cfg):
    """x: (B, S, d) -> (B, S, d), plus the Switch-style load-balancing aux
    loss (f32 scalar)."""
    B, S, d = x.shape
    T = B * S
    k = cfg.experts_per_token
    E = cfg.n_experts
    split = _SPLIT.get()
    T_all = T if split is None else T * split.n
    C = moe_capacity(T_all, cfg)
    xt = x.reshape(T, d)

    logits = dense(xt, params.router.kernel).float()              # (T, E)
    r = moe_route(logits, k, C, split)
    sorted_token = torch.div(r.order, k, rounding_mode="floor")
    sorted_gate = r.gate.reshape(-1)[r.order]

    # ---- gather to (E, C, d): each kept slot written once -----------------
    # (under a model axis, this rank's experts' rows E_l x C of it)
    axis = _tp.axis_for(E)
    El, base, src = E, 0, xt
    keep = r.keep
    if axis is not None:
        El = E // axis.size
        _tp.check_local(params.wi_gate.kernel, 0, E, axis, "moe.wi_gate")
        base = axis.index * El * C
        keep = keep & (r.slot >= base) & (r.slot < base + El * C)
        src = _tp.copy(xt, axis)
        sorted_gate = _tp.copy(sorted_gate, axis)
    slot = r.slot - base
    sink = El * C
    buf = torch.zeros((El * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[torch.where(keep, slot, sink)] = src[sorted_token]
    buf = buf[:sink].view(El, C, d)

    # ---- expert FFNs (batched over the expert dim) -------------------------
    g = torch.bmm(buf, cast(params.wi_gate.kernel, buf.dtype))
    u = torch.bmm(buf, cast(params.wi_up.kernel, buf.dtype))
    h = F.silu(g) * u
    out = torch.bmm(h, cast(params.wo.kernel, buf.dtype)).reshape(El * C, d)

    # ---- back to tokens, weighted ------------------------------------------
    zero = torch.zeros_like(slot)
    w = torch.where(keep, sorted_gate, torch.zeros_like(sorted_gate))
    gathered = (out[torch.where(keep, slot, zero)]
                * w[:, None].to(out.dtype)).to(x.dtype)
    # each token's k assignments in sorted (expert-ascending) order: the
    # order the reference's scatter-add sums them in
    inv = torch.empty_like(r.order)
    inv[r.order] = torch.arange(T * k, device=x.device)
    mine = gathered[inv.view(T, k).sort(dim=1).values]            # (T, k, d)
    yt = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for i in range(k):
        yt = yt + mine[:, i]
    if axis is not None:
        yt = _tp.reduce(yt, axis)

    if params.shared is not None:
        yt = yt + mlp_apply(params.shared, xt, cfg.d_ff)

    # load-balancing aux loss (Switch-style): E * sum(frac_tokens * frac_prob)
    frac_tokens = r.counts.float() / max(1, T_all * k)
    frac_probs = r.probs.mean(dim=0) if split is None \
        else r.probs.sum(dim=0) / T_all
    aux = E * torch.sum(frac_tokens * frac_probs)
    return yt.reshape(B, S, d), aux
