"""Sequence-parallel (flash-decoding style) attention for sharded KV caches
— the port of ``repro.distributed.sp``.

When a decode cell shards the KV cache's *sequence* dim over the "model"
axis (granite/qwen decode_32k, all long_500k cells — see
``cache_shardings``), each shard computes attention over its local KV
slice plus (max, sum-exp) statistics, and one ``pmax`` and two ``psum``
combine them — the flash-decoding two-pass reduction, with bytes
O(B·H·D) instead of O(B·H·T).  Operation for operation the reference's:
f32 scores, ``finfo(float32).min`` at masked slots, ``p`` cast to ``q``'s
dtype before the PV product, the ``1e-30`` floor; mixed dtypes (an f32
query against a bf16 cache) promote as JAX's ``einsum`` does.  The
sharded decode step (``models.attention.decode_attention`` on a
``ShardedCache`` whose spec shards the sequence) calls
:func:`sp_decode_attention` over the group of the sequence's axes.
"""

from __future__ import annotations

import torch

from . import compat

__all__ = ["sp_decode_attention", "make_sp_decode"]


def sp_decode_attention(q, k_shard, v_shard, valid_mask, group):
    """q (B,1,H,D) the same on every rank of ``group``; k/v (B,T_local,KV,D)
    = this rank's sequence shard; valid_mask (B,T_local) marks filled
    slots.

    Returns (B,1,H,D) on every rank, attention over the whole cache (up to
    fp roundoff).
    """
    B, _, H, D = q.shape
    KV = k_shard.shape[2]
    G = H // KV
    dt = torch.promote_types(q.dtype, k_shard.dtype)
    qg = q.reshape(B, KV, G, D).to(dt)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k_shard.to(dt)).float()
    s = s / torch.sqrt(torch.tensor(float(D), device=s.device))
    neg = torch.finfo(torch.float32).min
    s = torch.where(valid_mask[:, None, None, :], s,
                    torch.full((), neg, device=s.device))
    # local statistics
    m_loc = s.amax(dim=-1)                                    # (B,KV,G)
    p = torch.exp(s - m_loc[..., None])
    l_loc = p.sum(dim=-1)
    dt = torch.promote_types(q.dtype, v_shard.dtype)
    o_loc = torch.einsum("bkgt,btkd->bkgd", p.to(q.dtype).to(dt),
                         v_shard.to(dt))
    # global combine: two scalars per head + one vector — O(B*H*D) bytes
    m_glob = compat.pmax(m_loc, group)
    scale = torch.exp(m_loc - m_glob)
    l_glob = compat.psum(l_loc * scale, group)
    o_glob = compat.psum(o_loc * scale[..., None].to(o_loc.dtype), group)
    out = o_glob / torch.clamp(l_glob, min=1e-30)[..., None].to(o_glob.dtype)
    return out.reshape(B, 1, H, D)


def make_sp_decode(mesh, axis: str = "model"):
    """``fn(q, k, v, valid)`` over the live ``mesh``: full-shape (B,1,H,D)
    q and (B,T,KV,D) k / v, (B,T) valid on every rank (as ``shard_map``
    takes them under ``P(None, axis, ...)``); each rank computes over its
    sequence shard of ``axis`` and returns the whole result."""
    group = mesh.group(axis)

    def fn(q, k, v, valid):
        n, i = mesh.axis_size(axis), mesh.index(axis)
        if k.shape[1] % n:
            raise ValueError(f"a cache of {k.shape[1]} slots does not split "
                             f"over the {n} ranks of axis {axis!r}")
        t = k.shape[1] // n

        def mine(x):
            return x.narrow(1, i * t, t)

        return sp_decode_attention(q, mine(k), mine(v), mine(valid), group)

    return fn
