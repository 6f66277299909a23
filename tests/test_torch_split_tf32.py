"""The numerical design of the split-TF32 L2 kernels, checked on the CPU.

``csrc/l2_mma.cuh`` computes the dot products of ``l2_dist`` and
``l2_top1`` on TF32 tensor cores.  Each f32 ``x`` is split into
``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``, and a dot product is
``(hi_q . lo_a + lo_q . hi_a) + hi_q . hi_a`` with f32 accumulation (lo . lo
dropped).  Products of TF32 words are exact in f32, so f32 matrix products
of the split words emulate the tensor cores up to the order of the f32
additions.  The distances ``(qn - 2 dot) + an`` must stay inside the scan's
``rescore_eps`` band of the exact (float64) distance, with room to spare;
one pass of TF32 (``hi_q . hi_a`` alone) does not, which is why the kernels
split.
"""

import numpy as np
import pytest
import torch

from repro_torch.ann.scan import rescore_eps
from repro_torch.data import make_dataset

NQ, N, D = 64, 4096, 128


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 bits: round the 13 low mantissa bits off,
    to nearest, ties away from zero (on the magnitude of sign-magnitude bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def expanded(q: torch.Tensor, a: torch.Tensor, dot: torch.Tensor):
    """The kernels' ``(qn - 2 dot) + an`` in f32, norms in f32."""
    qn = (q * q).sum(1, keepdim=True)
    an = (a * a).sum(1)[None]
    return (qn - 2.0 * dot) + an


def band_use(q: torch.Tensor, a: torch.Tensor, dist: torch.Tensor) -> float:
    """max |dist - exact| / rescore_eps(d, exact, qn) over the block."""
    q64, a64 = q.double().numpy(), a.double().numpy()
    qn = (q64 * q64).sum(1, keepdims=True)
    exact = qn - 2.0 * (q64 @ a64.T) + (a64 * a64).sum(1)[None]
    unit = rescore_eps(q.shape[1], 0.0, 0.0)   # band = unit * (1 + |b| + qn)
    band = unit * (1.0 + np.abs(exact) + qn)
    return float((np.abs(dist.double().numpy() - exact) / band).max())


def split_tf32_dist(q, a):
    hq, lq = split(q)
    ha, la = split(a)
    return expanded(q, a, (hq @ la.T + lq @ ha.T) + hq @ ha.T)


def one_pass_tf32_dist(q, a):
    return expanded(q, a, tf32_rna(q) @ tf32_rna(a).T)


def inputs(kind: str):
    rng = np.random.default_rng(13)
    if kind == "randn":
        q = rng.standard_normal((NQ, D)).astype(np.float32)
        a = rng.standard_normal((N, D)).astype(np.float32)
    elif kind == "sift-like":
        a, q = make_dataset("sift-like", N, NQ, seed=13)
    else:   # every coordinate rounds the same way in one pass of TF32
        v = np.float32(1.0 + 2.0 ** -11 - 2.0 ** -23)
        q = np.full((NQ, D), v, np.float32)
        a = np.full((N, D), v, np.float32)
    a[N // 2] = q[0]                          # an exact duplicate: distance 0
    return torch.from_numpy(q), torch.from_numpy(a)


def test_tf32_rna_rounds_ties_away_from_zero():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 3.0, float("inf")],
                     dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 3.0, float("inf")]
    assert tf32_rna(x).tolist() == want
    hi, lo = split(x[[0, 2]])                 # a tie splits exactly
    assert torch.equal(hi + lo, x[[0, 2]])


@pytest.mark.parametrize("kind", ["randn", "sift-like", "aligned"])
def test_split_tf32_stays_well_inside_rescore_eps(kind):
    q, a = inputs(kind)
    use = band_use(q, a, split_tf32_dist(q, a))
    assert use < 0.1, f"split TF32 uses {use:.4f} of rescore_eps on {kind}"


def test_one_pass_tf32_leaves_rescore_eps_on_aligned_input():
    q, a = inputs("aligned")
    assert band_use(q, a, one_pass_tf32_dist(q, a)) > 1.0
