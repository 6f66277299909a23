"""The port's kernel wrappers on the CPU against the JAX package's kernels.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its plain
torch version; here that path is held against the reference oracles
(``l2_dist_ref``, ``pq_adc_ref``, ``seg_topk_ref``, ``seg_topk_xla``) and
the Pallas kernels in interpret mode, on the edge shapes of
``tests/test_kernels.py`` and ``tests/test_select_kernel.py``:

* ``l2_dist``  — within ``rescore_eps(d, v, qn)`` element-wise;
* ``pq_adc``   — within ``rescore_eps(d, v, 0)`` (and exact-ish against
  the numpy ``ProductQuantizer.adc_score``);
* ``seg_topk`` — ``np.array_equal`` on values and columns.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.scan import rescore_eps
from repro.kernels.l2_topk import l2_dist as jax_l2_dist
from repro.kernels.l2_topk import l2_dist_ref as jax_l2_dist_ref
from repro.kernels.pq_adc import pq_adc as jax_pq_adc
from repro.kernels.pq_adc import pq_adc_ref as jax_pq_adc_ref
from repro.kernels.seg_topk import seg_topk as jax_seg_topk
from repro.kernels.seg_topk import seg_topk_ref as jax_seg_topk_ref
from repro.kernels.seg_topk import seg_topk_xla as jax_seg_topk_xla
from repro_torch.kernels import (l2_dist, launch_counts, pq_adc,
                                 reset_launches, seg_topk)

jax.config.update("jax_platforms", "cpu")

_eps = np.vectorize(rescore_eps)


def _assert_in_band(got, want, d, qn):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    band = _eps(d, want, qn)
    assert np.all(np.abs(got - want) <= band), float(np.max(np.abs(got - want)))


# ---------------------------------------------------------------------------
# l2_dist
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nq,n,d", [(1, 1, 8), (3, 7, 32), (17, 513, 32),
                                    (64, 1000, 128), (9, 300, 33),
                                    (300, 70, 96)])
def test_l2_dist_matches_jax(nq, n, d):
    rng = np.random.default_rng(nq * 1000 + n)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    a = rng.standard_normal((n, d)).astype(np.float32)
    a[n // 2] = q[0]                         # a zero distance: cancellation
    got = l2_dist(torch.from_numpy(q), torch.from_numpy(a)).numpy()
    qn = np.einsum("qd,qd->q", q, q)[:, None]
    _assert_in_band(got, jax_l2_dist_ref(jnp.asarray(q), jnp.asarray(a)), d, qn)
    _assert_in_band(got, jax_l2_dist(jnp.asarray(q), jnp.asarray(a)), d, qn)


@pytest.mark.parametrize("nq,n", [(0, 5), (4, 0), (0, 0)])
def test_l2_dist_empty(nq, n):
    out = l2_dist(torch.zeros(nq, 16), torch.zeros(n, 16))
    assert out.shape == (nq, n) and out.dtype == torch.float32
    ref = jax_l2_dist(jnp.zeros((nq, 16)), jnp.zeros((n, 16)))
    assert ref.shape == out.shape


def test_l2_dist_zero_padding_d_preserves_distances():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((6, 20)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((50, 20)).astype(np.float32))
    pad = torch.nn.functional.pad
    qn = (q.double() ** 2).sum(1, keepdim=True).numpy()
    _assert_in_band(l2_dist(pad(q, (0, 12)), pad(a, (0, 12))).numpy(),
                    l2_dist(q, a).numpy(), 32, qn)


# ---------------------------------------------------------------------------
# pq_adc (batched over per-query tables)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 1025, 3000])
@pytest.mark.parametrize("m", [4, 8, 16])
def test_pq_adc_matches_jax(n, m):
    rng = np.random.default_rng(n + m)
    qb = 3
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    luts = (rng.random((qb, m, 256)) * 10).astype(np.float32)
    got = pq_adc(torch.from_numpy(luts), torch.from_numpy(codes)).numpy()
    assert got.shape == (qb, n)
    d = 8 * m
    for i in range(qb):
        cj, lj = jnp.asarray(codes), jnp.asarray(luts[i])
        _assert_in_band(got[i], jax_pq_adc_ref(cj.astype(jnp.int32), lj), d, 0)
        _assert_in_band(got[i], jax_pq_adc(cj, lj), d, 0)


def test_pq_adc_against_numpy_pq_tables():
    from repro.ann.pq import ProductQuantizer

    rng = np.random.default_rng(1)
    x = rng.standard_normal((600, 32)).astype(np.float32)
    cb = rng.standard_normal((8, 256, 4)).astype(np.float32)
    pq = ProductQuantizer(m=8, bits=8, codebooks=cb)
    codes = rng.integers(0, 256, (600, 8)).astype(np.uint8)
    tabs = pq.adc_tables(x[:5])
    got = pq_adc(torch.from_numpy(tabs), torch.from_numpy(codes)).numpy()
    for i in range(5):
        _assert_in_band(got[i], pq.adc_score(codes, tabs[i]), 32, 0)


@pytest.mark.parametrize("qb,n", [(0, 10), (2, 0)])
def test_pq_adc_empty(qb, n):
    out = pq_adc(torch.zeros(qb, 8, 256), torch.zeros(n, 8, dtype=torch.uint8))
    assert out.shape == (qb, n) and out.dtype == torch.float32


# ---------------------------------------------------------------------------
# seg_topk
# ---------------------------------------------------------------------------

def _check_all(dists, lens, k, xla=True):
    """Port == seg_topk_ref == Pallas seg_topk (== seg_topk_xla), exactly."""
    got_v, got_i = seg_topk(torch.from_numpy(np.asarray(dists, np.float32)),
                            torch.from_numpy(np.asarray(lens, np.int32)), k)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    assert got_v.dtype == np.float32 and got_i.dtype == np.int32
    d = jnp.asarray(dists, jnp.float32)
    ln = jnp.asarray(lens, jnp.int32)
    # the reference oracle takes lens already clamped (its wrappers clamp)
    engines = [jax_seg_topk_ref(d, jnp.minimum(ln, d.shape[1]), k),
               jax_seg_topk(d, ln, k)]
    if xla:
        engines.append(jax_seg_topk_xla(d, ln, k))
    for v, i in engines:
        np.testing.assert_array_equal(got_v, np.asarray(v))
        np.testing.assert_array_equal(got_i, np.asarray(i))
    return got_v, got_i


@pytest.mark.parametrize("nq,n,k", [(8, 64, 10), (3, 200, 16), (16, 130, 1),
                                    (1, 7, 4), (5, 33, 33), (9, 1000, 64)])
def test_seg_topk_random(nq, n, k):
    rng = np.random.default_rng(nq + n + k)
    d = rng.standard_normal((nq, n)).astype(np.float32)
    lens = rng.integers(0, n + 1, size=nq)
    _check_all(d, lens, k)


def test_seg_topk_k_exceeds_segment_and_empty_rows():
    d = np.arange(12, dtype=np.float32).reshape(2, 6)
    vals, idx = _check_all(d, np.array([3, 0]), 5)
    np.testing.assert_array_equal(idx, [[0, 1, 2, 3, 4], [0, 1, 2, 3, 4]])
    np.testing.assert_array_equal(vals[0], [0, 1, 2, np.inf, np.inf])


def test_seg_topk_k_exceeds_row_width():
    vals, idx = _check_all(np.array([[3.0, 1.0, 2.0]], np.float32),
                           np.array([3]), 6)
    np.testing.assert_array_equal(idx[0], [1, 2, 0, 3, 4, 5])
    assert np.all(np.isinf(vals[0, 3:]))


def test_seg_topk_ties_at_inf_and_duplicates():
    d = np.full((4, 8), np.inf, np.float32)
    d[3, :4] = [2.0, 2.0, -1.0, 2.0]
    vals, idx = _check_all(d, np.array([8, 3, 0, 5]), 4)
    np.testing.assert_array_equal(idx[:3], [[0, 1, 2, 3]] * 3)
    np.testing.assert_array_equal(idx[3], [2, 0, 1, 3])


def test_seg_topk_tie_pileup_and_signed_zero():
    """-0.0 and +0.0 compare equal and tie by column, as in the Pallas
    kernel and the argsort oracle.  (The reference's ``lax.top_k``
    fallback orders -0.0 first, so it is left out of this case.)"""
    d = np.zeros((3, 50), np.float32)
    d[1, :10] = -1.0
    d[2, ::2] = -0.0
    vals, idx = _check_all(d, np.array([50, 50, 50]), 12, xla=False)
    for row in (0, 2):
        np.testing.assert_array_equal(idx[row], np.arange(12))
    assert np.signbit(vals[2, 0]) and not np.signbit(vals[2, 1])


def test_seg_topk_lens_past_n_are_clamped():
    d = np.random.default_rng(2).standard_normal((3, 20)).astype(np.float32)
    _check_all(d, np.array([25, 20, 1000]), 7)


def test_seg_topk_empty_batch_and_k_zero():
    v, i = seg_topk(torch.zeros(0, 16), torch.zeros(0, dtype=torch.int32), 4)
    assert v.shape == (0, 4) and i.shape == (0, 4)
    v, i = seg_topk(torch.zeros(3, 16), torch.full((3,), 16,
                                                   dtype=torch.int32), 0)
    assert v.shape == (3, 0) and i.shape == (3, 0)


# ---------------------------------------------------------------------------
# wrapper rules: plain version only for CPU tensors, counters count launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["l2_dist", "pq_adc", "seg_topk"])
def test_non_cpu_tensors_never_take_the_plain_version(call):
    """A tensor that is not on the CPU must reach the kernel path, which
    rejects anything but CUDA tensors — no silent plain fallback."""
    meta = torch.device("meta")
    args = {
        "l2_dist": (torch.zeros(2, 8, device=meta),
                    torch.zeros(3, 8, device=meta)),
        "pq_adc": (torch.zeros(2, 8, 256, device=meta),
                   torch.zeros(3, 8, dtype=torch.uint8, device=meta)),
        "seg_topk": (torch.zeros(2, 8, device=meta),
                     torch.zeros(2, dtype=torch.int32, device=meta), 4),
    }[call]
    fn = {"l2_dist": l2_dist, "pq_adc": pq_adc, "seg_topk": seg_topk}[call]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


def test_plain_path_counts_no_launches():
    reset_launches()
    l2_dist(torch.zeros(2, 4), torch.zeros(3, 4))
    pq_adc(torch.zeros(1, 2, 256), torch.zeros(4, 2, dtype=torch.uint8))
    seg_topk(torch.zeros(2, 8), torch.full((2,), 8, dtype=torch.int32), 3)
    assert launch_counts() == {"l2_dist": 0, "pq_adc": 0, "seg_topk": 0}


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        l2_dist(torch.zeros(2, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        pq_adc(torch.zeros(1, 4, 256), torch.zeros(3, 5, dtype=torch.uint8))
    with pytest.raises(ValueError):
        seg_topk(torch.zeros(2, 4), torch.zeros(3, dtype=torch.int32), 2)
