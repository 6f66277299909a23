"""The port's kernel wrappers on the CPU against the JAX package's kernels.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its plain
torch version; here that path is held against the reference oracles
(``l2_dist_ref``, ``pq_adc_ref``, ``seg_topk_ref``, ``seg_topk_xla``) and
the Pallas kernels in interpret mode, on the edge shapes of
``tests/test_kernels.py`` and ``tests/test_select_kernel.py``:

* ``l2_dist``  — within ``rescore_eps(d, v, qn)`` element-wise;
* ``pq_adc``   — within ``rescore_eps(d, v, 0)`` (and exact-ish against
  the numpy ``ProductQuantizer.adc_score``);
* ``seg_topk`` — ``np.array_equal`` on values and columns;
* ``l2_top1``  — indices equal, values within 1e-4 (the reference
  tests' tolerance), lowest index on tied centroids;
* ``wt_rank`` and ``pack_bits_u32`` — bit-exact;
* ``rans_decode`` and ``make_tables`` — bit-exact against the reference's
  ``lax.scan`` oracle and the encoded symbols (not against its Pallas
  kernel, which does not run on the installed jax).

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
from repro.kernels.l2_topk import l2_top1 as jax_l2_top1
from repro.kernels.l2_topk import l2_top1_ref as jax_l2_top1_ref
from repro.kernels.pq_adc import pq_adc as jax_pq_adc
from repro.kernels.pq_adc import pq_adc_ref as jax_pq_adc_ref
from repro.kernels.seg_topk import seg_topk as jax_seg_topk
from repro.kernels.seg_topk import seg_topk_ref as jax_seg_topk_ref
from repro.kernels.seg_topk import seg_topk_xla as jax_seg_topk_xla
from repro.kernels.rans_decode import make_tables as jax_make_tables
from repro.kernels.rans_decode import rans_decode_ref as jax_rans_decode_ref
from repro.kernels.wt_rank import pack_bits_u32 as jax_pack_bits_u32
from repro.kernels.wt_rank import wt_rank as jax_wt_rank
from repro.kernels.wt_rank import wt_rank_ref as jax_wt_rank_ref
from repro.core.vrans import VRans16Encoder as RefVRans16Encoder
from repro_torch.core.vrans import VRans16Decoder, VRans16Encoder
from repro_torch.kernels import (l2_dist, l2_top1,
                                 launch_counts, make_tables, pack_bits_u32,
                                 pq_adc, rans_decode, rans_decode_ref,
                                 reset_launches, seg_topk, wt_rank,
                                 wt_rank_ref)

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
# l2_top1
# ---------------------------------------------------------------------------

def _check_top1(q, c):
    """Port == reference Pallas l2_top1 (interpret) == reference oracle:
    indices equal, values within the reference tests' 1e-4."""
    idx, val = l2_top1(torch.from_numpy(q), torch.from_numpy(c))
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    qj, cj = jnp.asarray(q), jnp.asarray(c)
    for ridx, rval in (jax_l2_top1(qj, cj), jax_l2_top1_ref(qj, cj)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_allclose(val.numpy(), np.asarray(rval), rtol=1e-4,
                                   atol=1e-4)
    return idx.numpy(), val.numpy()


@pytest.mark.parametrize("nq,k,d", [(64, 100, 32), (300, 1024, 128),
                                    (256, 77, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2_top1_matches_jax(nq, k, d, dtype):
    """bfloat16 inputs are cast to f32 by both wrappers, so both see the
    same rounded values."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if dtype == "bfloat16":
        q = np.array(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
        c = np.array(jnp.asarray(c, jnp.bfloat16).astype(jnp.float32))
        tq = torch.from_numpy(q).to(torch.bfloat16)
        tc = torch.from_numpy(c).to(torch.bfloat16)
        got = l2_top1(tq, tc)
        want = _check_top1(q, c)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])
    else:
        _check_top1(q, c)


@pytest.mark.parametrize("nq", [0, 1, 255, 256, 257])
def test_l2_top1_padding_edges(nq):
    rng = np.random.default_rng(31)
    q = rng.standard_normal((nq, 24)).astype(np.float32)
    c = rng.standard_normal((77, 24)).astype(np.float32)
    if nq:
        _check_top1(q, c)
    else:
        i, v = l2_top1(torch.from_numpy(q), torch.from_numpy(c))
        ri, rv = jax_l2_top1(jnp.asarray(q), jnp.asarray(c))
        assert i.shape == v.shape == ri.shape == rv.shape == (0,)


def test_l2_top1_duplicated_centroids_pick_the_lowest_index():
    rng = np.random.default_rng(7)
    c = rng.standard_normal((40, 16)).astype(np.float32)
    c[[9, 17, 33]] = c[3]                    # four copies of centroid 3
    c[25] = c[30]
    q = np.concatenate([c[[3, 9, 33, 30, 25]],
                        c[3][None] + 1e-3,
                        rng.standard_normal((20, 16)).astype(np.float32)])
    idx, _ = _check_top1(q, c)
    np.testing.assert_array_equal(idx[:6], [3, 3, 3, 25, 25, 3])


def test_l2_top1_empty_centroids():
    i, v = l2_top1(torch.ones(3, 4), torch.zeros(0, 4))
    np.testing.assert_array_equal(i.numpy(), [0, 0, 0])
    assert np.all(np.isposinf(v.numpy())) and i.dtype == torch.int32
    ri, rv = jax_l2_top1(jnp.ones((3, 4)), jnp.zeros((0, 4)))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


# ---------------------------------------------------------------------------
# wt_rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 1000, 100_000])
@pytest.mark.parametrize("p", [0.05, 0.5, 0.95])
def test_wt_rank_matches_jax(n, p):
    rng = np.random.default_rng(6)
    bits = (rng.random(n) < p).astype(np.uint8)
    words, super_cum = pack_bits_u32(bits)
    ref_words, ref_super = jax_pack_bits_u32(bits)
    assert words.dtype == ref_words.dtype == np.uint32
    assert super_cum.dtype == ref_super.dtype == np.int32
    np.testing.assert_array_equal(words, ref_words)
    np.testing.assert_array_equal(super_cum, ref_super)
    edges = [0, n, 1, n - 1] + [b for b in (31, 32, 33, 511, 512, 513, 1024)
                                if b <= n]
    queries = np.concatenate([edges, rng.integers(0, n + 1, size=777)]
                             ).astype(np.int32)
    got = wt_rank(torch.from_numpy(words.view(np.int32)),
                  torch.from_numpy(super_cum), torch.from_numpy(queries))
    assert got.dtype == torch.int32
    want = np.concatenate([[0], np.cumsum(bits)])[queries]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_wt_rank_ref(
        jnp.asarray(bits), jnp.asarray(queries))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_wt_rank(
        jnp.asarray(words), jnp.asarray(super_cum), jnp.asarray(queries))))


def test_wt_rank_out_of_range_queries_give_minus_one():
    words, super_cum = pack_bits_u32(np.ones(100, np.uint8))
    q = np.array([-1, 0, 100, 32 * len(words), 32 * len(words) + 1],
                 np.int32)
    got = wt_rank_ref(torch.from_numpy(words.view(np.int32)),
                      torch.from_numpy(super_cum), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), [-1, 0, 100, 100, -1])
    short = torch.from_numpy(super_cum[:1])
    got = wt_rank_ref(torch.from_numpy(words.view(np.int32)), short,
                      torch.from_numpy(np.array([511, 512], np.int32)))
    np.testing.assert_array_equal(got.numpy(), [100, -1])


# ---------------------------------------------------------------------------
# rans_decode
# ---------------------------------------------------------------------------

def _geom_freqs(alpha: int, r: int) -> np.ndarray:
    f = np.maximum(1, (1 << r) >> (np.arange(alpha) + 1)).astype(np.int64)
    f[0] += (1 << r) - f.sum()
    return f


def _rans_stream(r, alpha, rows, lanes, seed):
    """Skewed symbols, encoded by the port's 32/16 coder (reverse rows)."""
    rng = np.random.default_rng(seed)
    freqs = _geom_freqs(alpha, r)
    starts = np.cumsum(freqs) - freqs
    data = rng.choice(alpha, size=(rows, lanes), p=freqs / freqs.sum())
    enc, ref_enc = VRans16Encoder(lanes), RefVRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
        ref_enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    ref_heads, ref_words = ref_enc.finalize()
    np.testing.assert_array_equal(heads, ref_heads)
    np.testing.assert_array_equal(words, ref_words)
    return freqs, data, heads, words


@pytest.mark.parametrize("lanes", [16, 128])
@pytest.mark.parametrize("rows", [1, 7, 64])
@pytest.mark.parametrize("r,alpha", [(8, 16), (12, 24), (16, 64)])
def test_rans_decode_matches_jax_oracle(r, alpha, rows, lanes):
    freqs, data, heads, words = _rans_stream(r, alpha, rows, lanes, seed=3)
    tables = make_tables(freqs, r)
    for got, want in zip(tables, jax_make_tables(freqs, r)):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    out = rans_decode(torch.from_numpy(heads.view(np.int32)),
                      torch.from_numpy(words.astype(np.int32)),
                      *(torch.from_numpy(t) for t in tables), rows=rows, r=r)
    assert out.dtype == torch.int32 and out.shape == (rows, lanes)
    np.testing.assert_array_equal(out.numpy(), data)
    # the oracle gathers past the stream's end: it takes the reference's
    # L slack words, the port reads 0 there without them
    oracle = jax_rans_decode_ref(
        jnp.asarray(heads), jnp.pad(jnp.asarray(words.astype(np.uint32)),
                                    (0, lanes)),
        *(jnp.asarray(t) for t in tables), rows=rows, r=r)
    np.testing.assert_array_equal(out.numpy(), np.asarray(oracle))
    dec = VRans16Decoder(heads, words)
    sym_t = tables[0]
    for t in range(rows):
        cf = dec.peek_cf(r)
        sym = sym_t[cf]
        np.testing.assert_array_equal(sym, out.numpy()[t])
        dec.advance(tables[2][cf], tables[1][cf], r)


def test_rans_decode_gap_ans_quotient_model():
    """gap_ans's own quotient table (r = 12, 24 symbols)."""
    from repro_torch.core import gap_ans

    r = gap_ans._Q_PRECISION
    freqs, starts = gap_ans._QF, gap_ans._QC
    rng = np.random.default_rng(11)
    lanes, rows = 8, 40
    data = rng.choice(len(freqs), size=(rows, lanes), p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    tables = [torch.from_numpy(t) for t in make_tables(freqs, r)]
    out = rans_decode(torch.from_numpy(heads.view(np.int32)),
                      torch.from_numpy(words.astype(np.int32)), *tables,
                      rows=rows, r=r)
    np.testing.assert_array_equal(out.numpy(), data)
    np.testing.assert_array_equal(
        rans_decode_ref(torch.from_numpy(heads.view(np.int32)),
                        torch.from_numpy(words.astype(np.int32)), *tables,
                        rows=rows, r=r).numpy(), data)


# ---------------------------------------------------------------------------
# wrapper rules: plain version only for CPU tensors, counters count launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["l2_dist", "pq_adc", "seg_topk", "l2_top1",
                                  "wt_rank", "rans_decode"])
def test_non_cpu_tensors_never_take_the_plain_version(call):
    """A tensor that is not on the CPU must reach the kernel path, which
    rejects anything but CUDA tensors — no silent plain fallback."""
    meta = torch.device("meta")
    i32 = dict(dtype=torch.int32, device=meta)
    args = {
        "l2_dist": (torch.zeros(2, 8, device=meta),
                    torch.zeros(3, 8, device=meta)),
        "pq_adc": (torch.zeros(2, 8, 256, device=meta),
                   torch.zeros(3, 8, dtype=torch.uint8, device=meta)),
        "seg_topk": (torch.zeros(2, 8, device=meta),
                     torch.zeros(2, dtype=torch.int32, device=meta), 4),
        "l2_top1": (torch.zeros(2, 8, device=meta),
                    torch.zeros(3, 8, device=meta)),
        "wt_rank": (torch.zeros(32, **i32), torch.zeros(3, **i32),
                    torch.zeros(5, **i32)),
        "rans_decode": (torch.zeros(4, **i32), torch.zeros(9, **i32),
                        *(torch.zeros(256, **i32) for _ in range(3)), 2, 8),
    }[call]
    fn = {"l2_dist": l2_dist, "pq_adc": pq_adc, "seg_topk": seg_topk,
          "l2_top1": l2_top1, "wt_rank": wt_rank,
          "rans_decode": rans_decode}[call]
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)


def test_plain_path_counts_no_launches():
    reset_launches()
    l2_dist(torch.zeros(2, 4), torch.zeros(3, 4))
    pq_adc(torch.zeros(1, 2, 256), torch.zeros(4, 2, dtype=torch.uint8))
    seg_topk(torch.zeros(2, 8), torch.full((2,), 8, dtype=torch.int32), 3)
    l2_top1(torch.zeros(2, 4), torch.zeros(3, 4))
    wt_rank(torch.zeros(32, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int32))
    rans_decode(torch.full((2,), 1 << 16, dtype=torch.int32),
                torch.zeros(0, dtype=torch.int32),
                *(torch.from_numpy(t) for t in make_tables(np.array([4, 4]),
                                                           3)), 2, 3)
    assert launch_counts() == {"l2_dist": 0, "l2_top1": 0, "pq_adc": 0,
                               "seg_topk": 0, "wt_rank": 0, "rans_decode": 0}


def test_shape_mismatch_raises():
    with pytest.raises(ValueError):
        l2_dist(torch.zeros(2, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        pq_adc(torch.zeros(1, 4, 256), torch.zeros(3, 5, dtype=torch.uint8))
    with pytest.raises(ValueError):
        seg_topk(torch.zeros(2, 4), torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        l2_top1(torch.zeros(2, 4), torch.zeros(3, 5))
    with pytest.raises(ValueError):
        wt_rank(torch.zeros(2, 4, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32),
                torch.zeros(3, dtype=torch.int32))
    tabs = [torch.zeros(16, dtype=torch.int32)] * 3
    with pytest.raises(ValueError, match="tables"):
        rans_decode(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.int32), *tabs, 2, 5)
    with pytest.raises(ValueError, match="precision"):
        rans_decode(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(4, dtype=torch.int32), *tabs, 2, 17)
    with pytest.raises(ValueError, match="sum"):
        make_tables(np.array([3, 4]), 3)
