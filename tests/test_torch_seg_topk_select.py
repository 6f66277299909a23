"""The radix select of ``csrc/seg_topk.cu``, modelled in numpy on the CPU.

The CUDA kernel cannot run here, so its algorithm is written out step by
step in numpy (``model_seg_topk``) and held, with ``np.array_equal`` on the
values' bits and on the columns, against the port's plain version
``repro_torch.kernels.seg_topk_ref`` and the JAX package's
``repro.kernels.seg_topk.seg_topk_ref``.  The model follows the kernel:

* the key map: the ordered u32 of the value, -0.0 taken as +0.0, every NaN
  one key (0xffffffff) above +inf (0xff800000);
* four 8-bit digit passes over the keys that match the digits chosen so
  far, the padding columns' count added to the +inf key's bin, stopping
  once the matching keys are all taken or, with the keys below them, fit
  the sort (the next power of two >= k, at least 32);
* the collect: keys below the cut, then all matching keys where they fit
  the sort, else the first ``need`` of them in column order; the padding
  columns follow the real ones by arithmetic;
* the final order: the selected ``(key << 32 | column)`` sorted ascending,
  the first k kept, the row's own value written back.

A model of the first kernel's key map (``make_key``, NaN ordered by its
bits) fails on the NaN row, which keeps that fault shown.

    PYTHONPATH=src python -m pytest -q tests/test_torch_seg_topk_select.py
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.kernels.seg_topk import seg_topk_ref as jax_seg_topk_ref

from repro_torch.kernels import seg_topk, seg_topk_ref

INF_KEY = 0xFF800000
NAN_KEY = 0xFFFFFFFF
NEG_NAN = np.uint32(0xFFC00000).view(np.float32)       # sign bit set
NAN_2 = np.uint32(0x7FA00001).view(np.float32)         # another payload


def keys_of(v):
    """The kernel's key map (``key_of``)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    nan = (u & 0x7FFFFFFF) > 0x7F800000
    u = np.where((u & 0x7FFFFFFF) == 0, 0, u)
    k = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(nan, NAN_KEY, k).astype(np.uint64)


def old_keys_of(v):
    """The first kernel's ``make_key``: a NaN is ordered by its bits."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where((u & 0x7FFFFFFF) == 0, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF,
                    u | 0x80000000).astype(np.uint64)


def model_row(row, ln, k, key_map=keys_of):
    """One row through the kernel's steps: (vals f32 (k,), cols i32 (k,),
    v* prefix, its mask)."""
    n = row.shape[0]
    live = max(0, min(int(ln), n))
    ncols = max(n, k)
    pad = ncols - live                   # implicit +inf columns live..
    keys = key_map(row[:live])
    kcap = max(32, 1 << max(1, (k - 1).bit_length()))   # the sort's size
    prefix, mask, need, count = 0, 0, k, ncols
    for shift in (24, 16, 8, 0):
        if count == need or k - need + count <= kcap:
            break                        # the matches are all taken
        hit = (keys & mask) == prefix
        hist = np.bincount(((keys[hit] >> shift) & 255).astype(np.int64),
                           minlength=256)
        if pad and (INF_KEY & mask) == prefix:
            hist[(INF_KEY >> shift) & 255] += pad
        inc = np.cumsum(hist)
        exc = inc - hist
        b = int(np.flatnonzero((exc < need) & (need <= inc))[0])
        prefix |= b << shift
        mask |= 255 << shift
        need, count = int(need - exc[b]), int(hist[b])
    # the matches all fit the sort, or only the first `need` by column
    ordered = count > need and k - need + count > kcap
    take = need if ordered else count
    cols = np.arange(live)
    km = keys & mask
    lt = [(keys[km < prefix], cols[km < prefix])]
    eq_cols = cols[km == prefix][:take]
    eq = [(keys[eq_cols], eq_cols)]
    pad_cols = np.arange(live, ncols)
    pad_keys = np.full(pad, INF_KEY, np.uint64)
    if (INF_KEY & mask) < prefix:
        lt.append((pad_keys, pad_cols))
    elif (INF_KEY & mask) == prefix:
        more = take - len(eq_cols)
        eq.append((pad_keys[:more], pad_cols[:more]))
    sel_k = np.concatenate([a for a, _ in lt + eq])
    sel_c = np.concatenate([c for _, c in lt + eq]).astype(np.uint64)
    assert sum(len(c) for _, c in lt) == k - need
    assert sum(len(c) for _, c in eq) == take
    assert len(sel_k) <= max(k, kcap)
    order = np.sort((sel_k << np.uint64(32)) | sel_c)[:k]
    out_c = (order & np.uint64(0xFFFFFFFF)).astype(np.int64)
    out_v = np.full(k, np.inf, np.float32)
    real = out_c < live
    out_v[real] = row[out_c[real]]          # the row's own bits
    return out_v, out_c.astype(np.int32), prefix, mask


def model_seg_topk(d, lens, k, key_map=keys_of):
    out = [model_row(d[i], lens[i], k, key_map) for i in range(d.shape[0])]
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]))


def _bits(v):
    return np.ascontiguousarray(v, np.float32).view(np.int32)


def _check(d, lens, k):
    """model == port seg_topk_ref == the port's CPU wrapper == JAX
    seg_topk_ref, values as int32 bits and columns."""
    d = np.ascontiguousarray(d, np.float32)
    lens = np.asarray(lens, np.int32)
    mv, mc = model_seg_topk(d, lens, k)
    n = d.shape[1]
    pv, pc = seg_topk_ref(torch.from_numpy(d),
                          torch.from_numpy(np.minimum(lens, n)), k)
    wv, wc = seg_topk(torch.from_numpy(d), torch.from_numpy(lens), k)
    jv, jc = jax_seg_topk_ref(jnp.asarray(d),
                              jnp.minimum(jnp.asarray(lens), n), k)
    for v, c in ((pv.numpy(), pc.numpy()), (wv.numpy(), wc.numpy()),
                 (np.asarray(jv), np.asarray(jc))):
        np.testing.assert_array_equal(_bits(mv), _bits(v))
        np.testing.assert_array_equal(mc, c)
    return mv, mc


def _edge_rows(n, rng):
    """(rows, lens): random, all tied, all +inf, signed zeros, duplicates,
    NaN of both signs and two payloads, lens = 0, lens < 8, lens > n."""
    d = rng.standard_normal((10, n)).astype(np.float32)
    lens = rng.integers(n // 2, n + 1, size=10)
    d[1] = 1.0
    d[2] = np.inf
    d[3, ::2] = -0.0
    d[3, 1::2] = 0.0
    d[4] = np.floor(d[4] * 2)
    d[5, 1::7] = np.nan
    d[5, 2::7] = NEG_NAN
    d[5, 3::11] = NAN_2
    d[5, 4::13] = np.inf
    lens[5] = n
    lens[6] = 0
    lens[7] = 5
    lens[8] = n + 100
    d[9, n // 3:] = np.inf
    return d, lens


@pytest.mark.parametrize("n,k", [(64, 1), (64, 10), (200, 16), (200, 64),
                                 (1000, 32), (1000, 257), (777, 777),
                                 (64, 64), (40, 100), (5, 9)])
def test_model_matches_plain_versions(n, k):
    d, lens = _edge_rows(n, np.random.default_rng(n * 1000 + k))
    _check(d, lens, k)


def test_nan_row_of_both_signs():
    row = np.array([3, NEG_NAN, 1, np.inf, np.nan, 2, -1, 0.5], np.float32)
    v, c = _check(row[None], [8], 8)
    np.testing.assert_array_equal(c[0], [6, 7, 2, 5, 0, 3, 1, 4])
    assert _bits(v)[0, 6] == _bits(row)[1] and _bits(v)[0, 7] == _bits(row)[4]


def test_nan_ties_with_padding_by_column():
    """Padding columns (at or past lens) are +inf and come before every
    NaN; NaNs of any sign and payload tie by column after them."""
    row = np.array([NAN_2, 0.0, NEG_NAN, np.inf, np.nan, 7.0], np.float32)
    v, c = _check(row[None], [4], 6)
    np.testing.assert_array_equal(c[0], [1, 3, 4, 5, 0, 2])
    v, c = _check(row[None], [6], 9)          # k > n: widened
    np.testing.assert_array_equal(c[0], [1, 5, 3, 6, 7, 8, 0, 2, 4])


def test_old_key_map_fails_on_the_nan_row():
    row = np.array([[3, NEG_NAN, 1, np.inf, np.nan, 2, -1, 0.5]], np.float32)
    _, old = model_seg_topk(row, np.array([8]), 8, key_map=old_keys_of)
    np.testing.assert_array_equal(old[0], [1, 6, 7, 2, 5, 0, 3, 4])
    _, want = seg_topk_ref(torch.from_numpy(row), torch.tensor([8]), 8)
    assert not np.array_equal(old, want.numpy())


@pytest.mark.parametrize("kind", ["random", "tied", "inf", "nan", "dups"])
@pytest.mark.parametrize("k", [1, 32, 300, 1024])
def test_v_star_is_the_kth_key(kind, k):
    """The digit passes end on the k-th smallest key of the padded row, or
    on its top digits where they stop early: every match is taken, or the
    matches and the keys below them fit the sort."""
    rng = np.random.default_rng(k)
    n = 1024
    row = {"random": rng.standard_normal(n),
           "tied": np.full(n, 2.5), "inf": np.full(n, np.inf),
           "nan": np.where(rng.random(n) < 0.5, np.nan, rng.standard_normal(n)),
           "dups": np.floor(rng.standard_normal(n) * 3)}[kind]
    row = row.astype(np.float32)
    ln = n - 100
    _, _, prefix, mask = model_row(row, ln, k)
    padded = np.concatenate([keys_of(row[:ln]),
                             np.full(n - ln, INF_KEY, np.uint64)])
    kth = int(np.sort(padded)[k - 1])
    assert kth & mask == prefix
    matches = int(np.sum((padded & mask) == prefix))
    below = int(np.sum((padded & mask) < prefix))
    kcap = max(32, 1 << max(1, (k - 1).bit_length()))
    assert below < k <= below + matches
    assert mask == 0xFFFFFFFF or below + matches <= max(k, kcap)


def test_key_map_order():
    vals = np.array([-np.inf, -1.0, -0.0, 0.0, 1e-45, 1.0, np.inf, np.nan,
                     NEG_NAN, NAN_2], np.float32)
    keys = keys_of(vals)
    assert keys[2] == keys[3] == 0x80000000
    assert np.all(np.diff(keys[[0, 1, 3, 4, 5, 6]].astype(np.int64)) > 0)
    assert keys[6] == INF_KEY and set(keys[7:].tolist()) == {NAN_KEY}
