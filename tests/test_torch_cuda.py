"""The port's CUDA kernels and a CUDA index on the card (skipped without one).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain torch version on the same CUDA
tensors at the edge shapes the CPU tests use for the plain versions
(ragged tiles, ``k > n``, ``lens = 0``, ties, ``+inf``, signed zeros,
every ``m`` of the grammar's common PQ shapes, ragged ``K`` and ``d`` and
tied centroids for ``l2_top1``, integer-valued near duplicates, depths
under one k8 step and an input that one pass of TF32 rounds the same way
everywhere for the split-TF32 L2 kernels, rank at 0 and at n, rANS
tables in global memory and 1 to 1024 lanes; ``rans_decode`` at the
chip_smoke shapes, r = 14 and 15, heads below 2^16 and words views at odd
storage offsets, ``wt_rank`` on both routes, unpadded and at a 4-byte
offset, both against the plain version on a CPU copy); ``seg_topk`` at the main
path's widths (16384 to 300000) and ``k`` up to ``n``, with NaN rows, held
against the plain version on the CPU; ``pq_adc`` bitwise equal to the
j-ordered f32 sum for m = 1 .. 227; ``l2_top1`` and ``seg_topk`` run twice
must give bitwise-equal results; ``pq_adc`` past one block's tables (m =
228, 256, 512, in j-ordered chunks) bit-equal to the plain version on a
CPU copy, and ``IVF16,PQ256x8`` through the scan; a CUDA index is held
bit-exact against its own ``search_ref`` and against a CPU index carried
from the same arrays, also after ingest; a CUDA Flat index at n = 300000
(retry past k = 4096) against the numpy loop; a container round trip
onto the card.  k-means on the card must give bitwise-equal centroids
from run to run.  Graphs: the occlusion prune, HNSW's reverse edges and
``np_sum_f32`` on the card equal the CPU's, ``l2_dist`` at the beam
steps' tiles stays inside ``rescore_eps``, and a CUDA ``NSG12,ids=roc``
index equals its ``search_ref``, also after ``add`` and a save/load round
trip.  Whether a card is present is decided inside the
fixture, so every worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from repro_torch.ann.ivf import IVFIndex
from repro_torch.ann.scan import rescore_eps
from repro_torch.kernels import (l2_dist, l2_dist_ref, l2_top1, l2_top1_ref,
                                 launch_counts, make_tables, pack_bits_u32,
                                 pq_adc, pq_adc_ref, rans_decode,
                                 rans_decode_ref, reset_launches, seg_topk,
                                 seg_topk_ref, wt_rank, wt_rank_ref)

pytestmark = pytest.mark.cuda

_eps = np.vectorize(rescore_eps)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _in_band(got, want, d, qn):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    assert np.all(np.abs(got - want) <= _eps(d, want, qn))


def _l2_inputs(kind, nq, n, d, dev, g):
    """(q, a) of one kind: ``randn``; ``sift-int``, integer-valued rows in
    [0, 128) as in SIFT with near duplicates of the queries (one coordinate
    off by one); ``aligned``, every coordinate 1 + 2^-11 - 2^-23, which one
    pass of TF32 rounds the same way everywhere."""
    if kind == "aligned":
        v = 1.0 + 2.0 ** -11 - 2.0 ** -23
        return (torch.full((nq, d), v, device=dev),
                torch.full((n, d), v, device=dev))
    if kind == "randn":
        return (torch.randn(nq, d, device=dev, generator=g),
                torch.randn(n, d, device=dev, generator=g))
    q = torch.randint(0, 128, (nq, d), device=dev, generator=g).float()
    a = torch.randint(0, 128, (n, d), device=dev, generator=g).float()
    near = torch.arange(0, n, 7, device=dev)
    a[near] = q[near % nq]
    a[near, near % d] += 1.0
    return q, a


@pytest.mark.parametrize("nq,n,d,kind", [
    (1, 1, 8, "randn"), (3, 7, 32, "randn"), (17, 513, 32, "randn"),
    (64, 1000, 128, "randn"), (9, 300, 33, "randn"), (65, 129, 96, "randn"),
    (200, 4099, 128, "randn"), (64, 4096, 128, "sift-int"),
    (64, 2000, 128, "aligned"), (5, 300, 4, "randn"), (17, 513, 8, "randn"),
    (33, 1000, 20, "randn")])
def test_l2_dist_kernel(dev, nq, n, d, kind):
    g = torch.Generator(device=dev).manual_seed(nq + n)
    q, a = _l2_inputs(kind, nq, n, d, dev, g)
    a[n // 2] = q[0]
    reset_launches()
    out = l2_dist(q, a)
    assert launch_counts()["l2_dist"] == 1
    qn = (q.double() ** 2).sum(1, keepdim=True).cpu().numpy()
    _in_band(out, l2_dist_ref(q, a), d, qn)


@pytest.mark.parametrize("qb", [1, 3, 8, 13, 64])
@pytest.mark.parametrize("m,n", [(4, 5000), (8, 4097), (16, 1), (32, 3000),
                                 (3, 777), (64, 100)])
def test_pq_adc_kernel(dev, qb, m, n):
    g = torch.Generator(device=dev).manual_seed(qb * 100 + m)
    luts = torch.rand(qb, m, 256, device=dev, generator=g) * 10
    codes = torch.randint(0, 256, (n, m), device=dev, generator=g,
                          dtype=torch.int32).to(torch.uint8)
    out = pq_adc(luts, codes)
    _in_band(out, pq_adc_ref(luts, codes), 8 * m, 0.0)
    assert _bits_equal(out, _j_ordered_sum(luts, codes))
    # an unaligned code view takes the byte path
    if n > 1:
        buf = torch.zeros(n * m + 1, dtype=torch.uint8, device=dev)
        view = buf[1:].view(n, m)
        view.copy_(codes)
        _in_band(pq_adc(luts, view), pq_adc_ref(luts, codes), 8 * m, 0.0)


def _bits_equal(a, b):
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


@pytest.mark.parametrize("nq,n,k", [(8, 64, 10), (3, 200, 16), (16, 130, 1),
                                    (1, 7, 4), (5, 33, 33), (2, 3, 6),
                                    (9, 1000, 64), (4, 300, 300),
                                    (70, 16384, 16)])
def test_seg_topk_kernel(dev, nq, n, k):
    g = torch.Generator(device=dev).manual_seed(nq + n + k)
    d = torch.randn(nq, n, device=dev, generator=g)
    d[0, ::3] = 0.5                          # ties
    if nq > 1:
        d[1, ::2] = -0.0                     # signed zeros tie by column
        d[1, 1::2] = 0.0
    if nq > 2:
        d[2, n // 2:] = float("inf")         # genuine +inf
    lens = torch.randint(0, n + 1, (nq,), device=dev, generator=g,
                         dtype=torch.int32)
    lens[0] = n + 7                          # past n: clamped
    if nq > 3:
        lens[3] = 0
    v, i = seg_topk(d, lens, k)
    vr, ir = seg_topk_ref(d, lens.clamp(max=n), k)
    assert _bits_equal(v, vr) and torch.equal(i, ir)


def _seg_rows(nq, n, dev, g):
    """Random rows with the edge rows of ``chip_smoke.py``: all tied, all
    +inf, signed zeros, duplicates, lens 5, 0 and past n, a few hits then
    +inf, and NaN of both signs and two payloads."""
    d = torch.randn(nq, n, device=dev, generator=g)
    lens = torch.randint(n // 2, n + 1, (nq,), device=dev, generator=g,
                         dtype=torch.int32)
    d[1] = 1.0
    d[2] = float("inf")
    d[3, ::2] = -0.0
    d[3, 1::2] = 0.0
    d[4, : n // 2] = torch.floor(d[4, : n // 2] * 4)
    lens[5], lens[6], lens[7] = 5, 0, n + 100
    d[8, 100:] = float("inf")
    bits = d[9].view(torch.int32)
    bits[1::7] = 0x7FC00000
    bits[2::7] = 0xFFC00000 - (1 << 32)
    bits[3::11] = 0x7FA00001
    lens[9] = n
    return d.contiguous(), lens.contiguous()


@pytest.mark.parametrize("n,k", [(16384, 32), (16384, 2048), (16384, 16384),
                                 (32768, 32), (32768, 2048), (32768, 32768),
                                 (65536, 32), (65536, 5000), (300000, 32),
                                 (300000, 2048), (300, 7)])
def test_seg_topk_kernel_at_main_path_widths_with_nan(dev, n, k):
    """Bit-equal to the plain version run on the CPU: the card's stable
    sort is not the yardstick for NaN rows (it orders them otherwise).
    n = 300000 is wider than 8 blocks of staged keys: the kernel reads
    the keys from global memory on each pass."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    d, lens = _seg_rows(64 if n > 300 else 12, n, dev, g)
    v, i = seg_topk(d, lens, k)
    vr, ir = seg_topk_ref(d.cpu(), lens.cpu().clamp(max=n), k)
    assert _bits_equal(v.cpu(), vr) and torch.equal(i.cpu(), ir)


def test_seg_topk_kernel_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    d, lens = _seg_rows(64, 32768, dev, g)
    for k in (64, 8192):
        v, i = seg_topk(d, lens, k)
        v2, i2 = seg_topk(d, lens, k)
        assert _bits_equal(v, v2) and torch.equal(i, i2)


def _j_ordered_sum(luts, codes):
    """The sum the kernel computes: f32 adds in the order j = 0 .. m - 1."""
    out = torch.zeros(luts.shape[0], codes.shape[0], device=luts.device)
    for j in range(luts.shape[1]):
        out += luts[:, j, codes[:, j].long()]
    return out


@pytest.mark.parametrize("m", [1, 3, 4, 8, 16, 32, 64, 192, 227])
@pytest.mark.parametrize("qb,n", [(5, 4099), (17, 33_001), (64, 300_003)])
def test_pq_adc_kernel_is_the_j_ordered_sum(dev, m, qb, n):
    """Bitwise the j-ordered f32 sum: qb not a multiple of the tables a
    block holds, n not a multiple of a span, and an unaligned code view;
    m = 192 has a shortened code ring, m = 227 (odd, one table filling a
    block) none, its codes read from global memory."""
    g = torch.Generator(device=dev).manual_seed(qb * 100 + m)
    luts = torch.rand(qb, m, 256, device=dev, generator=g) * 10
    codes = torch.randint(0, 256, (n, m), device=dev, generator=g,
                          dtype=torch.int32).to(torch.uint8)
    want = _j_ordered_sum(luts, codes)
    assert _bits_equal(pq_adc(luts, codes), want)
    buf = torch.zeros(n * m + 1, dtype=torch.uint8, device=dev)
    view = buf[1:].view(n, m)
    view.copy_(codes)
    assert _bits_equal(pq_adc(luts, view), want)


@pytest.mark.parametrize("m", [228, 256, 512])
@pytest.mark.parametrize("qb,n", [(5, 4099), (64, 33_001)])
def test_pq_adc_kernel_in_chunks_past_one_block(dev, m, qb, n):
    """m >= 228 runs as j-ordered chunks of tables, each launch adding
    onto the sums of the one before: bit-equal to the plain version run
    on a CPU copy (the j-ordered f32 sum), also for an unaligned view."""
    from repro_torch.kernels.pq_adc.ops import chunk_plan

    g = torch.Generator(device=dev).manual_seed(qb * 1000 + m)
    luts = torch.rand(qb, m, 256, device=dev, generator=g) * 10
    codes = torch.randint(0, 256, (n, m), device=dev, generator=g,
                          dtype=torch.int32).to(torch.uint8)
    want = pq_adc_ref(luts.cpu(), codes.cpu())
    reset_launches()
    assert _bits_equal(pq_adc(luts, codes).cpu(), want)
    assert launch_counts()["pq_adc"] == len(chunk_plan(m)) > 1
    buf = torch.zeros(n * m + 1, dtype=torch.uint8, device=dev)
    view = buf[1:].view(n, m)
    view.copy_(codes)
    assert _bits_equal(pq_adc(luts, view).cpu(), want)


def test_cuda_ivf_pq256_search_equals_search_ref(dev):
    """IVF16,PQ256x8 at d = 256: its tables do not fit one block, and the
    scan scores them in chunks; ids and dists equal ``search_ref``."""
    from repro_torch.api import index_factory

    rng = np.random.default_rng(5)
    base = rng.standard_normal((3000, 256)).astype(np.float32)
    base[9] = base[4]
    queries = rng.standard_normal((40, 256)).astype(np.float32)
    queries[0] = base[4]
    idx = index_factory("IVF16,PQ256x8,ids=roc", device=dev).build(base,
                                                                   seed=1)
    from repro_torch.kernels.pq_adc.ops import chunk_plan

    reset_launches()
    d, ids, st = idx.search(queries, k=10, nprobe=4)
    assert st.engine == "pallas"
    assert launch_counts()["pq_adc"] == len(chunk_plan(256)) * st.batches
    want_ids, want_d, _ = idx.ivf.search_ref(queries, nprobe=4, topk=10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(d, want_d)


@pytest.mark.parametrize("nq,k,d,kind", [
    (1, 1, 16, "randn"), (1, 1024, 128, "randn"), (63, 1, 130, "randn"),
    (65, 129, 130, "randn"), (200, 256, 16, "randn"),
    (300, 1000, 128, "randn"), (4097, 77, 33, "randn"),
    (20000, 4096, 128, "randn"), (1 << 16, 256, 16, "randn"),
    (300, 1000, 128, "aligned")])
def test_l2_top1_kernel(dev, nq, k, d, kind):
    g = torch.Generator(device=dev).manual_seed(nq + k + d)
    q, c = _l2_inputs(kind, nq, k, d, dev, g)
    if k > 8:
        c[5] = c[2]                          # tied centroids: lowest index
        c[k - 1] = c[2]
        q[0] = c[2]
    reset_launches()
    idx, val = l2_top1(q, c)
    assert launch_counts()["l2_top1"] == 1
    ridx, rval = l2_top1_ref(q, c)
    full = l2_dist_ref(q, c)
    qn = (q.double() ** 2).sum(1).cpu().numpy()
    at = full.gather(1, idx.long()[:, None])[:, 0]
    _in_band(at, rval, d, qn)                # a nearest centroid, in band
    _in_band(val, rval, d, qn)
    if kind == "aligned":                    # every centroid ties: index 0
        assert not bool(idx.any())
    elif k > 8:
        assert int(idx[0]) == 2


def test_l2_top1_kernel_is_deterministic(dev):
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn(1 << 16, 128, device=dev, generator=g)
    c = torch.randn(1024, 128, device=dev, generator=g)
    idx, val = l2_top1(q, c)
    idx2, val2 = l2_top1(q, c)
    assert torch.equal(idx, idx2) and _bits_equal(val, val2)


@pytest.mark.parametrize("nq", [0, 1, 255])
def test_l2_top1_kernel_empty_and_dtypes(dev, nq):
    q = torch.randn(nq, 24, device=dev, dtype=torch.float64)
    c = torch.randn(77, 24, device=dev, dtype=torch.bfloat16)
    idx, val = l2_top1(q, c)
    assert idx.shape == val.shape == (nq,) and idx.dtype == torch.int32
    i0, v0 = l2_top1(q, c[:0])
    assert torch.equal(i0, torch.zeros_like(i0)) and bool(v0.isinf().all())


@pytest.mark.parametrize("n", [1, 64, 1000, 100_000])
@pytest.mark.parametrize("p", [0.05, 0.5, 0.95])
def test_wt_rank_kernel(dev, n, p):
    rng = np.random.default_rng(n)
    bits = (rng.random(n) < p).astype(np.uint8)
    words, sup = pack_bits_u32(bits)
    q = np.concatenate([[0, n, n // 2, 32 * len(words), -1,
                         32 * len(words) + 1],
                        rng.integers(0, n + 1, 5000)]).astype(np.int32)
    args = (torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(sup).to(dev), torch.from_numpy(q).to(dev))
    got = wt_rank(*args)
    assert torch.equal(got, wt_rank_ref(*args))
    want = np.concatenate([[0], np.cumsum(bits)])
    np.testing.assert_array_equal(got.cpu().numpy()[:4],
                                  [0, want[n], want[n // 2], want[n]])
    np.testing.assert_array_equal(got.cpu().numpy()[4:6], [-1, -1])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("nbits", [1 << 24, 1_050_000, 100_003, 33])
def test_wt_rank_kernel_both_routes(dev, nbits, offset):
    """A bitvector larger than shared memory (the global route) and ones
    that fit (resident, at 2^20 queries), unpadded (W = ceil(n / 32),
    queries in its last superblock) and padded, and a words view at a
    4-byte offset; bit-equal to the plain version on a CPU copy."""
    rng = np.random.default_rng(nbits + offset)
    bits = (rng.random(nbits) < 0.3).astype(np.uint8)
    padded, sup = pack_bits_u32(bits)
    for words in (padded, padded[:-(-nbits // 32)]):
        W = len(words)
        q = np.concatenate([[0, nbits, 32 * W, 32 * W - 1, -1, 32 * W + 1],
                            np.arange(32 * W - 600, 32 * W + 1),
                            np.arange(0, 32 * W + 1, 512)[:4096],
                            rng.integers(0, 32 * W + 1, 1 << 20)]
                           ).astype(np.int32)
        args = (_offset_view(words.view(np.int32), dev, offset),
                torch.from_numpy(sup).to(dev), torch.from_numpy(q).to(dev))
        reset_launches()
        got = wt_rank(*args)
        route = "global" if nbits == 1 << 24 else "resident"
        assert wt_rank.routes == {route: 1}
        assert torch.equal(got.cpu(), _on_cpu_copy(wt_rank_ref, args))


def _geom_freqs(alpha, r):
    f = np.maximum(1, (1 << r) >> (np.arange(alpha) + 1)).astype(np.int64)
    f[0] += (1 << r) - f.sum()
    return f


@pytest.mark.parametrize("lanes", [1, 33, 128, 1024])
@pytest.mark.parametrize("r,alpha,rows", [(8, 16, 7), (12, 24, 64),
                                          (14, 40, 33), (16, 64, 50)])
def test_rans_decode_kernel(dev, r, alpha, rows, lanes):
    from repro_torch.core.vrans import VRans16Encoder

    rng = np.random.default_rng(r * lanes)
    freqs = _geom_freqs(alpha, r)
    starts = np.cumsum(freqs) - freqs
    data = rng.choice(alpha, size=(rows, lanes), p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    args = [torch.from_numpy(heads.view(np.int32)).to(dev),
            torch.from_numpy(words.astype(np.int32)).to(dev)]
    args += [torch.from_numpy(t).to(dev) for t in make_tables(freqs, r)]
    reset_launches()
    out = rans_decode(*args, rows=rows, r=r)
    assert launch_counts()["rans_decode"] == 1
    np.testing.assert_array_equal(out.cpu().numpy(), data)
    assert torch.equal(out, rans_decode_ref(*args, rows=rows, r=r))
    # past the stream's end the kernel reads 0, as the plain version does
    more = rans_decode(*args, rows=rows + 5, r=r)
    assert torch.equal(more, rans_decode_ref(*args, rows=rows + 5, r=r))


def _on_cpu_copy(fn, args, **kw):
    """``fn`` run on CPU copies of ``args`` (the plain version)."""
    return fn(*(a.cpu() for a in args), **kw)


def _offset_view(x, dev, offset):
    """``x`` on the card as a contiguous view at ``offset`` elements into a
    larger tensor (a storage offset: 4 * offset bytes off 16-byte
    alignment for offsets 1 .. 3)."""
    big = torch.zeros(x.size + offset, dtype=torch.int32, device=dev)
    big[offset:] = torch.from_numpy(x).to(dev)
    view = big[offset:]
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


@pytest.mark.parametrize("lanes,rows", [(128, 8192), (16, 64), (1024, 1024)])
def test_rans_decode_kernel_at_chip_smoke_shapes(dev, lanes, rows):
    """gap_ans's quotient model (r = 12, packed table in shared memory) at
    the shapes chip_smoke.py times, and rows past the stream's end."""
    from repro_torch.core import gap_ans
    from repro_torch.core.vrans import VRans16Encoder

    r, freqs = gap_ans._Q_PRECISION, gap_ans._QF
    starts = np.cumsum(freqs) - freqs
    rng = np.random.default_rng(lanes)
    data = rng.choice(len(freqs), size=(rows, lanes), p=freqs / freqs.sum())
    enc = VRans16Encoder(lanes)
    for t in range(rows - 1, -1, -1):
        enc.push(starts[data[t]], freqs[data[t]], r)
    heads, words = enc.finalize()
    args = [torch.from_numpy(heads.view(np.int32)).to(dev),
            torch.from_numpy(words.astype(np.int32)).to(dev)]
    args += [torch.from_numpy(t).to(dev) for t in make_tables(freqs, r)]
    out = rans_decode(*args, rows=rows, r=r)
    np.testing.assert_array_equal(out.cpu().numpy(), data)
    assert torch.equal(out.cpu(), _on_cpu_copy(rans_decode_ref, args,
                                               rows=rows, r=r))
    more = rans_decode(*args, rows=rows + 40, r=r)
    assert torch.equal(more.cpu(), _on_cpu_copy(rans_decode_ref, args,
                                                rows=rows + 40, r=r))


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("lanes", [16, 128, 300])
@pytest.mark.parametrize("r", [14, 15])
def test_rans_decode_kernel_edges(dev, r, lanes, offset):
    """Either side of the shared-memory table (r = 14 packed, r = 15 from
    the three tables), heads below 2^16, words with high bits, a words view
    at an odd storage offset, and rows past the stream's end."""
    rng = np.random.default_rng(r * 1000 + lanes + offset)
    freqs = _geom_freqs(40, r)
    heads = rng.integers(1 << 16, 1 << 32, lanes, dtype=np.uint64
                         ).astype(np.uint32)
    heads[::5] = rng.integers(0, 1 << 16, len(heads[::5]))
    words = rng.integers(0, 1 << 16, 20_000 + offset).astype(np.int32)
    words[::97] = rng.integers(-(1 << 31), 1 << 31, len(words[::97]))
    args = [torch.from_numpy(heads.view(np.int32)).to(dev),
            _offset_view(words, dev, offset)]
    args += [torch.from_numpy(t).to(dev) for t in make_tables(freqs, r)]
    rows = 20_000 // lanes * 4 // 3   # runs some rows past the end
    out = rans_decode(*args, rows=rows, r=r)
    assert torch.equal(out.cpu(), _on_cpu_copy(rans_decode_ref, args,
                                               rows=rows, r=r))


def test_kmeans_on_the_card_is_deterministic(dev):
    from repro_torch.ann.kmeans import kmeans

    rng = np.random.default_rng(0)
    x = rng.standard_normal((50_000, 32)).astype(np.float32)
    reset_launches()
    a = kmeans(x, 256, iters=5, seed=1, device=dev)
    assert launch_counts()["l2_top1"] == 5
    b = kmeans(x, 256, iters=5, seed=1, device=dev)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("payload", ["flat", "pq8"])
def test_cuda_build_and_ingest_through_the_service(dev, payload):
    from repro_torch.api import index_factory
    from repro_torch.serve import AnnService

    rng = np.random.default_rng(1)
    base = rng.standard_normal((4000, 32)).astype(np.float32)
    extra = rng.standard_normal((300, 32)).astype(np.float32)
    queries = np.concatenate([rng.standard_normal((20, 32)), extra[:5]]
                             ).astype(np.float32)
    spec = ("IVF16,ids=roc" if payload == "flat"
            else "IVF16,PQ8x8,ids=roc,codes=polya")
    reset_launches()
    idx = index_factory(spec, device=dev).build(base, seed=1)
    built = launch_counts()["l2_top1"]
    assert built > 0
    svc = AnnService(idx, topk=10, device=dev, nprobe=4)
    for i in range(0, 300, 100):
        svc.add(extra[i:i + 100])
    assert launch_counts()["l2_top1"] > built
    assert idx.ivf.n_epochs == 4 and idx.ivf.n == 4300
    ids, dists = svc.search(queries)
    want_ids, want_d, _ = idx.ivf.search_ref(queries, nprobe=4, topk=10)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_d)
    if payload == "flat":                    # the added rows are found
        np.testing.assert_array_equal(ids[20:, 0], 4000 + np.arange(5))


@pytest.mark.parametrize("payload", ["flat", "pq8"])
@pytest.mark.parametrize("ids", ["roc", "wt"])
def test_cuda_index_matches_cpu_index_and_search_ref(dev, ids, payload):
    rng = np.random.default_rng(0)
    base = rng.standard_normal((3000, 32)).astype(np.float32)
    base[11] = base[5]
    queries = rng.standard_normal((70, 32)).astype(np.float32)
    queries[0] = base[5]
    pq_m = 8 if payload == "pq8" else 0
    spec = dict(id_codec=ids, pq_m=pq_m,
                code_codec="polya" if pq_m else None)
    from repro_torch.ann.pq import ProductQuantizer

    pq = ProductQuantizer(m=8, bits=8) if pq_m else None
    cpu = IVFIndex(nlist=24, id_codec=ids, pq=pq, device="cpu").build(
        base, seed=1)
    arrays = dict(centroids=cpu.centroids, offsets=cpu.offsets,
                  sizes=cpu.sizes, lists=cpu._lists, n=cpu.n, d=cpu.d)
    if pq_m:
        arrays.update(codes=cpu.codes, codebooks=cpu.pq.codebooks)
    else:
        arrays.update(vecs=cpu.vecs)
    gpu = IVFIndex.from_arrays(arrays, device=dev, **spec)
    assert gpu.payload_dev.is_cuda
    want = cpu.search_ref(queries, nprobe=6, topk=10)
    for select in ("host", "device"):
        for qb in (1, 7, 64):
            reset_launches()
            got = gpu.search(queries, nprobe=6, topk=10, select=select,
                             query_block=qb, with_keys=True)
            cpu_got = cpu.search(queries, nprobe=6, topk=10, select=select,
                                 query_block=qb, with_keys=True)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[2].merge_keys,
                                          cpu_got[2].merge_keys)
            counts = launch_counts()
            assert counts["pq_adc" if pq_m else "l2_dist"] == got[2].batches
            assert (counts["seg_topk"] > 0) == (select == "device")
            assert got[2].engine == "pallas"
    with pytest.raises(ValueError, match="xla"):
        gpu.search(queries, engine="xla")


def test_cuda_flat_search_equals_the_numpy_loop(dev):
    """Flat at n = 300000 (n_pad = 2^19, unstaged seg_topk rows), with 6000
    copies of one row next to a query: the K-doubling retry runs past
    4096 (the kernel's global-memory sort).  Ids and dists equal the
    numpy loop of a CPU index."""
    from repro_torch.api import index_factory
    from repro_torch.kernels import launch_shapes

    rng = np.random.default_rng(3)
    base = rng.standard_normal((300_000, 32)).astype(np.float32)
    base[1000:7000] = base[10]
    queries = rng.standard_normal((20, 32)).astype(np.float32)
    queries[1] = base[10] + 0.01
    queries[2] = base[77]
    gpu = index_factory("Flat", device=dev).build(base)
    cpu = index_factory("Flat", device="cpu").build(base)
    reset_launches()
    d, ids, st = gpu.search(queries, k=10, query_block=8)
    assert st.engine == "flat-pallas"
    counts, shapes = launch_counts(), launch_shapes()["seg_topk"]
    assert counts["l2_dist"] == st.batches == 3
    assert max(k for _, k in shapes) >= 8192
    assert {n for n, _ in shapes} == {1 << 19}
    want_d, want_ids, want_st = cpu.search(queries, k=10)
    assert want_st.engine == "flat"
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(d, want_d)
    with pytest.raises(ValueError, match="xla"):
        gpu.search(queries, engine="xla")


def test_cuda_container_round_trip(dev):
    """save_index of a CUDA IVF64,PQ8x8,ids=roc,codes=polya index after
    an add, loaded back onto the card: same blob as the CPU copy's, search
    equal to before, ids and dists."""
    from repro_torch.api import index_factory, load_index, save_index

    rng = np.random.default_rng(8)
    base = rng.standard_normal((6000, 32)).astype(np.float32)
    queries = rng.standard_normal((30, 32)).astype(np.float32)
    idx = index_factory("IVF64,PQ8x8,ids=roc,codes=polya",
                        device=dev).build(base, seed=1)
    idx.add(rng.standard_normal((500, 32)).astype(np.float32))
    d0, i0, _ = idx.search(queries, k=10, nprobe=8)
    blob = save_index(idx)
    back = load_index(blob, device=dev)
    assert back.ivf.payload_dev.is_cuda and back.ivf.n_epochs == 2
    assert back.ivf.bits_per_id() == idx.ivf.bits_per_id()
    reset_launches()
    d1, i1, st = back.search(queries, k=10, nprobe=8)
    assert st.engine == "pallas" and launch_counts()["pq_adc"] > 0
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_array_equal(d1, d0)
    cpu = load_index(blob, device="cpu")
    assert save_index(cpu) == blob
    d2, i2, _ = cpu.search(queries, k=10, nprobe=8)
    np.testing.assert_array_equal(i2, i0)
    np.testing.assert_array_equal(d2, d0)


# ---------------------------------------------------------------------------
# graph indexes on the card
# ---------------------------------------------------------------------------

def _graph_data(n=5000, d=32, nq=40, seed=4):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    base[50:53] = base[51]                   # exact ties for the prune
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    return base, queries


@pytest.mark.parametrize("r,k", [(12, 24), (32, 64), (16, 32)])
def test_graph_prune_on_the_card_equals_the_cpu(dev, r, k):
    """The occlusion prune of the same kNN lists on the card and on the
    CPU: equal kept ids, acceptance order included."""
    from repro_torch.ann.graph import knn_graph, prune_kept

    base, _ = _graph_data(n=3000, d=128)
    nn = knn_graph(torch.from_numpy(base).to(dev), k)
    nodes = np.arange(len(base))
    card = prune_kept(torch.from_numpy(base).to(dev), nn, nodes, r)
    cpu = prune_kept(torch.from_numpy(base), nn, nodes, r)
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.parametrize("m", [4, 16])
def test_hnsw_reverse_edges_on_the_card_equal_the_cpu(dev, m):
    from repro_torch.ann.graph import hnsw_reverse_edges

    rng = np.random.default_rng(m)
    n = 4000
    kept = np.full((n, m), -1, np.int64)
    for i in range(n):
        cnt = int(rng.integers(0, m + 1))
        sel = rng.permutation(np.setdiff1d(rng.integers(0, n, 3 * m), [i]))
        kept[i, :min(cnt, len(sel))] = sel[:cnt]
    for a, b in zip(hnsw_reverse_edges(kept, m, device=dev),
                    hnsw_reverse_edges(kept, m, device="cpu")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("d", [3, 7, 24, 128, 129, 960])
def test_np_sum_f32_on_the_card_bit_equal(dev, d):
    from repro_torch.ann.npsum import np_sum_f32

    rng = np.random.default_rng(d)
    a = (rng.standard_normal((2048, d)) ** 2
         * rng.uniform(0.01, 1e4, (2048, 1))).astype(np.float32)
    got = np_sum_f32(torch.from_numpy(a).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sum(a, axis=1).view(np.int32))


@pytest.mark.parametrize("nq,n", [(8, 128), (64, 1024), (16, 4096),
                                  (64, 2048)])
def test_l2_dist_at_graph_tiles(dev, nq, n):
    g = torch.Generator(device=dev)
    g.manual_seed(nq * n)
    for kind in ("randn", "sift-int"):
        q, a = _l2_inputs(kind, nq, n, 128, dev, g)
        qn = (q.double() ** 2).sum(1, keepdim=True).cpu().numpy()
        _in_band(l2_dist(q, a), l2_dist_ref(q, a), 128, qn)


def test_cuda_graph_index_equals_search_ref(dev):
    """A CUDA NSG12,ids=roc index over 5000 vectors: search equal to its
    search_ref (every gate and select mode), after add and after a
    save/load round trip onto the card; the CPU index carried from the
    same adjacency gives the same results."""
    from repro_torch.ann.graph import GraphIndex
    from repro_torch.api import index_factory, load_index, save_index

    base, queries = _graph_data()
    idx = index_factory("NSG12,ids=roc", device=dev).build(base[:4500])
    assert idx.graph.base_dev.is_cuda
    cpu = GraphIndex(id_codec="roc", device="cpu").build(
        base[:4500], idx.graph.adj_raw)

    def same(index, ref_index):
        want = ref_index.graph.search_ref(queries, ef=24, topk=10) if \
            hasattr(ref_index, "graph") else ref_index.search_ref(
                queries, ef=24, topk=10)
        for km in (None, 1, 10**9):
            for select in ("auto", "host", "device"):
                reset_launches()
                ids, dists, st = index.graph.search(
                    queries, ef=24, topk=10, kernel_min=km, select=select)
                np.testing.assert_array_equal(ids, want[0])
                np.testing.assert_array_equal(dists, want[1])
                assert st.engine == "graph-pallas"
                if km in (1, 10**9):
                    assert (launch_counts()["l2_dist"] > 0) == (km == 1)
        return want

    want = same(idx, idx)
    np.testing.assert_array_equal(want[0], cpu.search(queries, ef=24,
                                                      topk=10)[0])
    idx.add(base[4500:])
    cpu.add(base[4500:], r=12)
    for a, b in zip(idx.graph.adj_raw, cpu.adj_raw):
        np.testing.assert_array_equal(a, b)
    same(idx, cpu)
    back = load_index(save_index(idx, graph_codec="rec"), device=dev)
    assert back.graph.base_dev.is_cuda and back.n_epochs == 2
    same(back, idx)
    with pytest.raises(ValueError, match="xla"):
        idx.search(queries, engine="xla")


# ---------------------------------------------------------------------------
# launches from several threads, and sharded serving on the card
# ---------------------------------------------------------------------------

def test_launch_counts_exact_under_threads(dev):
    """8 threads x 50 rounds, each round one launch of every kernel on
    the same (default) stream: every count and shape count is exact, and
    every result equals the serial one bit for bit."""
    import sys
    import threading

    from repro_torch.kernels import launch_shapes

    threads_n, rounds = 8, 50
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    q = torch.randn(16, 32, device=dev, generator=g)
    a = torch.randn(3000, 32, device=dev, generator=g)
    lens = torch.full((16,), 3000, dtype=torch.int32, device=dev)
    luts = torch.rand(16, 8, 256, device=dev, generator=g)
    codes = torch.randint(0, 256, (3000, 8), dtype=torch.uint8, device=dev,
                          generator=g)
    words, sup = pack_bits_u32(np.random.default_rng(0).integers(
        0, 2, 5000).astype(np.uint8))
    wt_args = (torch.from_numpy(words.view(np.int32)).to(dev),
               torch.from_numpy(sup).to(dev),
               torch.arange(0, 5000, 7, dtype=torch.int32, device=dev))
    sym, freq, start = (torch.from_numpy(t).to(dev)
                        for t in make_tables(np.array([3, 5]), 3))
    heads = torch.full((4,), 1 << 16, dtype=torch.int32, device=dev)
    words16 = torch.zeros(64, dtype=torch.int32, device=dev)

    def one_round():
        dm = l2_dist(q, a)
        return [dm, *seg_topk(dm, lens, 10), pq_adc(luts, codes),
                *l2_top1(a, q), wt_rank(*wt_args),
                rans_decode(heads, words16, sym, freq, start, 5, 3)]

    want = [t.clone() for t in one_round()]
    torch.cuda.synchronize()
    reset_launches()
    barrier = threading.Barrier(threads_n)
    bad = []

    def work():
        barrier.wait()
        for _ in range(rounds):
            got = one_round()
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                bad.append(1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    total = threads_n * rounds
    assert not bad
    assert launch_counts() == {name: total for name in (
        "l2_dist", "l2_top1", "pq_adc", "seg_topk", "wt_rank",
        "rans_decode")}
    shapes = launch_shapes()
    assert shapes["l2_dist_tiles"] == {(16, 3000): total}
    assert shapes["seg_topk"] == {(3000, 10): total}
    assert shapes["seg_topk_tiles"] == {(16, 3000, 10): total}
    assert shapes["l2_top1"] == {(16, 32, 3000): total}
    assert shapes["l2_dist"] == shapes["pq_adc"] == 3000 * total
    assert sum(shapes["wt_rank"].values()) == total


@pytest.mark.parametrize("kernel", ["l2_dist", "l2_top1"])
def test_tma_kernel_as_a_fresh_threads_first_cuda_call(dev, kernel):
    """A thread whose first CUDA call is a launch of a TMA kernel (the
    tensor map is encoded by a driver call, which needs a current
    context) launches it and gets the main thread's result."""
    import threading

    g = torch.Generator(device=dev)
    g.manual_seed(5)
    q = torch.randn(16, 32, device=dev, generator=g)
    a = torch.randn(500, 32, device=dev, generator=g)
    fn = l2_dist if kernel == "l2_dist" else l2_top1
    want = fn(q, a)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    got, errors = [], []

    def work():
        try:
            got.append(fn(q, a))
        except RuntimeError as e:
            errors.append(repr(e))

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    out = got[0] if isinstance(got[0], tuple) else (got[0],)
    assert len(out) == len(want)
    assert all(torch.equal(x, y) for x, y in zip(out, want))


@pytest.mark.parametrize("by", ["range", "hash"])
@pytest.mark.parametrize("payload", ["flat", "pq8"])
def test_cuda_sharded_ivf_equals_monolith(dev, payload, by):
    """A CUDA IVF64 index served by 4 shards on the card: merged ids and
    dists equal the CUDA monolith's, also after a routed add (every
    shard's n and epochs equal the monolith's); the scan kernels ran."""
    from repro_torch.api import index_factory
    from repro_torch.shard import ShardedAnnService, plan_shards

    rng = np.random.default_rng(12)
    base = rng.standard_normal((8000, 32)).astype(np.float32)
    base[100:104] = base[7]                    # exact ties across clusters
    queries = rng.standard_normal((50, 32)).astype(np.float32)
    spec = "IVF64,ids=roc" + (",PQ8x8" if payload == "pq8" else "")
    mono = index_factory(spec, device=dev).build(base, seed=2)
    d0, i0, _ = mono.search(queries, k=10, nprobe=8)
    plan = plan_shards(mono, 4, by=by)
    assert all(i.ivf.payload_dev.is_cuda for i in plan.indexes)
    with ShardedAnnService(plan, topk=10, device=dev, nprobe=8) as svc:
        reset_launches()
        ids, dists, st = svc.search(queries, with_stats=True)
        counts = launch_counts()
        np.testing.assert_array_equal(ids, i0)
        np.testing.assert_array_equal(dists, d0)
        assert st.engine == "pallas" and st.shards == 4 and not st.partial
        assert counts["seg_topk"] > 0
        assert counts["pq_adc" if payload == "pq8" else "l2_dist"] > 0
        extra = rng.standard_normal((700, 32)).astype(np.float32)
        reset_launches()
        svc.add(extra)
        assert launch_counts()["l2_top1"] >= 1     # the routed assignment
        mono.add(extra)
        d1, i1, _ = mono.search(queries, k=10, nprobe=8)
        got = svc.search(queries)
        np.testing.assert_array_equal(got[0], i1)
        np.testing.assert_array_equal(got[1], d1)
        for w in svc._workers:
            assert w.index.ivf.n == mono.ivf.n
            assert w.index.ivf.n_epochs == mono.ivf.n_epochs == 2


def test_cuda_sharded_flat_equals_monolith(dev, tmp_path):
    """A CUDA Flat index served by 4 hash shards on the card equals the
    CUDA monolith, also after the plan is saved and loaded onto the
    card."""
    from repro_torch.api import index_factory
    from repro_torch.shard import ShardedAnnService, ShardPlan, plan_shards

    rng = np.random.default_rng(13)
    base = rng.standard_normal((20000, 32)).astype(np.float32)
    base[5000:5010] = base[3]
    queries = rng.standard_normal((40, 32)).astype(np.float32)
    queries[0] = base[3]
    mono = index_factory("Flat", device=dev).build(base)
    d0, i0, _ = mono.search(queries, k=10)
    plan = plan_shards(mono, 4)
    plan.save(tmp_path)
    for shards in (plan, ShardPlan.load(tmp_path, device=dev)):
        with ShardedAnnService(shards, topk=10, device=dev) as svc:
            reset_launches()
            ids, dists, st = svc.search(queries, with_stats=True)
            assert launch_counts()["l2_dist"] >= 4
        assert st.engine == "flat-pallas"
        np.testing.assert_array_equal(ids, i0)
        np.testing.assert_array_equal(dists, d0)


def test_mlstm_at_full_width_on_the_f64_sides(dev):
    """xlstm-1.3b's mLSTM at the width and folded batch (4 sequences x 4
    heads = 16 in the SSD scan's batch, 512 tokens, p = 513, n = 512)
    where the train step's f32 gradients left f64 (``tools/
    xlstm_grad_gap.py --localise``): on the card in f32, on the sides of
    the normaliser's kink that a CPU f64 copy took, its output and every
    gradient within 3.32e-4 (the xlstm train-step bound) of the f64
    copy's scale."""
    import copy

    from repro_torch.configs import get_config
    from repro_torch.models import xlstm as PX

    cfg = get_config("xlstm-1.3b")
    mod = PX.MLstm(cfg, device="cpu")
    mod.init_(torch.Generator().manual_seed(0))
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.standard_normal((4, 512, cfg.d_model))
                         .astype(np.float32))
    ct = torch.from_numpy(r.standard_normal((4, 512, cfg.d_model))
                          .astype(np.float32))

    def run(m, device, dtype, sides=None):
        xx = x.to(device, dtype).requires_grad_()
        named = list(m.named_parameters())
        with PX.NormaliserSides(sides) as ns:
            y = PX.mlstm_apply(m, xx, cfg)
            grads = torch.autograd.grad(y, [xx] + [p for _, p in named],
                                        ct.to(device, dtype))
        return [y.detach().double().cpu()] + [
            g.double().cpu() for g in grads], ns.seen

    want, sides = run(copy.deepcopy(mod).double(), "cpu", torch.float64)
    got, _ = run(copy.deepcopy(mod).to(dev), dev, torch.float32, sides)
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 3.32e-4 * float(b.abs().max())

