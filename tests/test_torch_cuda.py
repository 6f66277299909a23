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
tables in global memory and 1 to 1024 lanes); ``l2_top1`` run twice must
give bitwise-equal results; a CUDA index is held bit-exact against its
own ``search_ref`` and against a CPU index carried from the same arrays,
also after ingest.  k-means on the card must give bitwise-equal centroids
from run to run.  Whether a card is present is decided inside the
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
