"""The port's CUDA kernels and a CUDA index on the card (skipped without one).

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain torch version on the same CUDA
tensors at the edge shapes the CPU tests use for the plain versions
(ragged tiles, ``k > n``, ``lens = 0``, ties, ``+inf``, signed zeros,
every ``m`` of the grammar's common PQ shapes); a CUDA index is held
bit-exact against its own ``search_ref`` and against a CPU index carried
from the same arrays.  Whether a card is present is decided inside the
fixture, so every worker collects the same tests.
"""

import numpy as np
import pytest
import torch

from repro_torch.ann.ivf import IVFIndex
from repro_torch.ann.scan import rescore_eps
from repro_torch.kernels import (l2_dist, l2_dist_ref, launch_counts, pq_adc,
                                 pq_adc_ref, reset_launches, seg_topk,
                                 seg_topk_ref)

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


@pytest.mark.parametrize("nq,n,d", [(1, 1, 8), (3, 7, 32), (17, 513, 32),
                                    (64, 1000, 128), (9, 300, 33),
                                    (65, 129, 96), (200, 4099, 128)])
def test_l2_dist_kernel(dev, nq, n, d):
    g = torch.Generator(device=dev).manual_seed(nq + n)
    q = torch.randn(nq, d, device=dev, generator=g)
    a = torch.randn(n, d, device=dev, generator=g)
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
