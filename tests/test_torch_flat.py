"""Flat search of the port (``repro_torch.api.FlatIndex``,
``repro_torch.ann.scan.batched_flat_search``) against the reference's
``repro.api.FlatIndex``, on the CPU.

The same seeded vectors go into both packages; ids and dists must be
``np.array_equal`` for the reference's numpy loop (engine None), its
kernel path on XLA and in Pallas interpret mode, and the port's numpy
loop and kernel path (``l2_dist`` + ``seg_topk`` plain versions on a CPU
index).  Also: k > n, duplicate rows that make the K-doubling retry run
more than twice, ``id_map`` through ``append_rows`` (padding slots at id
0 / dist inf) with its ValueErrors, ``add`` then search (the device base
is re-uploaded), the engine rules of a CPU index, and ``AnnService``
over Flat (tickets equal to the reference service's; ``cache_mb``
refused).
"""

import numpy as np
import pytest

import jax

from repro.api import index_factory as ref_factory
from repro.serve.ann_service import AnnService as RefService
from repro.serve.ann_service import BatchPolicy as RefPolicy
from repro_torch.api import FlatIndex, as_api_index, index_factory
from repro_torch.serve import AnnService, BatchPolicy

jax.config.update("jax_platforms", "cpu")

K = 10


def _data(n=1500, d=24, nq=21, seed=0, dups=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    if n > 7:
        base[7] = base[3]                    # a tie
        queries[0] = base[3]
    if dups:
        # many rows at one distance from query 1: the kernel band holds
        # them all, so K doubles until it does
        base[100:100 + dups] = base[50]
        queries[1] = base[50] + 0.01
    return base, queries


def pair(base, **kw):
    return (ref_factory("Flat").build(base),
            index_factory("Flat", device="cpu", **kw).build(base))


def _same(got, want):
    """(dists, ids, stats) of both packages: ids and dists equal."""
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("query_block", [1, 8, 64])
@pytest.mark.parametrize("engine", [None, "xla", "auto"])
def test_flat_matches_reference_loop_and_kernel_path(engine, query_block):
    base, queries = _data()
    ref, port = pair(base)
    want = ref.search(queries, k=K)
    assert want[2].engine == "flat"
    _same(ref.search(queries, k=K, engine="xla"), want)
    got = port.search(queries, k=K, engine=engine, query_block=query_block)
    _same(got, want)
    assert got[2].engine == ("flat" if engine is None else "flat-xla")
    assert got[2].ndis == want[2].ndis
    if engine is not None:
        assert got[2].device_select == got[2].batches == \
            -(-len(queries) // query_block)


def test_flat_matches_reference_pallas_interpret():
    """The reference's kernel path with its Pallas kernels in interpret
    mode, as its own tests run them on the CPU."""
    base, queries = _data(n=700, d=16, nq=6)
    ref, port = pair(base)
    want = ref.search(queries, k=K, engine="pallas")
    assert want[2].engine == "flat-pallas"
    _same(port.search(queries, k=K, engine="xla"), want)
    _same(port.search(queries, k=K), want)


@pytest.mark.parametrize("n,k", [(5, 9), (1, 3), (30, 30), (40, 64)])
def test_k_past_n(n, k):
    base, queries = _data(n=n, d=8, nq=4, seed=n)
    ref, port = pair(base)
    want = ref.search(queries, k=k)
    for engine in (None, "xla"):
        got = port.search(queries, k=k, engine=engine)
        _same(got, want)
        assert np.isinf(got[0][:, n:]).all() and (got[1][:, n:] == 0).all()
    _same(ref.search(queries, k=k, engine="xla"), want)


@pytest.mark.parametrize("n,nq,k,query_block", [(700, 19, 10, 8),
                                                  (6, 4, 10, 64),
                                                  (1500, 21, 40, 16)])
def test_ann_layer_flat_search_matches_reference(n, nq, k, query_block):
    """The ann-layer function on its own: host rows plus their padded
    device base, no api index, against the reference's (vecs, queries)."""
    from repro.ann.scan import batched_flat_search as ref_flat
    from repro_torch.ann.scan import batched_flat_search, padded_base

    base, queries = _data(n=n, nq=nq)
    want = ref_flat(base, queries, topk=k, engine="xla",
                    query_block=query_block)
    dev_base = padded_base(base, "cpu")
    assert dev_base.shape == (max(1024, 1 << (n - 1).bit_length()),
                              base.shape[1])
    got = batched_flat_search(base, dev_base, queries, topk=k,
                              engine="auto", query_block=query_block)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2].engine == "flat-xla"
    assert got[2].device_select == got[2].batches == -(-nq // query_block)


def test_duplicate_rows_make_the_retry_double_k(monkeypatch):
    import repro_torch.ann.scan as scan

    seen = []
    real = scan.seg_topk

    def recording(dmat, lens, k):
        seen.append((dmat.shape[1], k))
        return real(dmat, lens, k)

    monkeypatch.setattr(scan, "seg_topk", recording)
    base, queries = _data(n=3000, d=16, nq=5, dups=300)
    ref, port = pair(base)
    want = ref.search(queries, k=K)
    _same(port.search(queries, k=K, engine="xla"), want)
    ks = [k for _, k in seen]
    assert ks == [32, 64, 128, 256, 512], ks   # four doublings
    assert all(n == 4096 for n, _ in seen)      # the base padded to 2^12
    _same(ref.search(queries, k=K, engine="xla"), want)
    # row 50 and its 300 copies tie: the lowest rows win, in order
    assert list(want[1][1]) == [50] + list(range(100, 100 + K - 1))


def test_id_map_through_append_rows():
    base, queries = _data(n=400, d=12, nq=6)
    gids = np.sort(np.random.default_rng(1).choice(
        4000, 400, replace=False)).astype(np.int64)
    ref, port = pair(base)
    ref.id_map, port.id_map = gids, gids.copy()
    extra = np.random.default_rng(2).standard_normal((5, 12)).astype(
        np.float32)
    new_ids = np.arange(5000, 5005, dtype=np.int64)
    for idx in (ref, port):
        idx.append_rows(extra, new_ids)
        idx.append_rows(extra[:0], new_ids[:0])      # empty: no-op
    np.testing.assert_array_equal(port.id_map, ref.id_map)
    k = 500                                          # past n: padding slots
    want = ref.search(np.concatenate([queries, extra[:2]]), k=k)
    for engine in (None, "xla"):
        got = port.search(np.concatenate([queries, extra[:2]]), k=k,
                          engine=engine)
        _same(got, want)
        assert (got[1][:, 405:] == 0).all() and np.isinf(got[0][:, 405:]).all()
    assert got[1][-1, 0] == 5001
    assert port.memory_ledger() == ref.memory_ledger()
    for idx in (ref, port):
        with pytest.raises(ValueError, match="one global id per"):
            idx.append_rows(extra, new_ids[:3])
        with pytest.raises(ValueError, match="must exceed"):
            idx.append_rows(extra[:1], np.array([10], np.int64))
        with pytest.raises(ValueError, match="planner-made"):
            idx.add(extra)
    dense_ref, dense_port = pair(base)
    for idx in (dense_ref, dense_port):
        with pytest.raises(ValueError, match="must be dense"):
            idx.append_rows(extra[:2], np.array([400, 402], np.int64))
        idx.append_rows(extra[:2], np.array([400, 401], np.int64))
    _same(dense_port.search(extra, k=K, engine="xla"), dense_ref.search(
        extra, k=K))


def test_add_then_search_reuploads_the_base():
    base, queries = _data(n=900, d=16, nq=8)
    extra = np.random.default_rng(4).standard_normal((200, 16)).astype(
        np.float32)
    ref, port = pair(base)
    port.search(queries, k=K, engine="xla")
    before = port.base_dev
    assert before.shape == (1024, 16)
    for idx in (ref, port):
        idx.add(extra[:100])
        idx.add(extra[100])                  # one row
    assert port.n == ref.n == 1001
    got = port.search(np.concatenate([queries, extra[:3]]), k=K,
                      engine="xla")
    assert port.base_dev is not before and port.base_dev.shape == (1024, 16)
    _same(got, ref.search(np.concatenate([queries, extra[:3]]), k=K))
    np.testing.assert_array_equal(got[1][-3:, 0], [900, 901, 902])
    port.add(extra[101:])                    # past 1024 rows: 2048 padded
    port.search(queries[:1], k=K, engine="xla")
    assert port.base_dev.shape == (2048, 16)


def test_engine_rules_on_a_cpu_flat_index():
    base, queries = _data(n=200, d=8, nq=3)
    port = index_factory("Flat", device="cpu").build(base)
    assert isinstance(port, FlatIndex) and as_api_index(port) is port
    with pytest.raises(ValueError, match="pallas"):
        port.search(queries, engine="pallas")
    with pytest.raises(ValueError, match="scan engine"):
        port.search(queries, engine="tpu")
    with pytest.raises(TypeError, match="unknown options"):
        port.search(queries, nprobe=4)
    assert port.search(queries)[2].engine == "flat"
    for engine in ("auto", "xla"):
        assert port.search(queries, engine=engine)[2].engine == "flat-xla"
    spec = index_factory("Flat,engine=xla", device="cpu").build(base)
    assert spec.search(queries)[2].engine == "flat-xla"
    _same(spec.search(queries), port.search(queries))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_ann_service_over_flat_matches_reference():
    base, queries = _data(n=1200, d=16, nq=24)
    ref, port = pair(base)
    ref_svc = RefService(ref, topk=K, policy=RefPolicy(max_batch=8,
                                                       max_wait_s=0.5),
                         clock=_Clock())
    port_clock = _Clock()
    port_svc = AnnService(port, topk=K, policy=BatchPolicy(
        max_batch=8, max_wait_s=0.5), clock=port_clock, device="cpu",
        engine="auto")
    sizes = [1, 3, 4, 2, 7, 1, 1, 5]
    ref_t, port_t, row = [], [], 0
    for i, s in enumerate(sizes):
        ref_svc.clock.t = port_clock.t = 0.1 * i
        ref_t.append(ref_svc.submit(queries[row:row + s]))
        port_t.append(port_svc.submit(queries[row:row + s]))
        row += s
    ref_svc.flush()
    port_svc.flush()
    for a, b in zip(ref_t, port_t):
        assert a.done and b.done
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
        assert (b.batch_id, b.batch_size, b.wait_s) == \
            (a.batch_id, a.batch_size, a.wait_s)
    s_ref, s_port = ref_svc.stats(), port_svc.stats()
    for key in ("requests", "queries", "batches", "ndis", "mean_batch",
                "max_batch", "mean_wait_s"):
        assert s_port[key] == s_ref[key], key
    assert s_port["device_selects"] == s_port["batches"]
    assert port_svc.last_stats.engine == "flat-xla"
    assert port_svc.memory_ledger() == ref_svc.memory_ledger()
    # ingest through the service: the new rows are found
    for svc in (ref_svc, port_svc):
        svc.add(queries[:2] + 1e-3)
    a, b = ref_svc.search(queries[:2]), port_svc.search(queries[:2])
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])


def test_cache_mb_on_a_flat_service_raises():
    base, _ = _data(n=100, d=8, nq=1)
    ref, port = pair(base)
    with pytest.raises(ValueError, match="no decoded-list cache"):
        RefService(ref, cache_mb=4)
    with pytest.raises(ValueError, match="no decoded-list cache"):
        AnnService(port, cache_mb=4, device="cpu")
