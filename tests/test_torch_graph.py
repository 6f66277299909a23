"""Graph indexes of the port (``repro_torch.ann.graph``,
``repro_torch.ann.graph_scan``, ``GraphApiIndex``) against the reference's
(``repro.ann.graph``), on the CPU.

The reference's data shape (``tests/test_graph_scan_parity.py``: n = 800,
d = 24, rows 50-52 equal, two equal queries) goes into both packages.
Then, bit for bit:

* ``np_sum_f32`` equals ``np.sum`` (1-d and ``axis=1``) for every d of the
  numpy order's branches;
* the port's prune of the reference's own kNN lists is the reference's
  NSG / HNSW adjacency, and HNSW's reverse edges in closed form equal the
  reference's loop (also on random kept lists);
* the port's ``knn_graph`` equals the reference's except at positions
  where the two ids' distances lie within ``rescore_eps`` of each other;
* ``search`` and ``search_ref`` equal the reference's ``search_ref``, ids
  and dists, for NSG/HNSW x the 6 graph codecs x engine auto/xla x select
  host/device with ``kernel_min`` forcing the scorer, every gate, one
  query, ef = 1, topk > n and small query blocks;
* ``add`` and ``compact`` give the reference's adjacency, blobs,
  universes, cache invalidations and results;
* the API (``GraphApiIndex`` through ``index_factory``), ``from_arrays``
  and ``AnnService`` agree with the reference's.

Also the engine and device rules of a graph index.
"""

import numpy as np
import pytest
import torch

import jax

from _torch_blobs import canon
from repro.ann import graph as ref_graph
from repro.api import index_factory as ref_factory
from repro.serve.ann_service import AnnService as RefService
from repro.serve.ann_service import BatchPolicy as RefPolicy
from repro_torch.ann import graph as port_graph
from repro_torch.ann.graph import GraphIndex
from repro_torch.ann.graph_scan import GRAPH_BLOCK_N, KERNEL_MIN_CPU
from repro_torch.ann.npsum import np_sq_dist, np_sum_f32
from repro_torch.ann.scan import rescore_eps
from repro_torch.api import GraphApiIndex, as_api_index, index_factory
from repro_torch.serve import AnnService, BatchPolicy

jax.config.update("jax_platforms", "cpu")

ALL_CODECS = ["unc64", "unc32", "compact", "ef", "roc", "gap_ans"]
NPSUM_DIMS = [3, 7, 8, 9, 16, 24, 96, 100, 128, 129, 200, 256, 384, 960]


def _data(n=800, d=24, nq=33, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    base[50] = base[51]          # duplicate vectors -> exact distance ties
    base[52] = base[51]
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    queries[5] = queries[6]      # duplicate queries too
    return base, queries


BASE, QUERIES = _data()
_CACHE = {}


def graphs():
    """The reference's NSG12 / HNSW8 adjacency over ``BASE`` (built once)."""
    if "graphs" not in _CACHE:
        _CACHE["graphs"] = {"nsg": ref_graph.build_nsg(BASE, 12, seed=3),
                            "hnsw": ref_graph.build_hnsw(BASE, 8, seed=3)}
    return _CACHE["graphs"]


def pair(kind, codec):
    """(reference GraphIndex, port GraphIndex) over the same adjacency,
    and the reference's ``search_ref`` at ef = 24, top-10 (built once)."""
    key = (kind, codec)
    if key not in _CACHE:
        adj = graphs()[kind]
        ref = ref_graph.GraphIndex(id_codec=codec).build(BASE, adj)
        port = GraphIndex(id_codec=codec, device="cpu").build(BASE, adj)
        _CACHE[key] = (ref, port, ref.search_ref(QUERIES, ef=24, topk=10))
    return _CACHE[key]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])    # ids
    np.testing.assert_array_equal(got[1], want[1])    # dists, exact


# ---------------------------------------------------------------------------
# numpy's summation order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", NPSUM_DIMS)
def test_np_sum_f32_bit_equal_to_numpy(d):
    rng = np.random.default_rng(d)
    a = (rng.standard_normal((200, d))
         * rng.uniform(0.01, 1e4, (200, 1))).astype(np.float32)
    want_rows = np.sum(a, axis=1)
    want_1d = np.array([np.sum(row) for row in a], np.float32)
    got = np_sum_f32(torch.from_numpy(a)).numpy()
    assert got.view(np.int32).tolist() == want_rows.view(np.int32).tolist()
    assert got.view(np.int32).tolist() == want_1d.view(np.int32).tolist()
    # the reference's distance expression, and a sum over another dim
    b = rng.standard_normal((200, d)).astype(np.float32)
    sq = np_sq_dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(sq.view(np.int32),
                          np.sum((a - b) ** 2, axis=1).view(np.int32))
    cols = np_sum_f32(torch.from_numpy(np.ascontiguousarray(a.T)), dim=0)
    assert np.array_equal(cols.numpy().view(np.int32),
                          want_rows.view(np.int32))


def test_np_sum_f32_takes_float32_only():
    with pytest.raises(TypeError, match="float32"):
        np_sum_f32(torch.zeros(4, 9, dtype=torch.float64))
    assert np_sum_f32(torch.zeros(3, 0)).shape == (3,)


# ---------------------------------------------------------------------------
# the builders' decisions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nsg", "hnsw"])
def test_prune_of_reference_knn_is_reference_adjacency(kind):
    """The port's prune (and HNSW's closed-form reverse edges) of the
    reference's own kNN lists equals the reference's adjacency exactly —
    the duplicate rows make the candidates' tie order matter."""
    r, k = (12, 24) if kind == "nsg" else (8, 16)
    nn = ref_graph.knn_graph(BASE, k)
    kept = port_graph.prune_kept(BASE, nn, np.arange(len(BASE)), r,
                                 device="cpu")
    for i in range(len(BASE)):
        want = ref_graph._occlusion_prune(BASE, nn[i], i, r)
        assert kept[i, :len(want)].tolist() == want
        assert np.all(kept[i, len(want):] == -1)
    got = (port_graph.kept_lists(kept) if kind == "nsg"
           else port_graph.hnsw_reverse_edges(kept, r, device="cpu"))
    want = graphs()[kind]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _reverse_edges_loop(kept, m):
    """The reference's reverse-edge pass (graph.py's build_hnsw) on given
    kept lists."""
    adj = [list(k) for k in kept]
    for i in range(len(adj)):
        for j in adj[i]:
            if len(adj[j]) < m and i not in adj[j]:
                adj[j].append(i)
    return [np.asarray(sorted(set(a)), np.int64) for a in adj]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_hnsw_reverse_edges_closed_form_equals_loop(seed, m):
    """Random kept lists (full and short lists, reciprocal pairs, hubs
    many nodes point at) through the closed form and the loop."""
    rng = np.random.default_rng(seed)
    n = 300
    kept = np.full((n, m), -1, np.int64)
    lists = []
    for i in range(n):
        cnt = int(rng.integers(0, m + 1))
        pool = np.setdiff1d(np.concatenate(
            [rng.integers(0, 10, 3), rng.integers(0, n, 2 * m)]), [i])
        sel = rng.permutation(pool)[:cnt]
        kept[i, :len(sel)] = sel
        lists.append(sel.tolist())
    got = port_graph.hnsw_reverse_edges(kept, m, device="cpu")
    want = _reverse_edges_loop(lists, m)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_knn_graph_equal_except_near_ties():
    """Where the port's kNN lists differ from the reference's (XLA's f32
    dot), the two ids' distances at that position lie within
    ``rescore_eps`` — asserted position by position; and on this data the
    lists are equal."""
    base = BASE.copy()
    # more near-ties: near duplicates of row 10 a few ulps apart
    base[100:110] = base[10] * np.float32(1 + 1e-7)
    for k in (16, 24):
        want = ref_graph.knn_graph(base, k)
        got = port_graph.knn_graph(base, k, device="cpu")
        assert got.shape == want.shape and got.dtype == want.dtype
        x64 = base.astype(np.float64)
        for i, j in zip(*np.nonzero(got != want)):
            da = np.sum((x64[want[i, j]] - x64[i]) ** 2)
            db = np.sum((x64[got[i, j]] - x64[i]) ** 2)
            assert abs(da - db) <= rescore_eps(
                base.shape[1], da, float(x64[i] @ x64[i])), (i, j)
        for i in range(len(base)):
            assert i not in got[i]
        np.testing.assert_array_equal(
            port_graph.knn_graph(BASE, k, device="cpu"),
            ref_graph.knn_graph(BASE, k))


@pytest.mark.parametrize("kind", ["nsg", "hnsw"])
def test_port_builders_equal_reference(kind):
    """On this data the kNN lists agree, so the port's builders give the
    reference's adjacency (``timings`` filled)."""
    timings = {}
    if kind == "nsg":
        got = port_graph.build_nsg(BASE, 12, device="cpu", timings=timings)
    else:
        got = port_graph.build_hnsw(BASE, 8, device="cpu", timings=timings)
    assert set(timings) == {"knn_s", "prune_s"}
    for a, b in zip(got, graphs()[kind]):
        np.testing.assert_array_equal(a, b)


def test_prune_short_candidate_rows():
    """Rows with fewer candidates than the width (``lens``) prune as the
    reference does on the shorter list."""
    rng = np.random.default_rng(5)
    cand = np.stack([rng.permutation(np.arange(1, 400))[:20]
                     for _ in range(30)])
    lens = rng.integers(0, 21, 30)
    centers = np.zeros(30, np.int64)
    kept = port_graph.prune_kept(BASE, cand, centers, 6, lens=lens,
                                 device="cpu")
    for i in range(30):
        want = ref_graph._occlusion_prune(BASE, cand[i, :lens[i]], 0, 6)
        assert kept[i, :len(want)].tolist() == want


# ---------------------------------------------------------------------------
# search: codec x builder x engine x select matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("select", ["host", "device"])
@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("codec", ALL_CODECS)
@pytest.mark.parametrize("kind", ["nsg", "hnsw"])
def test_search_matches_reference(kind, codec, engine, select):
    _, port, want = pair(kind, codec)
    got = port.search(QUERIES, ef=24, topk=10, engine=engine,
                      kernel_min=1, select=select)
    _same(got, want)
    st = got[2]
    assert st.engine == "graph-xla"
    assert (st.device_select > 0) == (select == "device")
    assert st.host_block_bytes > 0


@pytest.mark.parametrize("codec", ALL_CODECS)
@pytest.mark.parametrize("kind", ["nsg", "hnsw"])
def test_search_ref_matches_reference(kind, codec):
    ref, port, want = pair(kind, codec)
    got = port.search_ref(QUERIES, ef=24, topk=10)
    _same(got, want)
    assert canon(port._blobs) == canon(ref._blobs)
    assert port.id_bits() == ref.id_bits()
    assert port.bits_per_edge() == ref.bits_per_edge()
    assert port.entry == ref.entry
    assert got[2].visited == want[2].visited and got[2].ndis == want[2].ndis


def test_kernel_gate_settings():
    """``kernel_min`` only decides which steps take the scorer."""
    _, port, want = pair("nsg", "roc")
    seen = set()
    for km in (None, 1, GRAPH_BLOCK_N, KERNEL_MIN_CPU, 10**9):
        got = port.search(QUERIES, ef=24, topk=10, kernel_min=km,
                          select="device")
        _same(got, want)
        seen.add(got[2].device_select)
    assert 0 in seen and len(seen) > 1


def test_device_select_pulls_less():
    _, port, want = pair("hnsw", "roc")
    dev = port.search(QUERIES, ef=24, topk=10, kernel_min=1, select="device")
    host = port.search(QUERIES, ef=24, topk=10, kernel_min=1, select="host")
    _same(dev, want)
    _same(host, want)
    assert host[2].device_select == 0 < dev[2].device_select
    assert 0 < dev[2].host_block_bytes < host[2].host_block_bytes
    # auto on a CPU index gathers on the host
    assert port.search(QUERIES[:4], kernel_min=1)[2].device_select == 0


def test_single_query_ef_one_topk_past_n_small_blocks():
    ref, port, _ = pair("nsg", "roc")
    _same(port.search(QUERIES[:1], ef=24, topk=10, kernel_min=1),
          ref.search_ref(QUERIES[:1], ef=24, topk=10))
    ref_h, port_h, _ = pair("hnsw", "roc")
    _same(port_h.search(QUERIES, ef=1, topk=1),
          ref_h.search_ref(QUERIES, ef=1, topk=1))
    _same(port.search(QUERIES, ef=4, topk=2 * len(BASE), kernel_min=1),
          ref.search_ref(QUERIES, ef=4, topk=2 * len(BASE)))
    want = ref.search_ref(QUERIES, ef=24, topk=10)
    for qb in (1, 7, 64):
        _same(port.search(QUERIES, ef=24, topk=10, query_block=qb,
                          kernel_min=1), want)


def test_stats_counters():
    _, port, want = pair("nsg", "roc")
    port.decoded_cache.clear()
    got = port.search(QUERIES, ef=24, topk=10)
    _same(got, want)
    st = got[2]
    assert st.steps > 0 and st.frontier_size >= st.steps
    assert st.visited > 0 and st.ndis >= st.visited
    assert 0 < st.decodes <= st.visited - st.dedup_hits


def test_engine_and_device_rules():
    _, port, _ = pair("nsg", "roc")
    with pytest.raises(ValueError, match="pallas"):
        port.search(QUERIES[:2], engine="pallas")
    with pytest.raises(ValueError, match="select"):
        port.search(QUERIES[:2], select="gpu")
    with pytest.raises(ValueError, match="engine"):
        port.search(QUERIES[:2], engine="triton")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            GraphIndex(id_codec="roc")
        with pytest.raises(RuntimeError, match="CUDA"):
            index_factory("NSG8,ids=roc")
        with pytest.raises(RuntimeError, match="CUDA"):
            port_graph.knn_graph(BASE, 8)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def _ingest_pair(codec, **fields):
    adj = [a[a < 700] for a in graphs()["nsg"][:700]]
    # each index its own list: the reference's add appends to the list
    # it was built with
    ref = ref_graph.GraphIndex(id_codec=codec, **fields).build(BASE[:700],
                                                               list(adj))
    port = GraphIndex(id_codec=codec, device="cpu", **fields).build(
        BASE[:700], list(adj))
    return ref, port


def _assert_same_state(ref, port):
    assert port.n == ref.n
    np.testing.assert_array_equal(port.x, ref.x)
    assert len(port.adj_raw) == len(ref.adj_raw)
    for a, b in zip(port.adj_raw, ref.adj_raw):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(port._universes, ref._universes)
    assert canon(port._blobs) == canon(ref._blobs)
    assert port.n_epochs == ref.n_epochs and port.id_bits() == ref.id_bits()


def _cached_keys(index):
    cache = index.decoded_cache
    return set(cache._lists) | set(cache._hot)


@pytest.mark.parametrize("codec", ALL_CODECS)
def test_add_matches_reference(codec):
    """Three adds (one row, 59 rows, 40 rows) then compact: adjacency,
    blobs, universes, cache invalidations and results equal."""
    ref, port = _ingest_pair(codec)
    ref.search_ref(QUERIES, ef=24, topk=10)      # warm both caches
    port.search_ref(QUERIES, ef=24, topk=10)
    for lo, hi in ((700, 701), (701, 760), (760, 800)):
        ref.add(BASE[lo:hi], r=12)
        port.add(BASE[lo:hi], r=12)
        _assert_same_state(ref, port)
        assert _cached_keys(port) == _cached_keys(ref)
    want = ref.search_ref(QUERIES, ef=24, topk=10)
    _same(port.search(QUERIES, ef=24, topk=10, kernel_min=GRAPH_BLOCK_N),
          want)
    _same(port.search_ref(QUERIES, ef=24, topk=10), want)
    ref.compact()
    port.compact()
    _assert_same_state(ref, port)
    assert port.n_epochs == 1
    _same(port.search(QUERIES, ef=24, topk=10, kernel_min=1,
                      select="device"), want)


def test_add_with_ties_and_max_epochs():
    """New rows equal to old rows and to each other (the candidates'
    stable order decides), a one-row base grown row by row, and
    ``max_epochs`` auto-compaction."""
    ref, port = _ingest_pair("roc", max_epochs=2)
    extra = np.concatenate([BASE[50:53], BASE[50:53], BASE[740:760]])
    for chunk in (extra[:4], extra[4:]):
        ref.add(chunk, r=12)
        port.add(chunk, r=12)
        _assert_same_state(ref, port)
    ref1 = ref_graph.GraphIndex(id_codec="ef").build(
        BASE[:1], [np.zeros(0, np.int64)])
    port1 = GraphIndex(id_codec="ef", device="cpu").build(
        BASE[:1], [np.zeros(0, np.int64)])
    for i in range(1, 40, 13):
        ref1.add(BASE[i:i + 13], r=4)
        port1.add(BASE[i:i + 13], r=4)
    _assert_same_state(ref1, port1)
    _same(port1.search(QUERIES, ef=8, topk=5, kernel_min=1),
          ref1.search_ref(QUERIES, ef=8, topk=5))


def test_small_blocks_match_reference(monkeypatch):
    """The block loops of ``knn_graph``, the prune and ``add``'s candidate
    search, at a few rows a block: the same lists as in one block."""
    monkeypatch.setitem(port_graph.BLOCK_BYTES, "cpu", 4 * 800 * 7)
    monkeypatch.setitem(port_graph.PRUNE_BYTES, "cpu", 8 * 24 * 24 * 24 * 5)
    np.testing.assert_array_equal(
        port_graph.knn_graph(BASE, 24, device="cpu"),
        ref_graph.knn_graph(BASE, 24))
    np.testing.assert_array_equal(
        port_graph.knn_graph(BASE, 24, device="cpu", chunk=64, rows=150),
        ref_graph.knn_graph(BASE, 24)[:150])
    ref, port = _ingest_pair("roc")
    ref.add(BASE[700:], r=12)
    port.add(BASE[700:], r=12)
    _assert_same_state(ref, port)


def test_from_arrays_carries_reference_state():
    """A reference index mid-ingest carried across as numpy arrays:
    the same blobs, universes and results."""
    ref, _ = _ingest_pair("gap_ans")
    ref.add(BASE[700:], r=12)
    port = GraphIndex.from_arrays(
        dict(x=ref.x, adj=ref.adj_raw, entry=ref.entry,
             universes=ref._universes), id_codec="gap_ans", device="cpu")
    _assert_same_state(ref, port)
    assert port.entry == ref.entry
    _same(port.search(QUERIES, ef=24, topk=10, kernel_min=1),
          ref.search_ref(QUERIES, ef=24, topk=10))
    medoid = GraphIndex.from_arrays(dict(x=BASE, adj=graphs()["nsg"]),
                                    id_codec="roc", device="cpu")
    assert medoid.entry == pair("nsg", "roc")[0].entry
    with pytest.raises(ValueError, match="friend list"):
        GraphIndex.from_arrays(dict(x=BASE, adj=graphs()["nsg"][:5]),
                               id_codec="roc", device="cpu")


# ---------------------------------------------------------------------------
# the API and the service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["NSG12,ids=roc", "HNSW8,ids=ef,cache_mb=1",
                                  "NSG12,ids=gap_ans,engine=xla"])
def test_factory_graph_matches_reference(spec):
    ref = ref_factory(spec).build(BASE)
    port = index_factory(spec, device="cpu").build(BASE)
    assert isinstance(port, GraphApiIndex) and port.spec == ref.spec
    assert set(port.build_s) == {"knn_s", "prune_s", "encode_s"}
    for a, b in zip(port.graph.adj_raw, ref.graph.adj_raw):
        np.testing.assert_array_equal(a, b)
    for k in (1, 10):
        got, want = port.search(QUERIES, k=k), ref.search(QUERIES, k=k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
    assert port.memory_ledger() == ref.memory_ledger()
    port.add(BASE[:30] + 0.5)
    ref.add(BASE[:30] + 0.5)
    assert port.n_epochs == ref.n_epochs == 2
    got, want = port.search(QUERIES, k=10, ef=20), ref.search(QUERIES, k=10,
                                                               ef=20)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert port.compact().n_epochs == 1


def test_append_rows_and_id_map():
    ref = ref_factory("NSG12,ids=roc").build(BASE[:700],
                                             adj=[a[a < 700] for a in
                                                  graphs()["nsg"][:700]])
    port = index_factory("NSG12,ids=roc", device="cpu").build(
        BASE[:700], adj=[a[a < 700] for a in graphs()["nsg"][:700]])
    for idx in (ref, port):
        idx.append_rows(BASE[700:720], np.arange(700, 720))
        with pytest.raises(ValueError, match="dense"):
            idx.append_rows(BASE[720:722], np.array([900, 901]))
        with pytest.raises(ValueError, match="one global id"):
            idx.append_rows(BASE[720:722], np.array([720]))
        idx.graph.id_map = np.arange(0, 3 * 720, 3, dtype=np.int64)
        with pytest.raises(ValueError, match="planner-made"):
            idx.add(BASE[720:722])
        with pytest.raises(ValueError, match="exceed"):
            idx.append_rows(BASE[720:722], np.array([5, 6]))
        idx.append_rows(BASE[720:740], np.arange(3000, 3020))
    for a, b in zip(port.graph.adj_raw, ref.graph.adj_raw):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.graph.id_map, ref.graph.id_map)
    got, want = port.search(QUERIES, k=10), ref.search(QUERIES, k=10)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert port.memory_ledger() == ref.memory_ledger()


def test_as_api_index_wraps_a_raw_graph():
    from repro.api import as_api_index as ref_as_api

    ref, port, _ = pair("nsg", "ef")
    got = as_api_index(port)
    assert isinstance(got, GraphApiIndex)
    assert got.spec == ref_as_api(ref).spec
    assert as_api_index(got) is got
    assert got.device == torch.device("cpu")


def test_ann_service_graph_matches_reference():
    """Tickets, counters and the cache budget of the graph service."""
    specs = "NSG12,ids=roc"
    ref = ref_factory(specs).build(BASE)
    port = index_factory(specs, device="cpu").build(BASE)
    clock = iter(np.arange(0.0, 1000.0, 0.25)).__next__
    clock2 = iter(np.arange(0.0, 1000.0, 0.25)).__next__
    opts = dict(ef=20, kernel_min=1)
    ref_svc = RefService(ref, topk=5, policy=RefPolicy(max_batch=8),
                         clock=clock, cache_mb=0.01, ef=20)
    port_svc = AnnService(port, topk=5, policy=BatchPolicy(max_batch=8),
                          clock=clock2, cache_mb=0.01, device="cpu", **opts)
    assert port.graph.decoded_cache.max_bytes == \
        ref.graph.decoded_cache.max_bytes == int(0.01 * (1 << 20))
    ref_t = [ref_svc.submit(QUERIES[i:i + 3]) for i in range(0, 33, 3)]
    port_t = [port_svc.submit(QUERIES[i:i + 3]) for i in range(0, 33, 3)]
    ref_svc.flush()
    port_svc.flush()
    for a, b in zip(ref_t, port_t):
        assert a.done and b.done
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
        assert (b.batch_id, b.batch_size) == (a.batch_id, a.batch_size)
    s_ref, s_port = ref_svc.stats(), port_svc.stats()
    assert s_port.keys() == s_ref.keys()
    for key in ("requests", "queries", "batches", "ndis"):
        assert s_port[key] == s_ref[key], key
    assert port_svc.steps > 0 and port_svc.dedup_hits >= 0
    assert s_port["device_selects"] == 0      # auto gathers on the host
    # ingest through the service, then search sees the rows
    ref_svc.add(BASE[:5] + 0.25)
    port_svc.add(BASE[:5] + 0.25)
    np.testing.assert_array_equal(port_svc.search(QUERIES[:4])[0],
                                  ref_svc.search(QUERIES[:4])[0])
    with pytest.raises(ValueError, match="device"):
        AnnService(port, device="meta")
