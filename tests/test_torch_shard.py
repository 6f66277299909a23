"""Sharded serving of the port (``repro_torch.shard``) against the
reference's (``repro.shard``), on the CPU.

The reference's own data (``tests/test_shard.py``: 1500 x 16 with exact
duplicates, ``NSG8`` over 300 x 8; ``tests/test_epochs.py``: 400 x 20
plus 90 rows to ingest) goes into both packages, their IVF indexes built
from the same centroids and PQ codebooks (carried across as numpy
arrays).  Then:

* **planning** — for every id codec of the matrix, IVF + PQ + Pólya,
  Flat and NSG8, by ``range`` / ``hash`` / ``custom`` and 1, 2 or 5
  shards: each shard's RIDX bytes equal the reference planner's, the
  manifests are equal, and so are ``cluster_owner()`` / ``id_owner()``
  (or both raise the same error);
* **serving** — ``ShardedAnnService`` ids and dists ``np.array_equal`` to
  the port's monolith and to the reference's sharded service, for engine
  ``auto``/``xla`` and select ``host``/``device`` (graph shards in the
  exhaustive regime, ``ef = 400``);
* **routed ingest** — every shard seals every epoch with the global count
  (same blob bytes as the reference's shards), merged results equal the
  monolith after the same adds; a plan-less ingest raises;
* **plan files** — the reference loads the port's saved plan and the port
  loads the reference's, same files, same results;
* **faults** — dead, all dead, flaky, retries exhausted, deadline (real
  sleeps, CPU only), and an exception outside the fault taxonomy, which
  propagates;
* ``stats()`` keys and the memory ledger equal the reference's, and the
  default device is the card (raises without one).
"""

import re

import numpy as np
import pytest
import torch

import jax

from repro.ann.kmeans import kmeans as ref_kmeans
from repro.ann.pq import ProductQuantizer as RefPQ
from repro.api import index_factory as ref_factory
from repro.api import save_index as ref_save
from repro.shard import RetryPolicy as RefRetry
from repro.shard import ScriptedFaults as RefFaults
from repro.shard import ShardedAnnService as RefService
from repro.shard import ShardPlan as RefPlan
from repro.shard import plan_shards as ref_plan
from repro_torch.api import index_factory, save_index
from repro_torch.kernels import launch_counts
from repro_torch.shard import (FaultPolicy, RetryPolicy, ScriptedFaults,
                               ShardedAnnService, ShardPlan, plan_shards)

jax.config.update("jax_platforms", "cpu")

K, NPROBE, NLIST = 12, 5, 32
SPECS = {"roc": "IVF32,ids=roc", "wt": "IVF32,ids=wt",
         "gap_ans": "IVF32,ids=gap_ans",
         "pq_polya": "IVF32,PQ4,ids=gap_ans,codes=polya",
         "flat": "Flat", "nsg": "NSG8,ids=roc"}
IVF_KEYS = ["roc", "wt", "gap_ans", "pq_polya"]
NO_SLEEP = dict(sleep=lambda s: None)


def _data():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    # duplicate vectors -> exact distance ties; the merge must reproduce
    # the monolithic tie order, not just the distances
    x[200] = x[100]
    x[201] = x[100]
    q = rng.standard_normal((9, 16)).astype(np.float32)
    return x, q


def _graph_data():
    rng = np.random.default_rng(3)
    return (rng.standard_normal((300, 8)).astype(np.float32),
            rng.standard_normal((5, 8)).astype(np.float32))


X, Q = _data()
GX, GQ = _graph_data()
_CACHE = {}


def _shared(x, nlist, m):
    """Centroids and PQ codebooks trained once by the reference."""
    key = ("shared", x.shape, nlist, m)
    if key not in _CACHE:
        _CACHE[key] = (np.asarray(ref_kmeans(x, nlist, iters=4, seed=1)),
                       RefPQ(m=m, bits=8).train(x, iters=3).codebooks)
    return _CACHE[key]


def _build(factory, spec, x, **kw):
    idx = factory(spec, **kw)
    if not hasattr(idx, "ivf"):
        return idx.build(x)
    centroids, codebooks = _shared(x, idx.ivf.nlist, 4)
    if idx.ivf.pq is not None:
        idx.ivf.pq.codebooks = codebooks.copy()
    return idx.build(x, seed=1, centroids=centroids)


def both(spec, x):
    """(reference index, port index on the CPU), built fresh."""
    return (_build(ref_factory, spec, x),
            _build(index_factory, spec, x, device="cpu"))


def mono(key):
    """``both`` of one key of SPECS, built once (never mutated)."""
    if key not in _CACHE:
        _CACHE[key] = both(SPECS[key], GX if key == "nsg" else X)
    return _CACHE[key]


def _opts(key):
    if key in IVF_KEYS:
        return dict(nprobe=NPROBE)
    return dict(ef=400) if key == "nsg" else {}


def _queries(key):
    return GQ if key == "nsg" else Q


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])    # ids
    np.testing.assert_array_equal(got[1], want[1])    # dists, exact


def _plan_kw(key, by, nshards):
    if by != "custom":
        return dict(by=by)
    units = NLIST if key in IVF_KEYS else len(GX if key == "nsg" else X)
    rng = np.random.default_rng(nshards)
    return dict(assignments=rng.integers(0, nshards, size=units))


def _same_outcome(ref_call, port_call):
    """Both calls return equal arrays, or both raise the same ValueError."""
    try:
        want = ref_call()
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            port_call()
    else:
        np.testing.assert_array_equal(port_call(), want)


# ---------------------------------------------------------------------------
# planning: bytes, manifests, routing tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nshards", [1, 2, 5])
@pytest.mark.parametrize("by", ["range", "hash", "custom"])
@pytest.mark.parametrize("key", list(SPECS))
def test_plan_bytes_manifest_and_owners(key, by, nshards):
    ref, port = mono(key)
    kw = _plan_kw(key, by, nshards)
    if key not in IVF_KEYS and by == "range":
        with pytest.raises(ValueError) as want:
            ref_plan(ref, nshards, **kw)
        with pytest.raises(ValueError, match=re.escape(str(want.value))):
            plan_shards(port, nshards, **kw)
        return
    rp, pp = ref_plan(ref, nshards, **kw), plan_shards(port, nshards, **kw)
    assert pp.manifest() == rp.manifest()
    assert pp.by == rp.by and pp.kind == rp.kind and pp.n == rp.n
    for a, b in zip(pp.indexes, rp.indexes, strict=True):
        assert save_index(a) == ref_save(b)
        assert a.device == torch.device("cpu")
        if key in IVF_KEYS:
            assert a.ivf.payload_dev is not None
            assert a.ivf.centroids_dev is not None
    _same_outcome(rp.cluster_owner, pp.cluster_owner)
    new_ids = np.arange(rp.n, rp.n + 50)
    _same_outcome(lambda: rp.id_owner(new_ids), lambda: pp.id_owner(new_ids))


@pytest.mark.parametrize("kw", [
    dict(nshards=0),
    dict(nshards=2, by="range", boundaries=[0, 40, 32]),
    dict(nshards=2, by="hash", boundaries=[0, 16, 32]),
    dict(nshards=2, by="zone"),
    dict(nshards=2, assignments=np.zeros(7, np.int64)),
    dict(nshards=2, assignments=np.full(NLIST, 2, np.int64)),
])
def test_plan_validation_matches_reference(kw):
    ref, port = mono("roc")
    kw = dict(kw)
    n = kw.pop("nshards")
    with pytest.raises(ValueError) as want:
        ref_plan(ref, n, **kw)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        plan_shards(port, n, **kw)


def test_planner_shards_refuse_direct_add():
    for key in ("flat", "nsg"):
        _, port = mono(key)
        shard = plan_shards(port, 2).indexes[0]
        with pytest.raises(ValueError, match="planner-made"):
            shard.add((GX if key == "nsg" else X)[:3])


def test_empty_graph_shard_raises():
    ref, port = mono("nsg")
    owner = np.zeros(len(GX), np.int64)
    with pytest.raises(ValueError) as want:
        ref_plan(ref, 2, assignments=owner)
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        plan_shards(port, 2, assignments=owner)


def test_uneven_shards_and_k_over_shard_capacity():
    """One shard owns 2 clusters (often fewer than k candidates under the
    probe set), another 28."""
    ref, port = mono("roc")
    d0, i0, _ = port.search(Q, k=K, nprobe=NPROBE)
    pp = plan_shards(port, 3, by="range", boundaries=[0, 2, 30, 32])
    assert [s.clusters for s in pp.shards] == [[0, 2], [2, 30], [30, 32]]
    with ShardedAnnService(pp, topk=K, device="cpu", nprobe=NPROBE) as svc:
        _same(svc.search(Q), (i0, d0))
    rp = ref_plan(ref, 3, by="range", boundaries=[0, 2, 30, 32])
    with RefService(rp, topk=K, nprobe=NPROBE, engine="xla") as rsvc:
        _same(rsvc.search(Q), (i0, d0))


# ---------------------------------------------------------------------------
# serving: the merge against the monolith and the reference's router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("by", ["range", "hash"])
@pytest.mark.parametrize("select", ["host", "device"])
@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("key", IVF_KEYS)
def test_ivf_sharded_search_equals_monolith_and_reference(key, engine,
                                                          select, by):
    ref, port = mono(key)
    d0, i0, _ = port.search(Q, k=K, nprobe=NPROBE, engine=engine,
                            select=select)
    d1, i1, _ = port.search(Q, k=K, nprobe=NPROBE, select="host")
    _same((i0, d0), (i1, d1))
    with ShardedAnnService(plan_shards(port, 3, by=by), topk=K,
                           device="cpu", nprobe=NPROBE, engine=engine,
                           select=select) as svc:
        ids, dists, st = svc.search(Q, with_stats=True)
        stats = svc.stats()
    _same((ids, dists), (i0, d0))
    assert st.partial is False and st.shards == 3 and st.shards_failed == 0
    assert st.engine == "xla"
    if select == "device":
        assert st.device_select > 0 and stats["device_selects"] > 0
    with RefService(ref_plan(ref, 3, by=by), topk=K, nprobe=NPROBE,
                    engine="xla", select=select) as rsvc:
        _same(rsvc.search(Q), (ids, dists))


@pytest.mark.parametrize("nshards", [1, 3, 5])
@pytest.mark.parametrize("engine", [None, "auto", "xla"])
def test_flat_sharded_search_equals_monolith_and_reference(engine, nshards):
    ref, port = mono("flat")
    opts = {} if engine is None else dict(engine=engine)
    d0, i0, st0 = port.search(Q, k=K, **opts)
    assert st0.engine == ("flat" if engine is None else "flat-xla")
    with ShardedAnnService(plan_shards(port, nshards), topk=K, device="cpu",
                           **opts) as svc:
        got = svc.search(Q)
    _same(got, (i0, d0))
    with RefService(ref_plan(ref, nshards), topk=K) as rsvc:
        _same(rsvc.search(Q), got)


@pytest.mark.parametrize("nshards", [1, 2])
@pytest.mark.parametrize("select", ["host", "device"])
@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_graph_sharded_search_exhaustive(engine, select, nshards):
    """Graph shards are rebuilt subgraphs, so parity holds in the
    exhaustive regime (ef >= n, every node reachable)."""
    ref, port = mono("nsg")
    d0, i0, _ = port.search(GQ, k=10, ef=400, engine=engine, select=select)
    with ShardedAnnService(plan_shards(port, nshards, seed=0), topk=10,
                           device="cpu", ef=400, engine=engine,
                           select=select) as svc:
        got = svc.search(GQ)
    _same(got, (i0, d0))
    with RefService(ref_plan(ref, nshards, seed=0), topk=10,
                    ef=400) as rsvc:
        _same(rsvc.search(GQ), got)


def test_custom_assignments_serve_equal():
    ref, port = mono("roc")
    owner = np.random.default_rng(0).integers(0, 3, size=NLIST)
    d0, i0, _ = port.search(Q, k=K, nprobe=NPROBE)
    pp = plan_shards(port, 3, assignments=owner)
    assert pp.by == "custom"
    with ShardedAnnService(pp, topk=K, device="cpu", nprobe=NPROBE) as svc:
        _same(svc.search(Q), (i0, d0))


def test_cache_budget_split_across_shards():
    _, port = mono("roc")
    budget_mb = 1.0
    with ShardedAnnService(plan_shards(port, 4), topk=K, device="cpu",
                           nprobe=NPROBE, cache_mb=budget_mb) as svc:
        for w in svc._workers:
            assert w.index.ivf.decoded_cache.max_bytes == int(
                budget_mb / 4 * (1 << 20))
        for _ in range(3):
            svc.search(Q)
        led = svc.memory_ledger()
    assert led["shards"] == 4.0
    assert 0 < led["decoded_cache_bytes"] <= budget_mb * (1 << 20)
    assert led["ids_bytes"] < led["ids_bytes_compact"] < led["ids_bytes_unc64"]


def test_stats_keys_and_ledger_equal_reference():
    ref, port = mono("roc")
    svc = ShardedAnnService(plan_shards(port, 2), topk=K, device="cpu",
                            nprobe=NPROBE)
    rsvc = RefService(ref_plan(ref, 2), topk=K, nprobe=NPROBE, engine="xla")
    with svc, rsvc:
        assert svc.memory_ledger() == rsvc.memory_ledger()
        for i in range(4):
            _same(svc.search(Q[i:i + 2]), rsvc.search(Q[i:i + 2]))
        st, rst = svc.stats(), rsvc.stats()
        assert set(st) == set(rst)
        assert [set(w) for w in svc.worker_stats()] == [
            set(w) for w in rsvc.worker_stats()]
        assert svc.memory_ledger() == rsvc.memory_ledger()
    assert st["requests"] == 4 and st["queries"] == 8
    assert st["batches"] == 4 and st["shards"] == 2.0
    assert st["partial_batches"] == 0.0 and st["retries"] == 0.0
    assert 0.0 < st["p50_latency_s"] <= st["p95_latency_s"]
    assert st["mean_latency_s"] > 0.0 and st["merge_s"] > 0.0
    assert all(w["batches"] == 4 for w in svc.worker_stats())


def test_micro_batching_and_tickets():
    """Requests batch under the router's policy; each ticket gets its own
    rows of the merged answer."""
    from repro_torch.serve import BatchPolicy

    _, port = mono("roc")
    d0, i0, _ = port.search(Q, k=K, nprobe=NPROBE)
    now = [0.0]
    svc = ShardedAnnService(plan_shards(port, 2), topk=K, device="cpu",
                            clock=lambda: now[0], nprobe=NPROBE,
                            policy=BatchPolicy(max_batch=6, max_wait_s=1.0))
    with svc:
        t1 = svc.submit(Q[:2])
        t2 = svc.submit(Q[2])
        assert not t1.done and svc.pending() == 3
        now[0] = 2.0
        assert svc.tick() and t1.done and t2.done
        t3 = svc.submit(Q[3:9])                  # reaches max_batch
        assert t3.done and t3.batch_size == 6 and svc.pending() == 0
    _same((np.concatenate([t1.ids, t2.ids, t3.ids]),
           np.concatenate([t1.dists, t2.dists, t3.dists])), (i0, d0))
    assert t1.batch_id == t2.batch_id == 0 and t3.batch_id == 1
    assert t1.stats.shards == 2 and t1.wait_s == 2.0


# ---------------------------------------------------------------------------
# routed ingest
# ---------------------------------------------------------------------------

def _ingest_data():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(400, 20)).astype(np.float32),
            rng.normal(size=(90, 20)).astype(np.float32),
            rng.normal(size=(10, 20)).astype(np.float32))


@pytest.mark.parametrize("spec", ["IVF8,ids=roc", "IVF8,ids=wt",
                                  "IVF8,PQ4x8,ids=roc,codes=polya"])
def test_sharded_ivf_ingest_bit_parity(spec):
    x, extra, q = _ingest_data()
    ref, port = both(spec, x)
    for idx in (ref, port):
        idx.add(extra[:20])                   # epochs exist before the split
    rp, pp = ref_plan(ref, 3, by="range"), plan_shards(port, 3, by="range")
    with ShardedAnnService(pp, topk=10, device="cpu") as svc, \
            RefService(rp, topk=10, engine="xla") as rsvc:
        for lo, hi in ((20, 50), (50, 90)):
            for s in (svc, rsvc):
                s.add(extra[lo:hi])
            port.add(extra[lo:hi])
        d_m, ids_m, _ = port.search(q, k=10)
        _same(svc.search(q), (ids_m, d_m))
        _same(rsvc.search(q), (ids_m, d_m))
        # every shard sealed every epoch with the global universe, with the
        # reference's shard bytes
        for w, rw in zip(svc._workers, rsvc._workers, strict=True):
            assert w.index.ivf.n == port.ivf.n == len(x) + len(extra)
            assert w.index.ivf.n_epochs == port.ivf.n_epochs == 4
            assert save_index(w.index) == ref_save(rw.index)
        assert svc.stats()["add_rows"] == 70
        assert svc.stats()["add_batches"] == 2


def test_sharded_hash_ingest_routes_all_rows():
    x, extra, q = _ingest_data()
    port = index_factory("Flat", device="cpu").build(x)
    whole = index_factory("Flat", device="cpu").build(
        np.concatenate([x, extra]))
    with ShardedAnnService(plan_shards(port, 3, by="hash"), topk=10,
                           device="cpu") as svc:
        t = svc.add(extra)
        assert t.done and t.ids[0] == x.shape[0]
        assert sum(int(w.index.n) for w in svc._workers) == whole.n
        d_m, ids_m, _ = whole.search(q, k=10)
        _same(svc.search(q), (ids_m, d_m))


def test_graph_hash_ingest_matches_reference():
    ref, port = both("NSG8,ids=roc", GX)
    extra = np.random.default_rng(5).standard_normal((40, 8)).astype(
        np.float32)
    with ShardedAnnService(plan_shards(port, 2, seed=0), topk=10,
                           device="cpu", ef=400) as svc, \
            RefService(ref_plan(ref, 2, seed=0), topk=10, ef=400) as rsvc:
        for s in (svc, rsvc):
            s.add(extra)
        _same(svc.search(GQ), rsvc.search(GQ))
        for w, rw in zip(svc._workers, rsvc._workers, strict=True):
            assert save_index(w.index) == ref_save(rw.index)


def test_read_your_writes_and_microbatched_adds():
    from repro_torch.serve import BatchPolicy

    x, extra, q = _ingest_data()
    _, port = both("IVF8,ids=roc", x)
    plan = plan_shards(port, 2, by="hash")
    svc = ShardedAnnService(plan, topk=10, device="cpu",
                            policy=BatchPolicy(max_batch=1 << 30,
                                               max_wait_s=float("inf")))
    with svc:
        t1 = svc.submit_add(extra[:10])
        t2 = svc.submit_add(extra[10:30])
        assert not t1.done and svc.pending_adds() == 30
        svc.flush_adds()
        assert t1.done and t2.done and t2.ids[-1] == len(x) + 29
        svc.submit_add(extra[30:40])
        svc.search(q)                            # applies the pending add
        assert plan.n == len(x) + 40 and svc.pending_adds() == 0
        assert all(w.index.ivf.n_epochs == 3 for w in svc._workers)


def test_sharded_ingest_needs_plan():
    x, _, _ = _ingest_data()
    _, port = both("IVF8,ids=roc", x)
    shards = plan_shards(port, 2, by="range").indexes
    with ShardedAnnService(shards, topk=5, device="cpu") as svc:
        with pytest.raises(ValueError, match="ShardPlan"):
            svc.submit_add(x[:3])


# ---------------------------------------------------------------------------
# plan files, both directions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key", ["wt", "pq_polya", "flat", "nsg"])
def test_plan_save_load_both_directions(tmp_path, key):
    ref, port = mono(key)
    q, opts = _queries(key), _opts(key)
    d0, i0, _ = port.search(q, k=K, **opts)
    pp, rp = plan_shards(port, 3), ref_plan(ref, 3)
    mpath = pp.save(tmp_path / "port")
    rp.save(tmp_path / "ref")
    assert mpath.name == "shards.json"
    for f in sorted((tmp_path / "ref").iterdir()):
        assert (tmp_path / "port" / f.name).read_bytes() == f.read_bytes()
    from_ref = ShardPlan.load(tmp_path / "ref", device="cpu")
    from_port = RefPlan.load(tmp_path / "port")
    assert from_ref.manifest() == rp.manifest()
    assert from_ref.source_spec == port.spec and from_ref.nshards == 3
    for a, b in zip(from_ref.indexes, pp.indexes, strict=True):
        assert a.device == torch.device("cpu")
        assert save_index(a) == save_index(b)
    with ShardedAnnService(from_ref, topk=K, device="cpu", **opts) as svc:
        _same(svc.search(q), (i0, d0))
    with ShardedAnnService(str(tmp_path / "ref"), topk=K, device="cpu",
                           **opts) as svc:
        assert svc.plan.n == rp.n
        _same(svc.search(q), (i0, d0))
    ref_opts = dict(opts, engine="xla") if key in IVF_KEYS else opts
    with RefService(from_port, topk=K, **ref_opts) as rsvc:
        _same(rsvc.search(q), (i0, d0))


def test_manifest_contents_and_bad_manifests(tmp_path):
    _, port = mono("roc")
    plan = plan_shards(port, 4)
    m = plan.manifest()
    assert m["format"] == "ridx-shards" and m["version"] == 1
    assert m["kind"] == "ivf" and m["by"] == "range" and m["nshards"] == 4
    assert sum(s["n_local"] for s in m["shards"]) == len(X)
    seen = np.zeros(len(X), bool)
    for idx in plan.indexes:
        held = np.concatenate([lst for lst in idx.ivf._lists if len(lst)])
        assert not seen[held].any()
        seen[held] = True
    assert seen.all()
    mpath = plan.save(tmp_path)
    text = mpath.read_text()
    mpath.write_text(text.replace('"ridx-shards"', '"other"'))
    with pytest.raises(ValueError, match="not a ridx-shards manifest"):
        ShardPlan.load(tmp_path, device="cpu")
    mpath.write_text(text.replace('"version": 1', '"version": 9'))
    with pytest.raises(ValueError, match="unsupported shard-manifest"):
        ShardPlan.load(mpath, device="cpu")


# ---------------------------------------------------------------------------
# faults and degraded mode
# ---------------------------------------------------------------------------

def test_dead_shard_degrades_to_partial():
    ref, port = mono("roc")
    pp = plan_shards(port, 3)
    with ShardedAnnService(pp, topk=K, device="cpu", nprobe=NPROBE,
                           fault_policy=ScriptedFaults(dead=[1]),
                           retry=RetryPolicy(**NO_SLEEP)) as svc:
        ids, dists, st = svc.search(Q, with_stats=True)   # must not raise
        stats = svc.stats()
    assert st.partial is True and st.shards_failed == 1 and st.shards == 3
    assert np.isfinite(dists[:, 0]).all()
    dead = np.concatenate([lst for lst in pp.indexes[1].ivf._lists
                           if len(lst)])
    assert not np.isin(ids[np.isfinite(dists)], dead).any()
    assert stats["partial_batches"] == 1.0 and stats["shards_failed"] == 1.0
    assert len(svc.fault_log) == 1 and "ShardDead" in svc.fault_log[0][2]
    with RefService(ref_plan(ref, 3), topk=K, nprobe=NPROBE, engine="xla",
                    fault_policy=RefFaults(dead=[1]),
                    retry=RefRetry(**NO_SLEEP)) as rsvc:
        _same(rsvc.search(Q), (ids, dists))


def test_all_shards_dead_still_no_crash():
    _, port = mono("roc")
    with ShardedAnnService(plan_shards(port, 2), topk=K, device="cpu",
                           nprobe=NPROBE,
                           fault_policy=ScriptedFaults(dead=[0, 1]),
                           retry=RetryPolicy(**NO_SLEEP)) as svc:
        ids, dists, st = svc.search(Q, with_stats=True)
    assert st.partial is True and st.shards_failed == 2
    assert np.isinf(dists).all() and (ids == 0).all()


def test_flaky_shard_retry_recovers_full_results():
    _, port = mono("roc")
    d0, i0, _ = port.search(Q, k=K, nprobe=NPROBE)
    faults = ScriptedFaults(flaky={0: 1, 2: 1})
    with ShardedAnnService(plan_shards(port, 3), topk=K, device="cpu",
                           nprobe=NPROBE, fault_policy=faults,
                           retry=RetryPolicy(max_attempts=3,
                                             **NO_SLEEP)) as svc:
        ids, dists, st = svc.search(Q, with_stats=True)
    assert st.partial is False and st.shards_failed == 0 and st.retries == 2
    assert faults.injected == 2 and svc.stats()["retries"] == 2.0
    _same((ids, dists), (i0, d0))


def test_retries_exhausted_degrades():
    _, port = mono("roc")
    slept = []
    with ShardedAnnService(plan_shards(port, 2), topk=K, device="cpu",
                           nprobe=NPROBE,
                           fault_policy=ScriptedFaults(flaky={0: 99}),
                           retry=RetryPolicy(max_attempts=3,
                                             sleep=slept.append)) as svc:
        _, _, st = svc.search(Q, with_stats=True)
    assert st.partial is True and st.shards_failed == 1
    assert len(svc.fault_log) == 1 and "ShardTimeout" in svc.fault_log[0][2]
    assert slept == [0.005, 0.01]               # backoff between attempts


def test_deadline_drops_slow_shard():
    _, port = mono("roc")
    with ShardedAnnService(plan_shards(port, 3), topk=K, device="cpu",
                           nprobe=NPROBE, deadline_s=0.05,
                           fault_policy=ScriptedFaults(delay_s={2: 1.0}),
                           retry=RetryPolicy(max_attempts=1)) as svc:
        _, _, st = svc.search(Q, with_stats=True)
    assert st.partial is True and st.shards_failed == 1


def test_random_faults_are_seeded():
    from repro_torch.shard import RandomFaults

    _, port = mono("roc")
    runs = []
    for _ in range(2):
        faults = RandomFaults(0.5, seed=3)
        with ShardedAnnService(plan_shards(port, 3), topk=K, device="cpu",
                               nprobe=NPROBE, fault_policy=faults,
                               retry=RetryPolicy(**NO_SLEEP)) as svc:
            for i in range(4):
                svc.search(Q[i:i + 2])
            runs.append((faults.injected, svc.stats()["shards_failed"]))
    assert runs[0] == runs[1] and runs[0][0] > 0
    with pytest.raises(ValueError):
        RandomFaults(1.5)


def test_random_faults_do_not_depend_on_call_order():
    """Each (batch, shard, attempt) draws from its own seeded stream, so the
    router's threads may reach the hook in any order."""
    from repro_torch.shard import RandomFaults, ShardTimeout

    calls = [(s, a, b) for b in range(6) for s in range(4) for a in range(2)]

    def failed(order):
        faults, out = RandomFaults(0.5, seed=3), set()
        for s, a, b in order:
            try:
                faults.on_attempt(s, a, b)
            except ShardTimeout:
                out.add((s, a, b))
        return out, faults.injected

    first = failed(calls)
    assert 0 < first[1] < len(calls)
    assert failed(calls[::-1]) == first


class _Boom(FaultPolicy):
    def on_attempt(self, shard_id, attempt, batch_id):
        if shard_id == 1:
            raise RuntimeError("a bug, not a shard fault")


def test_non_fault_exception_propagates():
    """Only the shard fault taxonomy degrades; a programming error inside a
    worker reaches the caller."""
    _, port = mono("roc")
    with ShardedAnnService(plan_shards(port, 3), topk=K, device="cpu",
                           nprobe=NPROBE, fault_policy=_Boom(),
                           retry=RetryPolicy(**NO_SLEEP)) as svc:
        with pytest.raises(RuntimeError, match="a bug"):
            svc.search(Q)


# ---------------------------------------------------------------------------
# the device
# ---------------------------------------------------------------------------

def test_default_device_is_the_card(tmp_path):
    """``ShardPlan.load`` and ``ShardedAnnService`` default to the card:
    without one they raise; a CPU plan served on another device raises;
    the CPU path launches no kernel."""
    _, port = mono("roc")
    plan = plan_shards(port, 2)
    plan.save(tmp_path)
    if torch.cuda.is_available():
        loaded = ShardPlan.load(tmp_path)
        assert all(i.device.type == "cuda" for i in loaded.indexes)
        with pytest.raises(ValueError, match="index on cpu"):
            ShardedAnnService(plan, topk=K, nprobe=NPROBE)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardPlan.load(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedAnnService(plan, topk=K, nprobe=NPROBE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedAnnService(str(tmp_path), topk=K, nprobe=NPROBE)
    before = launch_counts()
    with ShardedAnnService(plan, topk=K, device="cpu", nprobe=NPROBE) as svc:
        svc.search(Q)
    assert launch_counts() == before
