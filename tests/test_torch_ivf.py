"""The port's main path as a whole against the reference (CPU).

A reference ``repro.ann.ivf.IVFIndex`` is built, exported to plain numpy
arrays and carried into the port with ``IVFIndex.from_arrays``
(``device="cpu"``).  Then, bit for bit:

* id blobs and Pólya code blobs are byte-equal to the reference's;
* ``search`` ids, dists and merge keys equal the reference's
  ``search(engine="xla")`` and ``search_ref`` for ids in {roc, ef,
  gap_ans, wt, wt1} x flat/PQ8 x select {host, device} x query_block
  {1, 7, 64}, with equal ``ndis``;
* the port's own ``build`` (given the reference centroids and codebooks,
  and from scratch) gives the same assignment, codes and results;
* ``add``/``compact`` sequences stay equal to the reference's;
* ``AnnService`` tickets equal the reference service's.

Also the device and engine rules, the factory, and an import guard: the
port imports neither ``jax`` nor ``repro``.
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_blobs import canon, flat_arrays
from repro.ann.ivf import IVFIndex as RefIVF
from repro.ann.pq import ProductQuantizer as RefPQ
from repro.api import index_factory as ref_factory
from repro.serve.ann_service import AnnService as RefService
from repro.serve.ann_service import BatchPolicy as RefPolicy
from repro_torch.ann.ivf import IVFIndex
from repro_torch.ann.pq import ProductQuantizer
from repro_torch.api import FlatIndex, IVFApiIndex, index_factory
from repro_torch.serve import AnnService, BatchPolicy

jax.config.update("jax_platforms", "cpu")

ROOT = Path(__file__).resolve().parents[1]
IDS = ["roc", "ef", "gap_ans", "wt", "wt1"]
PAYLOADS = ["flat", "pq8"]
NPROBE, TOPK = 6, 10


def _data(n=2000, d=32, nq=25, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    base[7] = base[3]                        # duplicate rows: tie stress
    queries[0] = base[3]
    return base, queries


DATA = _data()


def export(ref) -> dict:
    """The reference index as plain arrays: an IVF index as
    ``IVFIndex.from_arrays`` takes them, a Flat index as its ``vecs`` and
    ``id_map``."""
    if not isinstance(ref, RefIVF):
        return flat_arrays(ref)
    out = dict(centroids=ref.centroids, offsets=ref.offsets, sizes=ref.sizes,
               lists=[np.asarray(x) for x in ref._lists], n=ref.n, d=ref.d)
    if ref.pq is not None:
        out.update(codes=ref.codes, codebooks=ref.pq.codebooks)
    else:
        out.update(vecs=ref.vecs)
    return out


_REFS = {}


def reference(ids: str, payload: str) -> RefIVF:
    """Reference index; one k-means/PQ training per payload, shared by the
    id codecs (built with the trained centroids and codebooks)."""
    key = (ids, payload)
    if key not in _REFS:
        base, _ = DATA
        nlist = 24 if payload == "flat" else 16
        if ("roc", payload) not in _REFS:
            pq = RefPQ(m=8, bits=8) if payload == "pq8" else None
            _REFS[("roc", payload)] = RefIVF(
                nlist=nlist, id_codec="roc", pq=pq,
                code_codec="polya" if pq else None).build(base, seed=1)
        first = _REFS[("roc", payload)]
        pq = (RefPQ(m=8, bits=8, codebooks=first.pq.codebooks)
              if payload == "pq8" else None)
        _REFS[key] = RefIVF(nlist=nlist, id_codec=ids, pq=pq,
                            code_codec="polya" if pq else None).build(
                                base, centroids=first.centroids)
    return _REFS[key]


def carried_flat(ref, device="cpu") -> FlatIndex:
    """The port's Flat index carried from a reference Flat index."""
    arrays = export(ref)
    port = index_factory(arrays["spec"], device=device).build(arrays["vecs"])
    port.id_map = arrays["id_map"]
    return port


def carried(ids: str, payload: str, **fields) -> IVFIndex:
    ref = reference(ids, payload)
    return IVFIndex.from_arrays(
        export(ref), id_codec=ids, pq_m=8 if payload == "pq8" else 0,
        code_codec=ref.code_codec, device="cpu", **fields)


_EXPECTED = {}
_CARRIED = {}


def carried_once(ids: str, payload: str) -> IVFIndex:
    """One carried index per combination for the read-only search tests
    (results do not depend on the decode cache's state)."""
    if (ids, payload) not in _CARRIED:
        _CARRIED[(ids, payload)] = carried(ids, payload)
    return _CARRIED[(ids, payload)]


def expected(ids: str, payload: str):
    """(reference search, reference search_ref) results, computed once."""
    key = (ids, payload)
    if key not in _EXPECTED:
        ref = reference(ids, payload)
        _, queries = DATA
        _EXPECTED[key] = (
            ref.search(queries, nprobe=NPROBE, topk=TOPK, engine="xla",
                       with_keys=True),
            ref.search_ref(queries, nprobe=NPROBE, topk=TOPK))
    return _EXPECTED[key]


def _epoch_blobs(idx):
    return [canon(ep.blobs if ep.blobs is not None else ep.wt)
            for ep in idx._ids.epochs]


# ---------------------------------------------------------------------------
# carry-across and search parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("ids", IDS)
def test_from_arrays_blobs_byte_equal(ids, payload):
    ref = reference(ids, payload)
    port = carried(ids, payload)
    assert _epoch_blobs(port) == _epoch_blobs(ref)
    assert port.id_bits() == ref.id_bits()
    if payload == "pq8":
        assert canon(port._code_blobs) == canon(ref._code_blobs)
        assert port.code_bits_per_element() == ref.code_bits_per_element()
    np.testing.assert_array_equal(port.cluster_of, ref.cluster_of)


@pytest.mark.parametrize("query_block", [1, 7, 64])
@pytest.mark.parametrize("select", ["host", "device"])
@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("ids", IDS)
def test_search_parity(ids, payload, select, query_block):
    (ids_r, d_r, st_r), (ids_o, d_o, st_o) = expected(ids, payload)
    _, queries = DATA
    port = carried_once(ids, payload)
    got_ids, got_d, st = port.search(queries, nprobe=NPROBE, topk=TOPK,
                                     select=select, query_block=query_block,
                                     with_keys=True)
    for want_ids, want_d in ((ids_r, d_r), (ids_o, d_o)):
        np.testing.assert_array_equal(got_ids, want_ids)
        np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(st.merge_keys, st_r.merge_keys)
    assert st.ndis == st_r.ndis == st_o.ndis
    assert st.engine == "xla"
    assert st.device_select == (st.batches if select == "device" else 0)
    np.testing.assert_array_equal(port.search_ref(queries, NPROBE, TOPK)[0],
                                  ids_o)


@pytest.mark.parametrize("ids", ["roc", "wt1"])
def test_clusters_smaller_than_topk_and_nprobe_past_nlist(ids):
    base, queries = _data(n=60, d=16, nq=10, seed=3)
    ref = RefIVF(nlist=16, id_codec=ids).build(base, seed=3)
    port = IVFIndex.from_arrays(export(ref), id_codec=ids, device="cpu")
    for nprobe in (2, 50):
        want = ref.search_ref(queries, nprobe=nprobe, topk=9)
        for select in ("host", "device"):
            got = port.search(queries, nprobe=nprobe, topk=9, select=select)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# build / ingest parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", PAYLOADS)
def test_build_with_reference_centroids(payload):
    ref = reference("roc", payload)
    base, queries = DATA
    pq = (ProductQuantizer(m=8, bits=8, codebooks=ref.pq.codebooks)
          if payload == "pq8" else None)
    port = IVFIndex(nlist=ref.nlist, id_codec="roc", pq=pq,
                    code_codec=ref.code_codec, device="cpu").build(
                        base, centroids=ref.centroids)
    np.testing.assert_array_equal(port.cluster_of, ref.cluster_of)
    np.testing.assert_array_equal(port.offsets, ref.offsets)
    if payload == "pq8":
        np.testing.assert_array_equal(port.codes, ref.codes)
    assert _epoch_blobs(port) == _epoch_blobs(ref)
    got = port.search(queries, nprobe=NPROBE, topk=TOPK)
    want = expected("roc", payload)[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("spec", ["IVF16,ids=roc",
                                  "IVF8,PQ4x8,ids=ef,codes=polya"])
def test_factory_build_from_scratch_matches(spec):
    """The port's own k-means and PQ training start from the reference's
    seeded picks and reach the same index on this data."""
    base, queries = DATA
    ref = ref_factory(spec).build(base, seed=1)
    port = index_factory(spec, device="cpu").build(base, seed=1)
    assert port.spec == ref.spec == spec
    np.testing.assert_allclose(port.ivf.centroids, ref.ivf.centroids,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.ivf.cluster_of, ref.ivf.cluster_of)
    d_r, i_r, _ = ref.search(queries, k=TOPK, nprobe=4)
    d_p, i_p, _ = port.search(queries, k=TOPK, nprobe=4)
    np.testing.assert_array_equal(i_p, i_r)
    np.testing.assert_array_equal(d_p, d_r)
    assert port.memory_ledger() == ref.memory_ledger()


@pytest.mark.parametrize("n,k,d", [(2000, 24, 32), (3000, 256, 4),
                                   (500, 64, 8)])
def test_kmeans_matches_reference(n, k, d):
    """The port's k-means on the CPU against the reference's, and its
    fixed-order centroid sums against ``np.add.at`` (bitwise), empty
    clusters included."""
    from repro.ann.kmeans import kmeans as ref_kmeans
    from repro_torch.ann.kmeans import _cluster_sums, kmeans

    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[n // 2:] = x[: n - n // 2]             # duplicates: clusters go empty
    got = kmeans(x, k, iters=6, seed=3, device="cpu")
    np.testing.assert_allclose(got, ref_kmeans(x, k, iters=6, seed=3),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got, kmeans(x, k, iters=6, seed=3,
                                              device="cpu"))
    a = rng.integers(0, k, n)
    a[a == 1] = 0                            # cluster 1 is empty
    want = np.zeros((k, d), np.float32)
    np.add.at(want, a, x)
    at = torch.from_numpy(a)
    sums = _cluster_sums(torch.from_numpy(x), at,
                         torch.bincount(at, minlength=k))
    np.testing.assert_array_equal(sums.numpy(), want)


@pytest.mark.parametrize("payload", PAYLOADS)
@pytest.mark.parametrize("ids", ["roc", "wt"])
def test_add_and_compact_match_reference(ids, payload):
    base, queries = DATA
    extra = np.random.default_rng(9).standard_normal(
        (150, base.shape[1])).astype(np.float32)
    ref0 = reference(ids, payload)
    pq = (RefPQ(m=8, bits=8, codebooks=ref0.pq.codebooks)
          if payload == "pq8" else None)
    ref = RefIVF(nlist=ref0.nlist, id_codec=ids, pq=pq,
                 code_codec=ref0.code_codec).build(
                     base, centroids=ref0.centroids)
    port = carried(ids, payload)
    for chunk in (extra[:100], extra[100:]):
        ref.add(chunk)
        port.add(chunk)
    assert port.n_epochs == ref.n_epochs == 3
    assert _epoch_blobs(port) == _epoch_blobs(ref)
    if payload == "pq8":
        assert canon(port._code_blobs) == canon(ref._code_blobs)
    for stage in ("epochs", "compacted"):
        want = ref.search_ref(queries, NPROBE, TOPK)
        got = port.search(queries, NPROBE, TOPK, select="device")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        if stage == "epochs":
            ref.compact()
            port.compact()
            assert _epoch_blobs(port) == _epoch_blobs(ref)


# ---------------------------------------------------------------------------
# serving parity
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("payload", PAYLOADS)
def test_ann_service_tickets_match_reference(payload):
    _, queries = DATA
    ref_svc = RefService(reference("roc", payload), topk=TOPK,
                         policy=RefPolicy(max_batch=8, max_wait_s=0.5),
                         clock=_Clock(), nprobe=NPROBE, engine="xla")
    port_clock = _Clock()
    port_svc = AnnService(carried("roc", payload), topk=TOPK,
                          policy=BatchPolicy(max_batch=8, max_wait_s=0.5),
                          clock=port_clock, device="cpu", nprobe=NPROBE,
                          select="device")
    ref_clock = ref_svc.clock
    sizes = [1, 3, 4, 2, 7, 1, 1, 5, 1]
    ref_t, port_t, row = [], [], 0
    for i, s in enumerate(sizes):
        ref_clock.t = port_clock.t = 0.1 * i
        ref_t.append(ref_svc.submit(queries[row:row + s]))
        port_t.append(port_svc.submit(queries[row:row + s]))
        row += s
    ref_svc.flush()
    port_svc.flush()
    for a, b in zip(ref_t, port_t):
        assert b.done and a.done
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
        assert (b.batch_id, b.batch_size, b.wait_s) == \
            (a.batch_id, a.batch_size, a.wait_s)
    s_ref, s_port = ref_svc.stats(), port_svc.stats()
    assert s_port.keys() == s_ref.keys()
    for key in ("requests", "queries", "batches", "ndis", "mean_batch",
                "max_batch", "mean_wait_s"):
        assert s_port[key] == s_ref[key], key
    assert port_svc.memory_ledger() == ref_svc.memory_ledger()


def test_ann_service_ingest_matches_reference():
    base, queries = DATA
    extra = np.random.default_rng(4).standard_normal((30, 32)).astype(
        np.float32)
    ref0 = reference("roc", "flat")
    ref_svc = RefService(RefIVF(nlist=ref0.nlist).build(
        base, centroids=ref0.centroids), topk=TOPK,
        policy=RefPolicy(max_batch=16), nprobe=NPROBE, engine="xla")
    port_svc = AnnService(carried("roc", "flat"), topk=TOPK,
                          policy=BatchPolicy(max_batch=16), device="cpu",
                          nprobe=NPROBE)
    for svc in (ref_svc, port_svc):
        for i in range(0, 30, 10):
            svc.submit_add(extra[i:i + 10])
    a = ref_svc.search(np.concatenate([queries[:3], extra[:2]]))
    b = port_svc.search(np.concatenate([queries[:3], extra[:2]]))
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    assert port_svc.stats()["add_batches"] == ref_svc.stats()["add_batches"]


# ---------------------------------------------------------------------------
# device / engine rules, factory, import guard
# ---------------------------------------------------------------------------

def test_engine_rules_on_a_cpu_index():
    _, queries = DATA
    port = carried("roc", "flat")
    with pytest.raises(ValueError, match="pallas"):
        port.search(queries, engine="pallas")
    with pytest.raises(ValueError, match="scan engine"):
        port.search(queries, engine="tpu")
    for engine in ("auto", "xla"):
        assert port.search(queries[:2], engine=engine)[2].engine == "xla"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFIndex(nlist=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_factory("IVF4,ids=roc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnnService(IVFApiIndex.from_built(carried("roc", "flat")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        IVFIndex.from_arrays(export(reference("roc", "flat")), id_codec="roc")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        index_factory("Flat")
    from repro_torch.api import load_index, save_index

    blob = save_index(carried("roc", "flat"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_index(blob)


@pytest.mark.parametrize("id_map", [False, True])
def test_flat_carried_from_arrays(id_map):
    base, queries = DATA
    ref = ref_factory("Flat").build(base)
    if id_map:
        ref.id_map = np.arange(0, 3 * len(base), 3, dtype=np.int64)
    port = carried_flat(ref)
    assert flat_arrays(port).keys() == export(ref).keys()
    np.testing.assert_array_equal(port.vecs, ref.vecs)
    for engine in (None, "xla"):
        got = port.search(queries, k=TOPK, engine=engine)
        want = ref.search(queries, k=TOPK)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("spec", ["NSG16,ids=roc", "HNSW8,ids=ef"])
def test_unported_structures_raise(spec):
    """Graph specs were the last unported structures; they now build the
    reference's adjacency (``tests/test_torch_graph.py`` holds the rest)."""
    from repro_torch.api import GraphApiIndex

    base = np.random.default_rng(3).standard_normal((300, 16)).astype(
        np.float32)
    port = index_factory(spec, device="cpu")
    assert isinstance(port, GraphApiIndex) and port.spec == spec
    ref = ref_factory(spec).build(base)
    port.build(base)
    for a, b in zip(port.graph.adj_raw, ref.graph.adj_raw):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("spec", [
    "IVF64,ids=roc", "IVF1024,PQ8x8,ids=roc,codes=polya",
    "IVF16,ids=wt1,cache_mb=8,cache_policy=2q,max_epochs=3,engine=xla",
    "ids=ef,IVF8", "IVF8,PQ4,ids=bogus", "IVF8,codes=polya", "Flat,ids=roc",
    "NSG12,ids=wt", "IVF8,engine=cuda", "IVF8,ids=roc,ids=ef"])
def test_spec_grammar_matches_reference(spec):
    from repro.api.spec import parse_spec as ref_parse
    from repro_torch.api import parse_spec

    try:
        want = str(ref_parse(spec))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert str(parse_spec(spec)) == want


def test_unsupported_devices_raise():
    with pytest.raises(ValueError, match="unsupported device"):
        AnnService(carried("roc", "flat"), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        index_factory("IVF4,ids=roc", device="mps")


IMPORT_GUARD = r"""
import sys
import numpy as np
import repro_torch
import repro_torch.ann.ivf, repro_torch.ann.scan, repro_torch.ann.kmeans
import repro_torch.ann.graph, repro_torch.ann.graph_scan, repro_torch.ann.npsum
import repro_torch.api, repro_torch.serve, repro_torch.core, repro_torch.data
import repro_torch.kernels, repro_torch.kernels._build
import repro_torch.kernels.l2_topk, repro_torch.kernels.wt_rank
import repro_torch.kernels.rans_decode
import repro_torch.api.container, repro_torch.core.container
import repro_torch.shard, repro_torch.shard.faults, repro_torch.shard.plan
import repro_torch.shard.service
import torch
from repro_torch.api import index_factory, load_index, save_index
from repro_torch.kernels import (l2_top1, make_tables, pack_bits_u32,
                                 rans_decode, wt_rank)
from repro_torch.serve import AnnService
rng = np.random.default_rng(0)
x = rng.standard_normal((300, 16)).astype(np.float32)
idx = index_factory("IVF4,PQ4x8,ids=roc,codes=polya", device="cpu").build(x)
svc = AnnService(idx, topk=3, device="cpu", nprobe=2)
svc.add(x[:5])
ids, dists = svc.search(x[:2])
assert ids.shape == (2, 3) and ids[0, 0] == 0, ids
back = load_index(save_index(idx), device="cpu")
assert np.array_equal(back.search(x[:2], k=3, nprobe=2)[1], ids)
flat = index_factory("Flat", device="cpu").build(x)
for engine in (None, "xla"):
    assert flat.search(x[:2], k=3, engine=engine)[1][1, 0] == 1
fsvc = AnnService(load_index(save_index(flat), device="cpu"), topk=3,
                  device="cpu", engine="auto")
assert fsvc.search(x[4:5])[0][0, 0] == 4
g = index_factory("HNSW6,ids=roc", device="cpu").build(x)
g.add(x[:3] + 1.0)
gsvc = AnnService(load_index(save_index(g, graph_codec="rec"), device="cpu"),
                  topk=3, device="cpu", ef=8, kernel_min=1)
assert gsvc.search(x[7:8])[0][0, 0] == 7
from repro_torch.shard import ScriptedFaults, ShardedAnnService, plan_shards
with ShardedAnnService(plan_shards(idx, 2, by="hash"), topk=3, device="cpu",
                       nprobe=2) as ssvc:
    assert np.array_equal(ssvc.search(x[:2])[0], ids)
    ssvc.add(x[5:9])
with ShardedAnnService(plan_shards(flat, 2), topk=3, device="cpu",
                       fault_policy=ScriptedFaults(dead=[1])) as fsh:
    assert fsh.search(x[:2], with_stats=True)[2].partial
assert l2_top1(torch.from_numpy(x), torch.from_numpy(x[:3]))[0][2] == 2
words, sup = pack_bits_u32(np.ones(40, np.uint8))
assert wt_rank(torch.from_numpy(words.view(np.int32)), torch.from_numpy(sup),
               torch.tensor([40], dtype=torch.int32)).item() == 40
tabs = [torch.from_numpy(t) for t in make_tables(np.array([2, 2]), 2)]
assert rans_decode(torch.full((3,), 1 << 16, dtype=torch.int32),
                   torch.zeros(0, dtype=torch.int32), *tabs, 2, 2).shape == (2, 3)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_import_guard_subprocess():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", IMPORT_GUARD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


@pytest.mark.parametrize("pkg", ["repro_torch.api", "repro_torch.serve",
                                 "repro_torch.kernels", "repro_torch.core",
                                 "repro_torch.api.container",
                                 "repro_torch.core.container",
                                 "repro_torch.shard"])
def test_public_surface_documented(pkg):
    import importlib
    import inspect

    mod = importlib.import_module(pkg)
    assert mod.__doc__ and mod.__all__
    missing = [name for name in mod.__all__
               if not (inspect.getdoc(getattr(mod, name)) or "").strip()]
    assert not missing, missing
