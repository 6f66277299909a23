"""The RIDX container of the port (``repro_torch.api.container``) against
the reference's (``repro.api.container``), on the CPU.

Indexes of both packages are built from the same data with shared
centroids and PQ codebooks (carried across as numpy arrays).  Then, for
every id codec x payload in {flat, PQ8x8, PQ8x8 + Pólya}, and for Flat
with and without an ``id_map``:

* the port's ``pack_index`` bytes equal the reference's;
* the port loads the reference's blob and the reference loads the
  port's, and search after reload equals search before, ids and dists;
* ``id_bits``, bits per id and the epoch table round-trip, also after
  two ``add`` epochs;
* spec options survive, files work, v2 and v1 blobs load, garbage is
  rejected, and a graph blob (the item ROADMAP named for it, graph
  indexes, now ported) loads with search equal to the reference's; the
  graph sections in full are in ``tests/test_torch_graph_container.py``.

The joint id streams are packed by halving
(``repro_torch.core.container.pack_joint_ids``): its bytes equal the sequential coder's
for random cluster lists, every leaf size included.
"""

import numpy as np
import pytest

import jax

from repro.ann.kmeans import kmeans as ref_kmeans
from repro.ann.pq import ProductQuantizer as RefPQ
from repro.api import index_factory as ref_factory
from repro.api import load_index as ref_load
from repro.api import save_index as ref_save
from repro_torch.api import index_factory, load_index, save_index
from repro_torch.api.container import RIDX_MAGIC, unpack_index

jax.config.update("jax_platforms", "cpu")

ALL_ID_CODECS = ["unc64", "unc32", "compact", "ef", "roc", "gap_ans",
                 "wt", "wt1"]
PAYLOADS = ["", ",PQ8x8", ",PQ8x8+polya"]
NLIST, D, K, NPROBE = 12, 32, 7, 5


def _data():
    rng = np.random.default_rng(7)
    base = rng.standard_normal((900, D)).astype(np.float32)
    base[17] = base[3]                       # a duplicate row
    queries = rng.standard_normal((12, D)).astype(np.float32)
    queries[0] = base[3]
    extra = rng.standard_normal((80, D)).astype(np.float32)
    return base, queries, extra


BASE, QUERIES, EXTRA = _data()
_SHARED = {}


def shared():
    """Centroids and PQ codebooks trained once by the reference; both
    packages build with them (carried as numpy arrays)."""
    if not _SHARED:
        _SHARED["centroids"] = np.asarray(ref_kmeans(BASE, NLIST, iters=4,
                                                     seed=1))
        _SHARED["codebooks"] = RefPQ(m=8, bits=8).train(
            BASE, iters=3).codebooks
    return _SHARED


def _spec(codec, payload):
    return (f"IVF{NLIST}" + payload.replace("+polya", "") + f",ids={codec}"
            + (",codes=polya" if payload.endswith("+polya") else ""))


def _build(factory, spec, **kw):
    idx = factory(spec, **kw)
    if idx.ivf.pq is not None:
        idx.ivf.pq.codebooks = shared()["codebooks"].copy()
    return idx.build(BASE, seed=1, centroids=shared()["centroids"])


def both(spec):
    """(reference index, port index on the CPU) of one IVF spec."""
    return (_build(ref_factory, spec),
            _build(index_factory, spec, device="cpu"))


def _search(idx, **kw):
    d, i, _ = idx.search(QUERIES, k=K, **kw)
    return i, d


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])   # exact, not allclose


def _epochs(ivf):
    return [(int(ep.base), int(ep.count)) for ep in ivf._ids.epochs]


@pytest.mark.parametrize("codec", ALL_ID_CODECS)
@pytest.mark.parametrize("payload", PAYLOADS)
def test_ivf_matrix_bytes_and_both_directions(codec, payload):
    ref, port = both(_spec(codec, payload))
    blob_ref, blob_port = ref_save(ref), save_index(port)
    assert blob_port[:4] == RIDX_MAGIC
    assert blob_port == blob_ref
    want = _search(ref, nprobe=NPROBE, engine="xla")
    _assert_same(_search(port, nprobe=NPROBE), want)
    from_ref = load_index(blob_ref, device="cpu")
    from_port = ref_load(blob_port)
    assert from_ref.spec == from_port.spec == port.spec
    _assert_same(_search(from_ref, nprobe=NPROBE), want)
    _assert_same(_search(from_port, nprobe=NPROBE, engine="xla"), want)
    _assert_same(from_ref.ivf.search_ref(QUERIES, NPROBE, K)[:2],
                 ref.ivf.search_ref(QUERIES, NPROBE, K)[:2])
    assert from_ref.ivf.id_bits() == port.ivf.id_bits() == ref.ivf.id_bits()
    assert from_ref.ivf.bits_per_id() == ref.ivf.bits_per_id()
    assert _epochs(from_ref.ivf) == _epochs(ref.ivf) == [(0, len(BASE))]
    if payload.endswith("+polya"):
        assert (from_ref.ivf.code_bits_per_element()
                == ref.ivf.code_bits_per_element())
    assert from_ref.ivf.payload_dev is not None
    assert from_ref.memory_ledger() == ref.memory_ledger()


@pytest.mark.parametrize("spec", [f"IVF{NLIST},ids=roc", f"IVF{NLIST},ids=wt1",
                                  f"IVF{NLIST},PQ8x8,ids=ef,codes=polya"])
def test_ivf_after_two_add_epochs(spec, tmp_path):
    ref, port = both(spec)
    for idx in (ref, port):
        idx.add(EXTRA[:30])
        idx.add(EXTRA[30:60])
    blob = save_index(port, tmp_path / "i.ridx")
    assert blob == ref_save(ref)
    loaded = load_index(tmp_path / "i.ridx", device="cpu")
    assert loaded.ivf.n_epochs == ref.ivf.n_epochs == 3
    assert _epochs(loaded.ivf) == _epochs(ref.ivf)
    assert loaded.ivf.id_bits() == ref.ivf.id_bits()
    want = _search(ref, nprobe=NPROBE, engine="xla")
    _assert_same(_search(loaded, nprobe=NPROBE), want)
    _assert_same(_search(ref_load(blob), nprobe=NPROBE, engine="xla"), want)
    # add after load continues the epoch sequence losslessly
    ref.add(EXTRA[60:])
    loaded.add(EXTRA[60:])
    _assert_same(_search(loaded, nprobe=NPROBE),
                 _search(ref, nprobe=NPROBE, engine="xla"))
    assert save_index(loaded) == ref_save(ref)


@pytest.mark.parametrize("id_map", [False, True])
def test_flat_bytes_and_both_directions(id_map):
    ref = ref_factory("Flat").build(BASE)
    port = index_factory("Flat", device="cpu").build(BASE)
    if id_map:
        gids = np.sort(np.random.default_rng(3).choice(
            10 * len(BASE), len(BASE), replace=False)).astype(np.int64)
        ref.id_map, port.id_map = gids, gids.copy()
    blob = save_index(port)
    assert blob == ref_save(ref)
    want = _search(ref)
    for got in (load_index(blob, device="cpu"), load_index(ref_save(ref),
                                                           device="cpu")):
        assert got.spec == "Flat"
        np.testing.assert_array_equal(got.vecs, ref.vecs)
        _assert_same(_search(got), want)
        _assert_same(_search(got, engine="xla"), want)
    _assert_same(_search(ref_load(blob)), want)


def test_options_survive():
    spec = f"IVF{NLIST},ids=roc,cache_mb=2,cache_policy=2q,max_epochs=3"
    ref, port = both(spec)
    blob = save_index(port)
    assert blob == ref_save(ref)
    got = load_index(blob, device="cpu")
    assert got.spec == spec == ref_load(blob).spec
    assert got.ivf.decoded_cache.max_bytes == 2 << 20
    assert got.ivf.decoded_cache.policy == "2q"
    assert got.ivf.max_epochs == 3


def _v2_blob(ref):
    """A v2 blob (one implicit epoch, unnumbered sections) written with the
    reference's own section framing."""
    from repro.api.spec import parse_spec
    from repro.core.container import (SectionWriter, pack_joint_ids,
                                      pack_polya_sections)

    ivf = ref.ivf
    meta = {"spec": str(parse_spec(ref.spec)), "kind": "ivf",
            "n": int(ivf.n), "d": int(ivf.d), "nlist": int(ivf.nlist)}
    w = SectionWriter()
    w.add("sizes", ivf.sizes.astype(np.int64).tobytes())
    w.add("centroids", ivf.centroids.astype(np.float32).tobytes())
    w.add("ids", pack_joint_ids(ivf._lists, ivf.n))
    meta["pq"] = ({"m": ivf.pq.m, "bits": ivf.pq.bits} if ivf.pq else None)
    if ivf.pq is not None:
        w.add("pq_codebooks", ivf.pq.codebooks.astype(np.float32).tobytes())
    if ivf._code_blobs is not None:
        meta["code"] = pack_polya_sections(w, ivf._code_blobs[0])
    elif ivf.codes is not None:
        w.add("codes_raw", ivf.codes.tobytes())
        meta["code"] = {"m": int(ivf.codes.shape[1]), "raw": True}
    else:
        meta["code"] = None
        w.add("vecs", ivf.vecs.astype(np.float32).tobytes())
    return w.finish(b"RIDX", 2, meta)


@pytest.mark.parametrize("payload", PAYLOADS)
def test_v2_blob_loads(payload):
    ref, port = both(_spec("roc", payload))
    blob = _v2_blob(ref)
    want = _search(ref, nprobe=NPROBE, engine="xla")
    _assert_same(_search(ref_load(blob), nprobe=NPROBE, engine="xla"), want)
    got = load_index(blob, device="cpu")
    _assert_same(_search(got, nprobe=NPROBE), want)
    assert got.ivf.id_bits() == ref.ivf.id_bits()
    assert save_index(got) == ref_save(ref)   # rewritten as v3


def test_v1_rivf_blob_loads():
    """The legacy RIVF v1 blob: the reference's loads in the port, and the
    port's writer gives the same bytes."""
    from repro.core.container import pack_ivf as ref_pack_ivf
    from repro_torch.core.container import pack_ivf, unpack_ivf

    ref, port = both(f"IVF{NLIST},PQ8x8,ids=compact,codes=polya")
    blob = ref_pack_ivf(ref.ivf)
    assert pack_ivf(port.ivf) == blob
    manifest, lists, cents, codes = unpack_ivf(blob)
    assert manifest["n"] == len(BASE)
    for k in range(NLIST):
        np.testing.assert_array_equal(lists[k], ref.ivf._lists[k])
    np.testing.assert_array_equal(codes, ref.ivf.codes)
    np.testing.assert_array_equal(
        cents, ref.ivf.centroids.astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("raw", [b"NOPE" + b"\x00" * 64,
                                 b"RIDX" + np.uint32(9).tobytes()
                                 + np.uint32(2).tobytes() + b"{}"])
def test_garbage_is_rejected(raw):
    with pytest.raises(ValueError):
        unpack_index(raw, device="cpu")


def test_graph_blob_names_the_roadmap_item():
    """ROADMAP's graph-indexes item is done: the reference's graph blob
    loads, with search equal to the reference's."""
    from repro.ann.graph import build_nsg

    base = BASE[:120]
    ref = ref_factory("NSG8,ids=roc").build(base, adj=build_nsg(base, 8))
    got = load_index(ref_save(ref), device="cpu")
    assert got.spec == ref.spec
    want = ref.search(QUERIES, k=K)
    _assert_same(got.search(QUERIES, k=K), want)


def test_graph_edge_helpers_match_reference():
    """The graph sections' edge-list helpers, ported ahead of the graph
    slice: the same arrays as the reference's on a seeded adjacency."""
    from repro.api import container as ref_c
    from repro_torch.api import container as port_c

    rng = np.random.default_rng(11)
    adj = [np.sort(rng.choice(50, int(rng.integers(0, 6)), replace=False))
           for _ in range(50)] + [np.zeros(0, np.int64)]
    universes = np.repeat([40, 45, 51], [30, 10, 11])
    for got, want in zip(port_c._rle(universes), ref_c._rle(universes)):
        np.testing.assert_array_equal(got, want)
    edges = port_c._edge_list(adj)
    np.testing.assert_array_equal(edges, ref_c._edge_list(adj))
    for a, b, c in zip(port_c._group_edges(edges, 51),
                       ref_c._group_edges(edges, 51), adj):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert [len(x) for x in port_c._rle(np.zeros(0))] == [0, 0]


def _cluster_lists(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 4000))
    k = int(rng.integers(1, 60))
    perm = rng.permutation(n)[: int(rng.integers(0, n + 1))]
    cuts = np.sort(rng.integers(0, len(perm) + 1, k - 1))
    return [np.sort(x) for x in np.split(perm, cuts)], n


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("leaf_ids", [0, 1, 37, 512, 10 ** 9])
def test_joint_ids_by_halving_equal_the_sequential_coder(seed, leaf_ids,
                                                         monkeypatch):
    """The port's coder against the reference's one-op-at-a-time coder,
    from one cluster a leaf (0, 1) to the whole stream as one leaf (10^9,
    the port's coder then being the sequential one itself)."""
    from repro.core.container import pack_joint_ids, unpack_joint_ids
    import repro_torch.core.container as port_c

    monkeypatch.setattr(port_c, "LEAF_IDS", leaf_ids)
    lists, n = _cluster_lists(seed)
    sizes = [len(x) for x in lists]
    raw = pack_joint_ids(lists, n)
    assert port_c.pack_joint_ids(lists, n) == raw
    got = port_c.unpack_joint_ids(raw, sizes, n)
    for a, b in zip(got, unpack_joint_ids(raw, sizes, n)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
