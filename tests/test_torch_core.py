"""Host-side core of the port (``repro_torch.core``) against the reference.

The port carries its own copies of the numpy codecs; these tests hold
them byte-exact to ``repro.core``: for every id codec and the edge
universes of ``tests/test_codec_edges.py`` (plus random lists) the blobs
are byte-equal, each package decodes the other's blobs, and ``size_bits``
agrees.  Wavelet-tree select/bits and Pólya code blobs likewise, and
the graph coders of the RIDX container (REC under both vertex models,
webgraph-lite) and the REC decoder's ``SortedList`` on seeded
adjacencies.
"""

import numpy as np
import pytest

from _torch_blobs import canon, transplant
from repro.core import codecs as ref_codecs
from repro.core.epoch import EpochStore as RefEpochStore
from repro.core.polya import PolyaCodec as RefPolya
from repro.core.wavelet_tree import WaveletTree as RefWT
from repro_torch.core import codecs as port_codecs
from repro_torch.core.epoch import EpochStore
from repro_torch.core.polya import PolyaCodec
from repro_torch.core.wavelet_tree import WaveletTree

EDGE_CASES = [
    ("empty", np.zeros(0, np.int64), 100),
    ("single", np.array([7], np.int64), 100),
    ("single-last", np.array([99], np.int64), 100),
    ("full-universe", np.arange(50, dtype=np.int64), 50),
    ("universe-1", np.array([0], np.int64), 1),
    ("two-adjacent", np.array([41, 40], np.int64), 100),  # unsorted input
    ("random-37-of-1000", np.random.default_rng(6).choice(
        1000, 37, replace=False).astype(np.int64), 1000),
    ("random-900-of-1000", np.random.default_rng(7).choice(
        1000, 900, replace=False).astype(np.int64), 1000),
    ("random-600-of-1e6", np.random.default_rng(8).choice(
        10**6, 600, replace=False).astype(np.int64), 10**6),
]


def test_codec_registry_matches():
    assert port_codecs.CODEC_NAMES == ref_codecs.CODEC_NAMES


@pytest.mark.parametrize("name", ref_codecs.CODEC_NAMES)
@pytest.mark.parametrize("label,ids,universe", EDGE_CASES,
                         ids=[c[0] for c in EDGE_CASES])
def test_codec_blobs_byte_equal_and_cross_decode(name, label, ids, universe):
    ref = ref_codecs.get_codec(name)
    port = port_codecs.get_codec(name)
    b_ref = ref.encode(ids, universe)
    b_port = port.encode(ids, universe)
    assert canon(b_port) == canon(b_ref)
    assert port.size_bits(b_port) == ref.size_bits(b_ref)
    want = np.sort(ids)
    # each package decodes the other's blob with its own code
    np.testing.assert_array_equal(
        port.decode(transplant(b_ref, "repro_torch"), universe), want)
    np.testing.assert_array_equal(
        ref.decode(transplant(b_port, "repro"), universe), want)
    offs = np.arange(len(ids), dtype=np.int64)
    g_ref = ref.gather(b_ref, offs)
    g_port = port.gather(transplant(b_ref, "repro_torch"), offs)
    if g_ref is None:
        assert g_port is None
    else:
        np.testing.assert_array_equal(g_port, g_ref)


@pytest.mark.parametrize("compressed", [False, True], ids=["wt", "wt1"])
@pytest.mark.parametrize("n,nsyms", [(0, 4), (10, 1), (500, 7), (3000, 24)])
def test_wavelet_tree_select_and_bits(compressed, n, nsyms):
    s = np.random.default_rng(n + nsyms).integers(0, nsyms, n)
    ref = RefWT.build(s, nsyms, compressed=compressed)
    port = WaveletTree.build(s, nsyms, compressed=compressed)
    assert canon(port) == canon(ref)
    assert port.size_bits == ref.size_bits
    cross = transplant(ref, "repro_torch")
    for k in range(nsyms):
        size = ref.cluster_size(k)
        assert port.cluster_size(k) == size
        np.testing.assert_array_equal(cross.decode_cluster(k),
                                      ref.decode_cluster(k))
        occ = np.arange(size)
        np.testing.assert_array_equal(cross.select_batch([k] * size, occ),
                                      np.flatnonzero(s == k))


@pytest.mark.parametrize("m,sizes", [(8, [40, 0, 13, 200]), (4, [1]),
                                     (16, [300, 299])])
def test_polya_blobs_byte_equal(m, sizes):
    rng = np.random.default_rng(m)
    # concentrated codes (compressible) next to uniform ones
    clusters = [np.minimum(rng.geometric(0.05, (s, m)), 255).astype(np.uint8)
                if i % 2 else rng.integers(0, 256, (s, m)).astype(np.uint8)
                for i, s in enumerate(sizes)]
    b_ref = RefPolya().encode(clusters)
    b_port = PolyaCodec().encode(clusters)
    assert canon(b_port) == canon(b_ref)
    for got, want in zip(PolyaCodec().decode(b_ref), clusters):
        np.testing.assert_array_equal(got, want)
    assert PolyaCodec().bits_per_element(b_port) == \
        RefPolya().bits_per_element(b_ref)


@pytest.mark.parametrize("codec", ["roc", "ef", "gap_ans", "wt1"])
def test_epoch_store_resolve_matches(codec):
    """Two epochs, then compaction: blobs and resolved ids agree."""
    rng = np.random.default_rng(3)
    nlist, n0, n1 = 5, 300, 120
    lists0 = [np.sort(x) for x in np.array_split(rng.permutation(n0), nlist)]
    lists1 = [np.sort(x) for x in np.array_split(rng.permutation(n1), nlist)]
    ref, port = RefEpochStore(nlist, codec), EpochStore(nlist, codec)
    for st in (ref, port):
        st.append(lists0, 0, n0)
        st.append(lists1, n0, n1)
    for e in range(2):
        assert canon(port.epochs[e].blobs or port.epochs[e].wt) == \
            canon(ref.epochs[e].blobs or ref.epochs[e].wt)
    assert port.id_bits() == ref.id_bits()
    clusters = rng.integers(0, nlist, 50)
    sizes = np.array([len(a) + len(b) for a, b in zip(lists0, lists1)])
    offsets = rng.integers(0, sizes[clusters])
    from repro.ann.scan import DecodedListCache as RefCache
    from repro_torch.ann.scan import DecodedListCache

    np.testing.assert_array_equal(
        port.resolve(clusters, offsets, DecodedListCache()),
        ref.resolve(clusters, offsets, RefCache()))
    glob = [np.concatenate([a, b + n0]) for a, b in zip(lists0, lists1)]
    ref.compact(glob, n0 + n1)
    port.compact(glob, n0 + n1)
    assert canon(port.epochs[0].blobs or port.epochs[0].wt) == \
        canon(ref.epochs[0].blobs or ref.epochs[0].wt)


# ---------------------------------------------------------------------------
# graph coders and the sorted list (the RIDX container's graph sections)
# ---------------------------------------------------------------------------

def _adjacency(n, deg, seed):
    """A seeded directed graph: ``deg``-ish distinct out-neighbours a node
    (some nodes empty, some self-similar runs), sorted per node."""
    rng = np.random.default_rng(seed)
    adj = []
    for i in range(n):
        k = int(rng.integers(0, deg + 1)) if i % 7 else 0
        if i % 5 == 0 and adj and len(adj[-1]):
            nb = np.union1d(adj[-1], rng.choice(n, k, replace=False))[:deg]
        else:
            nb = rng.choice(n, k, replace=False)
        adj.append(np.sort(nb).astype(np.int64))
    return adj


def _edges(adj):
    src = np.concatenate([np.full(len(a), i, np.int64)
                          for i, a in enumerate(adj)])
    return np.stack([src, np.concatenate(adj)], axis=1)


@pytest.mark.parametrize("model", ["polya", "degree"])
@pytest.mark.parametrize("n,deg,seed", [(12, 3, 5), (40, 4, 1), (300, 12, 2)])
def test_rec_blobs_byte_equal_and_cross_decode(model, n, deg, seed):
    from repro.core.rec import rec_decode as ref_decode
    from repro.core.rec import rec_encode as ref_encode
    from repro_torch.core import rec_decode, rec_encode

    edges = _edges(_adjacency(n, deg, seed))
    r_ref = ref_encode(edges, n, model=model)
    r_port = rec_encode(edges, n, model=model)
    assert canon(r_port) == canon(r_ref)
    assert r_port.total_bits == r_ref.total_bits
    want = edges[np.lexsort((edges[:, 1], edges[:, 0]))]
    e = len(edges)
    np.testing.assert_array_equal(
        rec_decode(transplant(r_ref, "repro_torch"), n, e), want)
    np.testing.assert_array_equal(
        ref_decode(transplant(r_port, "repro"), n, e), want)


@pytest.mark.parametrize("n,deg,seed", [(1, 0, 0), (50, 6, 3), (400, 16, 4)])
def test_webgraph_blobs_byte_equal_and_cross_decode(n, deg, seed):
    from repro.core.webgraph_lite import webgraph_decode as ref_decode
    from repro.core.webgraph_lite import webgraph_encode as ref_encode
    from repro_torch.core.ans import StreamANS
    from repro_torch.core.webgraph_lite import (webgraph_decode,
                                                webgraph_encode)

    adj = _adjacency(n, deg, seed)
    a_ref, a_port = ref_encode(adj, n), webgraph_encode(adj, n)
    assert a_port.tobytes() == a_ref.tobytes()
    got = webgraph_decode(StreamANS.frombytes(*a_ref.tobytes()), n, n)
    back = ref_decode(transplant(a_port, "repro"), n, n)
    for a, g, b in zip(adj, got, back):
        np.testing.assert_array_equal(g, a)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n,seed", [(0, 0), (5000, 1), (3000, 2)])
def test_sorted_list_matches_reference(n, seed):
    """Rank-insert: every returned rank and the final order equal the
    reference's, across block splits (duplicates included)."""
    from repro.core.sortedlist import SortedList as RefSorted
    from repro_torch.core.sortedlist import SortedList

    keys = np.random.default_rng(seed).integers(0, max(1, n // 3), n)
    ref, port = RefSorted(), SortedList()
    ranks_r = [ref.insert(int(k)) for k in keys]
    ranks_p = [port.insert(int(k)) for k in keys]
    assert ranks_p == ranks_r and len(port) == len(ref) == n
    assert port.to_list() == ref.to_list() == sorted(int(k) for k in keys)
