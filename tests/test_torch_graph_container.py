"""The RIDX graph sections of the port (``repro_torch.api.container``)
against the reference's, on the CPU.

NSG and HNSW indexes of both packages are built over the same data and
the same adjacency (the reference's data shape, n = 800, d = 24, with
duplicate rows).  For webgraph-lite and REC edges, before and after
``add`` (per-node universes mid-ingest), and with an ``id_map``:

* the port's ``pack_index`` bytes equal the reference's;
* the port loads the reference's blob and the reference loads the
  port's: adjacency, universes, blobs, ``id_bits`` and epochs equal, and
  search after reload equals search before, ids and dists;
* a v2 graph blob (no universes section) loads, and is rewritten as v3;
* files work, spec options survive, and a CUDA load without a card
  raises.
"""

import numpy as np
import pytest
import torch

import jax

from _torch_blobs import canon
from repro.ann.graph import build_hnsw, build_nsg
from repro.api import index_factory as ref_factory
from repro.api import load_index as ref_load
from repro.api import save_index as ref_save
from repro_torch.api import index_factory, load_index, save_index
from repro_torch.api.container import pack_index, unpack_index

jax.config.update("jax_platforms", "cpu")

GRAPH_CODECS = ["webgraph", "rec"]


def _data(n=800, d=24, nq=17, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    base[50] = base[51]
    base[52] = base[51]
    queries = rng.standard_normal((nq, d)).astype(np.float32)
    extra = rng.standard_normal((60, d)).astype(np.float32)
    return base, queries, extra


BASE, QUERIES, EXTRA = _data()
_ADJ = {}


def _adj(kind):
    if kind not in _ADJ:
        _ADJ[kind] = (build_nsg(BASE, 12) if kind == "nsg"
                      else build_hnsw(BASE, 8))
    return _ADJ[kind]


def both(spec, kind, grown=False):
    """(reference, port) api indexes over the same adjacency; ``grown``
    adds two batches to each (three encoding universes)."""
    ref = ref_factory(spec).build(BASE, adj=list(_adj(kind)))
    port = index_factory(spec, device="cpu").build(BASE, adj=list(_adj(kind)))
    if grown:
        for chunk in (EXTRA[:25], EXTRA[25:]):
            ref.add(chunk)
            port.add(chunk)
    return ref, port


def _search(idx, **opts):
    return idx.search(QUERIES, k=10, ef=24, **opts)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def _assert_same_graph(a, b):
    assert a.n == b.n and a.entry == b.entry
    np.testing.assert_array_equal(a.x, b.x)
    for p, q in zip(a.adj_raw, b.adj_raw):
        np.testing.assert_array_equal(p, q)
    np.testing.assert_array_equal(a._universes, b._universes)
    assert canon(a._blobs) == canon(b._blobs)
    assert a.id_bits() == b.id_bits() and a.n_epochs == b.n_epochs


@pytest.mark.parametrize("grown", [False, True])
@pytest.mark.parametrize("graph_codec", GRAPH_CODECS)
@pytest.mark.parametrize("kind,spec", [("nsg", "NSG12,ids=roc"),
                                       ("hnsw", "HNSW8,ids=ef")])
def test_graph_blob_bytes_and_both_directions(kind, spec, graph_codec, grown):
    ref, port = both(spec, kind, grown)
    blob = ref_save(ref, graph_codec=graph_codec)
    assert save_index(port, graph_codec=graph_codec) == blob
    want = _search(ref)
    got = load_index(blob, device="cpu")
    assert got.spec == spec and got.device == torch.device("cpu")
    _assert_same_graph(got.graph, ref.graph)
    _assert_same(_search(got), want)
    _assert_same(_search(got, kernel_min=1, select="device"), want)
    back = ref_load(pack_index(got, graph_codec=graph_codec))
    _assert_same_graph(back.graph, ref.graph)
    _assert_same(_search(back), want)
    assert pack_index(got, graph_codec=graph_codec) == blob


@pytest.mark.parametrize("graph_codec", GRAPH_CODECS)
def test_graph_id_map_round_trip(graph_codec):
    ref, port = both("NSG12,ids=gap_ans", "nsg")
    for idx in (ref, port):
        idx.graph.id_map = np.arange(0, 3 * len(BASE), 3, dtype=np.int64)
    blob = ref_save(ref, graph_codec=graph_codec)
    assert save_index(port, graph_codec=graph_codec) == blob
    got = load_index(blob, device="cpu")
    np.testing.assert_array_equal(got.graph.id_map, ref.graph.id_map)
    _assert_same(_search(got), _search(ref))


def _v2_blob(ref):
    """A v2 graph blob (no universes section) written with the reference's
    own section framing and webgraph coder."""
    from repro.api.spec import parse_spec
    from repro.core.container import SectionWriter
    from repro.core.webgraph_lite import webgraph_encode

    g = ref.graph
    meta = {"spec": str(parse_spec(ref.spec)), "kind": "nsg", "n": int(g.n),
            "d": int(g.x.shape[1]), "entry": int(g.entry),
            "graph_codec": "webgraph"}
    w = SectionWriter()
    w.add("vecs", g.x.astype(np.float32).tobytes())
    head, tail = webgraph_encode(g.adj_raw, g.n).tobytes()
    w.add("graph_head", head)
    w.add("graph_tail", tail)
    return w.finish(b"RIDX", 2, meta)


def test_v2_graph_blob_loads():
    ref, _ = both("NSG12,ids=roc", "nsg")
    blob = _v2_blob(ref)
    want = _search(ref)
    _assert_same(_search(ref_load(blob)), want)
    got = unpack_index(blob, device="cpu")
    _assert_same_graph(got.graph, ref.graph)
    _assert_same(_search(got), want)
    assert save_index(got) == ref_save(ref)        # rewritten as v3


def test_graph_file_options_and_device(tmp_path):
    ref, port = both("HNSW8,ids=compact,cache_mb=2,cache_policy=2q", "hnsw")
    p = tmp_path / "graph.ridx"
    save_index(port, p, graph_codec="rec")
    got = load_index(p, device="cpu")
    assert got.spec == ref.spec
    assert got.graph.decoded_cache.max_bytes == 2 << 20
    assert got.graph.decoded_cache.policy == "2q"
    _assert_same(_search(got), _search(ref))
    with pytest.raises(ValueError, match="graph_codec"):
        save_index(port, graph_codec="zuckerli")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_index(p)
