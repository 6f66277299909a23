"""The port's retrieval side-car against the reference (CPU).

``RetrievalIndex`` over the same numpy data in both packages, for three
specs (``IVF64,ids=roc`` over 20,000 deep-like vectors, the serving
loop's side-car; ``IVF32,PQ8x8,ids=gap_ans,codes=polya`` over 20,000
sift-like; ``NSG8,ids=ef`` over 400 deep-like): ids and dists
``np.array_equal``, ``stats()``'s bits equal, ``save()`` bytes equal, and
each package's blob loads in the other with equal results.  Then
``embed_corpus`` on reduced gemma3-1b with the reference's weights
(tolerance: ``atol = 1e-4 * max(1, max|x|)``, rtol 1e-4, as for the
logits it pools; the port projects each batch with the same matrix where
the reference projects the concatenation), and the reference's own cases
of ``tests/test_serve_retrieval.py`` on the port, self-retrieval rate
included.
"""

import jax
import numpy as np
import pytest

import repro.configs as RC
from repro.data.synthetic import make_dataset
from repro.models import transformer as RT
from repro.retrieval.index import RetrievalIndex as RefRI
from repro.retrieval.index import embed_corpus as ref_embed_corpus
import repro_torch.configs as PC
from repro_torch.models import params_from_jax
from repro_torch.retrieval import RetrievalIndex, embed_corpus

jax.config.update("jax_platforms", "cpu")

SPECS = {
    "ivf-roc": dict(kw=dict(nlist=64, id_codec="roc"), data="deep-like",
                    n=20_000, opts=dict(nprobe=8)),
    "ivf-pq": dict(kw=dict(nlist=32, id_codec="gap_ans", pq_m=8,
                           code_codec="polya"),
                   data="sift-like", n=20_000, opts=dict(nprobe=8)),
    "nsg": dict(kw=dict(spec="NSG8,ids=ef"), data="deep-like", n=400,
                opts=dict(ef=16)),
}


class Pair:
    def __init__(self, name):
        s = SPECS[name]
        base, queries = make_dataset(s["data"], max(s["n"], 3000), 64, seed=0)
        self.base, self.queries = base[:s["n"]], queries
        self.opts = s["opts"]
        self.ref = RefRI(**s["kw"]).build(self.base)
        self.port = RetrievalIndex(**s["kw"], device="cpu").build(self.base)


@pytest.fixture(scope="module", params=list(SPECS))
def pair(request):
    return Pair(request.param)


def _equal(a, b):
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_spec_equals_the_reference(pair):
    assert pair.port.spec == pair.ref.spec == pair.port.index.spec


def test_search_equals_the_reference(pair):
    for topk in (1, 5, 10):
        got = pair.port.search(pair.queries, topk=topk, **pair.opts)
        want = pair.ref.search(pair.queries, topk=topk, **pair.opts)
        _equal(got, want)
    # the base rows themselves
    _equal(pair.port.search(pair.base[:32], topk=5, **pair.opts),
           pair.ref.search(pair.base[:32], topk=5, **pair.opts))


@pytest.mark.parametrize("pair", ["ivf-roc", "ivf-pq"], indirect=True)
def test_search_ref_equals_the_reference(pair):
    """``search_ref`` is the IVF oracle."""
    got = pair.port.search_ref(pair.queries, nprobe=8, topk=5)
    want = pair.ref.search_ref(pair.queries, nprobe=8, topk=5)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    ids, dists, _ = pair.port.search(pair.queries, topk=5, nprobe=8)
    assert np.array_equal(ids, got[0]) and np.array_equal(dists, got[1])


def test_stats_bits_equal_the_reference(pair):
    got, want = pair.port.stats(), pair.ref.stats()
    for key in ("n", "spec", "compact_bits", "bits_per_id",
                "code_bits_per_element", "bits_per_edge"):
        assert got.get(key) == want.get(key), key
    assert got["memory_ledger"] == want["memory_ledger"]


def test_save_bytes_equal_and_blobs_load_both_ways(pair, tmp_path):
    blob = pair.port.save()
    assert blob == pair.ref.save()
    path = tmp_path / "side-car.ridx"
    assert pair.port.save(path) == blob and path.read_bytes() == blob
    want = pair.ref.search(pair.queries, topk=5, **pair.opts)
    _equal(RetrievalIndex.load(pair.ref.save(), device="cpu").search(
        pair.queries, topk=5, **pair.opts), want)
    _equal(RetrievalIndex.load(path, device="cpu").search(
        pair.queries, topk=5, **pair.opts), want)
    _equal(RefRI.load(blob).search(pair.queries, topk=5, **pair.opts), want)


def test_embed_corpus_equals_the_reference():
    ref_cfg = RC.reduced(RC.get_config("gemma3-1b"))
    cfg = PC.reduced(PC.get_config("gemma3-1b"))
    ref_params = RT.init_decoder(jax.random.PRNGKey(0), ref_cfg)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
               for _ in range(3)]
    want = ref_embed_corpus(ref_cfg, ref_params, batches)
    got = embed_corpus(cfg, params, batches)
    assert got.shape == want.shape == (12, 64) and got.dtype == np.float32
    atol = 1e-4 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol)


# -- the reference's own cases (tests/test_serve_retrieval.py) on the port --

def test_retrieval_index_end_to_end():
    base, _ = make_dataset("deep-like", 20_000, 64, seed=0)
    ri = RetrievalIndex(nlist=64, id_codec="roc", device="cpu").build(base)
    stats = ri.stats()
    assert stats["bits_per_id"] < stats["compact_bits"] - 2
    ids, _, _ = ri.search(base[:32], nprobe=8, topk=5)
    # self-retrieval: the query vector itself must come back first
    assert np.mean(ids[:, 0] == np.arange(32)) > 0.9


def test_retrieval_index_with_pq_codes():
    base, _ = make_dataset("sift-like", 20_000, 16, seed=0)
    ri = RetrievalIndex(nlist=32, id_codec="gap_ans", pq_m=8,
                        code_codec="polya", device="cpu").build(base)
    assert ri.stats()["code_bits_per_element"] <= 8.2
    ids, _, _ = ri.search(base[:8], nprobe=8, topk=3)
    assert ids.shape == (8, 3)


def test_retrieval_index_is_spec_thin():
    base, queries = make_dataset("deep-like", 3_000, 16, seed=0)
    ri = RetrievalIndex(spec="IVF32,PQ8x8,ids=roc,codes=polya",
                        device="cpu").build(base)
    assert ri.index.spec == "IVF32,PQ8x8,ids=roc,codes=polya"
    ids0, d0, _ = ri.search(queries, topk=5, nprobe=8)
    ri2 = RetrievalIndex.load(ri.save(), device="cpu")
    ids1, d1, _ = ri2.search(queries, topk=5, nprobe=8)
    assert np.array_equal(ids0, ids1) and np.array_equal(d0, d1)
    rg = RetrievalIndex(spec="NSG8,ids=ef", device="cpu").build(base[:400])
    gids, _, gst = rg.search(queries, topk=5, ef=16)
    assert gids.shape == (16, 5) and gst.visited > 0
    assert rg.stats()["bits_per_edge"] > 0
