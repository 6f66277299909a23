"""repro_torch.api — the unified index layer of the port.

One :class:`Index` protocol, faiss-style factory strings (the grammar of
``repro.api.spec``, canonical strings identical) and lossless save/load
in the reference's RIDX container::

    from repro_torch.api import index_factory, load_index, save_index

    idx = index_factory("IVF1024,PQ8x8,ids=roc,codes=polya").build(x)
    dists, ids, stats = idx.search(queries, k=10)
    blob = save_index(idx)                 # RIDX v3, the reference's bytes
    idx2 = load_index(blob, device="cuda") # bit-identical search results

Every spec of the grammar builds: Flat, IVF (with PQ / Pólya codes) and
the NSG / HNSW graphs.
"""

from .container import load_index, pack_index, save_index, unpack_index
from .indexes import (FlatIndex, GraphApiIndex, IVFApiIndex, as_api_index,
                      make_index)
from .protocol import Index
from .spec import IndexSpec, parse_spec

__all__ = ["Index", "IndexSpec", "parse_spec", "index_factory",
           "as_api_index", "FlatIndex", "IVFApiIndex", "GraphApiIndex",
           "pack_index",
           "unpack_index", "save_index", "load_index"]


def index_factory(spec, device="cuda") -> Index:
    """Factory-string (or :class:`IndexSpec`) -> empty index on ``device``;
    ``.build(x)`` it.  ``device="cuda"`` (the default) raises when no CUDA
    device is present; pass ``device="cpu"`` for the plain torch path.

    >>> index_factory("IVF64,ids=roc", device="cpu").spec
    'IVF64,ids=roc'
    """
    return make_index(spec, device=device)
