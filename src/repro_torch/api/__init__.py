"""repro_torch.api — the unified index layer of the port.

One :class:`Index` protocol and faiss-style factory strings (the grammar
of ``repro.api.spec``, canonical strings identical)::

    from repro_torch.api import index_factory

    idx = index_factory("IVF1024,PQ8x8,ids=roc,codes=polya").build(x)
    dists, ids, stats = idx.search(queries, k=10)

IVF specs are ported; Flat, NSG and HNSW specs raise
``NotImplementedError``.
"""

from .indexes import IVFApiIndex, as_api_index, make_index
from .protocol import Index
from .spec import IndexSpec, parse_spec

__all__ = ["Index", "IndexSpec", "parse_spec", "index_factory",
           "as_api_index", "IVFApiIndex"]


def index_factory(spec, device="cuda") -> Index:
    """Factory-string (or :class:`IndexSpec`) -> empty index on ``device``;
    ``.build(x)`` it.  ``device="cuda"`` (the default) raises when no CUDA
    device is present; pass ``device="cpu"`` for the plain torch path.

    >>> index_factory("IVF64,ids=roc", device="cpu").spec
    'IVF64,ids=roc'
    """
    return make_index(spec, device=device)
