"""The retrieval side-car of the port (``repro.retrieval``)."""

from .index import RetrievalIndex, embed_corpus

__all__ = ["RetrievalIndex", "embed_corpus"]
