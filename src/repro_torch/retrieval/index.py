"""RetrievalIndex — embedder + factory spec, the paper's technique as a
first-class framework feature (the port of ``repro.retrieval.index``).

Ties the LM side to the ANN side: embeddings from any ported arch are
indexed by **any** ``repro_torch.api`` factory spec — IVF with compressed
ids (and optionally PQ codes), NSG/HNSW with compressed friend lists, or
a flat oracle.  This is the component a kNN-LM / RAG deployment mounts
next to the model server.  A CUDA index builds and scans with the port's
kernels (``l2_top1`` in k-means, ``l2_dist`` + ``seg_topk`` in the scan);
``device="cpu"`` runs their plain versions.  ``save``/``load`` persist it
as one RIDX artifact, the reference's bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..api import index_factory, load_index, save_index
from ..api.spec import IndexSpec
from ..configs.base import ModelConfig
from ..models import build

__all__ = ["RetrievalIndex", "embed_corpus"]

_EMBED_DIM = 64


def _projection(vocab: int) -> np.ndarray:
    """The reference's fixed (vocab, 64) projection: ``default_rng(0)``
    normals / 8, in f32."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((vocab, _EMBED_DIM)).astype(np.float32) / 8.0


def embed_corpus(cfg: ModelConfig, params, token_batches) -> np.ndarray:
    """Document embeddings: the mean over the sequence of the final logits
    (in the logits' dtype, accumulated in f32), projected to 64 dims by
    the reference's fixed matrix.  Runs on the parameters' device; each
    batch is projected there in f32, so only ``(batch, 64)`` reaches the
    host (the reference concatenates ``(N, vocab)`` on the host first)."""
    device = next(params.parameters()).device
    model = build(cfg, device=device)
    proj = None
    outs = []
    with torch.no_grad():
        for t in token_batches:
            tokens = torch.as_tensor(np.asarray(t), device=device)
            logits, _ = model.apply(params, tokens=tokens, remat=False)
            pooled = logits.float().mean(dim=1).to(logits.dtype).float()
            if proj is None:
                proj = torch.from_numpy(
                    _projection(pooled.shape[1])).to(device)
            outs.append((pooled @ proj).cpu().numpy())
    return np.concatenate(outs, axis=0)


@dataclasses.dataclass
class RetrievalIndex:
    """Thin composition: a factory ``spec`` string over corpus embeddings,
    on ``device`` (default ``"cuda"``, which raises where no CUDA device
    is present).

    The legacy constructor knobs (``nlist``/``id_codec``/``pq_m``/
    ``code_codec``) synthesize a spec when ``spec`` is not given.
    """

    nlist: int = 64
    id_codec: str = "roc"
    pq_m: int = 0
    code_codec: Optional[str] = None
    spec: Optional[str] = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.spec is None:
            self.spec = str(IndexSpec(
                kind="ivf", nlist=self.nlist, ids=self.id_codec,
                pq_m=self.pq_m, codes=self.code_codec))

    def build(self, embeddings: np.ndarray) -> "RetrievalIndex":
        self.index = index_factory(self.spec, device=self.device).build(
            embeddings)
        return self

    @property
    def ivf(self):
        """The underlying IVFIndex (IVF specs only)."""
        return self.index.ivf

    def search(self, queries: np.ndarray, topk: int = 10, **opts):
        """Returns ``(ids, dists, stats)`` (the reference's I/D order)."""
        dists, ids, stats = self.index.search(queries, k=topk, **opts)
        return ids, dists, stats

    def search_ref(self, queries: np.ndarray, nprobe: int = 8,
                   topk: int = 10):
        """Per-query oracle scan (see IVFIndex.search_ref; IVF specs only)."""
        return self.index.ivf.search_ref(queries, nprobe=nprobe, topk=topk)

    def stats(self) -> dict:
        led = self.index.memory_ledger()
        n = led["n"]
        out = {
            "n": n,
            "spec": self.index.spec,
            "compact_bits": float(np.ceil(np.log2(max(2, n)))),
            "memory_ledger": led,
        }
        inner = getattr(self.index, "ivf", None)
        if inner is not None:
            out["bits_per_id"] = inner.bits_per_id()
            out["code_bits_per_element"] = inner.code_bits_per_element()
            out["decoded_cache"] = inner.decoded_cache.stats()
        graph = getattr(self.index, "graph", None)
        if graph is not None:
            out["bits_per_edge"] = graph.bits_per_edge()
            out["decoded_cache"] = graph.decoded_cache.stats()
        return out

    # -- persistence (RIDX) ---------------------------------------------------
    def save(self, path=None) -> bytes:
        return save_index(self.index, path)

    @classmethod
    def load(cls, src, device="cuda") -> "RetrievalIndex":
        index = load_index(src, device=device)
        ri = cls(spec=index.spec, device=device)
        ri.index = index
        return ri
