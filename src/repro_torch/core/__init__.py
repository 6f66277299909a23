"""repro_torch.core — the host-side numpy codecs of the port.

Copied from the reference package's ``core`` so the port stands alone
(same bytes, same rates; docstrings added where the reference had none;
the container's joint id stream is computed by halving, same bytes):

  ans          — exact BigANS + streaming rANS (Eq. 1-3)
  vrans        — vectorized interleaved-lane rANS
  roc          — Random Order Coding for id sets (bits-back, §3.2)
  gap_ans      — sorted-gap + lane-rANS set codec
  elias_fano   — EF baseline (§A.1)
  wavelet_tree — WT / WT1 full-random-access structure (§3.3, §4.1)
  rec          — Random Edge Coding for whole graphs (§4.3)
  polya        — adaptive PQ-code coding conditioned on clusters (Eq. 6-7)
  webgraph_lite— Zuckerli baseline stand-in (§A.2)
  sortedlist   — blocked sorted list (the REC decoder's rank-insert)
  container    — manifest-of-sections framing and the v1 RIVF blob
  codecs       — the pluggable registry the index layer consumes
  epoch        — epoched id storage for O(Δ) ingest
"""

from .ans import BigANS, StreamANS
from .codecs import CODEC_NAMES, get_codec
from .elias_fano import EliasFano
from .epoch import EpochStore
from .fenwick import Fenwick
from .gap_ans import decode_gaps, encode_gaps
from .polya import PolyaCodec, polya_decode_clusters, polya_encode_clusters
from .rec import rec_decode, rec_encode
from .roc import (
    roc_decode_clusters,
    roc_encode_clusters,
    roc_pop_set,
    roc_push_set,
    set_information_bits,
)
from .vrans import VRansDecoder, VRansEncoder, vrans_size_bits
from .wavelet_tree import WaveletTree

__all__ = [
    "BigANS", "StreamANS", "CODEC_NAMES", "get_codec", "EliasFano",
    "EpochStore", "Fenwick", "encode_gaps", "decode_gaps", "PolyaCodec",
    "polya_encode_clusters", "polya_decode_clusters", "rec_encode",
    "rec_decode", "roc_push_set", "roc_pop_set", "roc_encode_clusters",
    "roc_decode_clusters", "set_information_bits", "VRansEncoder",
    "VRansDecoder", "vrans_size_bits", "WaveletTree",
]
