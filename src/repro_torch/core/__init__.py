# Host-side numpy codecs, copied from the reference package's ``core`` so
# the port stands alone (same bytes, same rates):
#
#   ans          — exact BigANS + streaming rANS (Eq. 1-3)
#   vrans        — vectorized interleaved-lane rANS
#   roc          — Random Order Coding for id sets (bits-back, §3.2)
#   gap_ans      — sorted-gap + lane-rANS set codec
#   elias_fano   — EF baseline (§A.1)
#   wavelet_tree — WT / WT1 full-random-access structure (§3.3, §4.1)
#   polya        — adaptive PQ-code coding conditioned on clusters (Eq. 6-7)
#   codecs       — the pluggable registry the index layer consumes
#   epoch        — epoched id storage for O(Δ) ingest

from .ans import BigANS, StreamANS
from .codecs import CODEC_NAMES, get_codec
from .elias_fano import EliasFano
from .epoch import EpochStore
from .fenwick import Fenwick
from .gap_ans import decode_gaps, encode_gaps
from .polya import PolyaCodec, polya_decode_clusters, polya_encode_clusters
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
    "polya_encode_clusters", "polya_decode_clusters", "roc_push_set",
    "roc_pop_set", "roc_encode_clusters", "roc_decode_clusters",
    "set_information_bits", "VRansEncoder", "VRansDecoder",
    "vrans_size_bits", "WaveletTree",
]
