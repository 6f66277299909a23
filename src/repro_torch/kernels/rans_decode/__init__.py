"""Interleaved-lane 32/16 rANS decode with a static pmf.

``make_tables`` turns a quantized pmf into the decoder's slot tables;
``rans_decode`` decodes ``rows`` symbols on each of ``L`` lanes in
lockstep, bit-exactly equal to the plain step loop ``rans_decode_ref``.
The encoder is :class:`repro_torch.core.vrans.VRans16Encoder`.
"""

from .ops import make_tables, rans_decode
from .ref import rans_decode_ref

__all__ = ["rans_decode", "rans_decode_ref", "make_tables"]
