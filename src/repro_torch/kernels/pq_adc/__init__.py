from .ops import pq_adc
from .ref import pq_adc_ref

__all__ = ["pq_adc", "pq_adc_ref"]
