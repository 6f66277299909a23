"""The port's models (``repro.models``): the decoder-only families and
the encoder-decoder (whisper)."""

from .convert import params_from_jax
from .encdec import EncDec, EncDecCache
from .model import (Model, build, count_params, decode_input_specs,
                    input_specs, model_flops, module_of)

__all__ = ["EncDec", "EncDecCache", "Model", "build", "count_params",
           "decode_input_specs", "input_specs", "model_flops", "module_of",
           "params_from_jax"]
