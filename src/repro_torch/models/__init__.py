"""The port's models: the decoder-only families (``repro.models``)."""

from .convert import params_from_jax
from .model import Model, build, count_params, model_flops

__all__ = ["Model", "build", "count_params", "model_flops", "params_from_jax"]
