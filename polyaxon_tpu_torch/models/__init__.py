"""Models of the port (counterpart of ``polyaxon_tpu.models``)."""

from polyaxon_tpu_torch.models import decode
from polyaxon_tpu_torch.models.transformer import TransformerConfig, forward, init_params
from polyaxon_tpu_torch.models.weights import params_from_jax

__all__ = ["TransformerConfig", "decode", "forward", "init_params", "params_from_jax"]
